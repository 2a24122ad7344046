"""A run with the timed path broken underneath comes out not correct.

The harness runs on the CPU (the look for a card skipped) at the tiny
cells' size, each fault planted in the program (``portbench/faults.py``):
a step that leaves the state as it was, half of each batch left out, the
exchange between ranks left out, the loss altered where it is produced.
A sound run of the same cells comes out correct.
"""

import pytest

from portbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("name", ["resnet-tiny", "gpt-tiny"])
def test_sound_run_is_correct(cpu_run, name):
    records, result = cpu_run(tiny_cell(name))
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 3
    assert set(result["metrics"]) >= {"step_ms_p90", "setup_s"}


@pytest.mark.parametrize("name", ["resnet-tiny", "gpt-tiny"])
@pytest.mark.parametrize("fault", ["frozen", "half_batch", "loss_altered"])
def test_fault_is_caught(cpu_run, name, fault):
    _, result = cpu_run(tiny_cell(name), fault=fault)
    assert not result["correct"], (fault, result["check"])


def test_exchange_left_out_is_caught(cpu_run):
    cell = tiny_cell("gpt-tiny", ranks=2)
    records, sound = cpu_run(cell)
    assert sound["correct"], sound["check"]
    assert len(records) == 2 and sound["device"]["count"] == 2
    _, result = cpu_run(cell, fault="no_exchange")
    assert not result["correct"], result["check"]
