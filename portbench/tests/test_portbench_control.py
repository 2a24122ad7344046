"""The control: the plain reference put in the program's place and
computed in float8, the precision below the configurations' bf16, must
come out not correct.

On the CPU at the tiny cells' size against their limits; on the card
(``gpu``) at each cell's own size against its limits, on three seeds
(``python -m pytest -m gpu portbench/tests`` there)."""

import pytest
import torch

from portbench import harness
from portbench.cell import benchmark, load
from portbench.tests.conftest import tiny_cell

SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.parametrize("name", ["resnet-tiny", "gpt-tiny"])
def test_control_fails_at_tiny_size(name):
    rows = harness.calibrate_rank(tiny_cell(name), SEEDS[:1], "cpu", 0, 1,
                                  mode="float8_e4m3")
    assert not rows[0]["correct"], rows[0]["check"]


def _cells():
    return [w["name"] for w in benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", _cells())
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's size runs on the card")
    rows = harness.calibrate_rank(load(workload), SEEDS, "cuda", 0, 1,
                                  mode="float8_e4m3")
    assert not any(r["correct"] for r in rows), [r["check"] for r in rows]
