"""The plain reference against the port's own step, on the CPU at a tiny
width: the same seeded weights and batches, the benchmark's readings of
the first steps, every number within the tiny cells' limits (both sides
float32 here; the cells on the card set theirs from their readings)."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("name", ["resnet-tiny", "gpt-tiny"])
def test_reference_follows_the_ports_step(name):
    cell = tiny_cell(name)
    rows = harness.calibrate_rank(cell, [2**33 + 5], "cpu", 0, 1)
    (row,) = rows
    assert row["correct"], row["check"]
    ref = row["readings"]["reference"]
    # the readings cover every leaf and the losses are those of a model
    # that learns nothing yet
    assert set(ref["grad1"]) == set(row["readings"]["program"]["grad1"])
    assert all(l > 0 for l in ref["loss"])


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, %r); "
            "import portbench.reference, portbench.reference.resnet, "
            "portbench.reference.gpt, portbench.reference.optim, "
            "portbench.reference.quant; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    top = json.loads(out)
    assert "chainermn_tpu_torch" not in top
    assert not {"jax", "jaxlib", "flax", "chainermn_tpu"} & set(top)
