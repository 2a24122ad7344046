"""Shared pieces of the benchmark's own tests (CPU unless marked
``gpu``)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = Path(__file__).resolve().parent / "cells"


def tiny_cell(name, ranks=1):
    """A cell at a size the CPU runs in seconds (``cells/<name>.json``)."""
    from portbench.cell import Cell
    spec = json.loads((CELLS / f"{name}.json").read_text())
    spec["traffic"]["ranks"] = ranks
    return Cell(name=name, chips=ranks, config=spec["config"],
                traffic=spec["traffic"], limits=spec["limits"],
                end_to_end=[("images_per_s", "images/s"),
                            ("tokens_per_s", "tokens/s"),
                            ("step_ms_p90", "ms"), ("setup_s", "s")],
                per_layer=[])


@pytest.fixture
def cpu_run(monkeypatch):
    """``run(cell, seed, fault=None) -> (records, result)``: the harness
    on the CPU, the look for a card skipped, one worker process per rank
    for several."""
    from portbench import run as runner
    monkeypatch.setenv("OMP_NUM_THREADS", "2")

    def go(cell, seed=2**31 + 7, fault=None, seconds=0.2):
        records = runner.run(cell, seed, seconds, False, device="cpu",
                             fault=fault)
        return records, runner.assemble(cell, records, False, 0.0, "cpu")
    return go
