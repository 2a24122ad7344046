"""A cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric sits in a file of its own, found by name:

* ``configs/<config>.json``: the configuration's sizes; its ``family``
  names the adapter ``families/<family>.py`` and the plain reference
  ``reference/<family>.py`` beside it;
* ``workloads/<traffic>.json``: the traffic's parameters (``data.py``);
* ``limits/<workload>.json``: the limits of the cell's compared numbers;
* ``metrics/<metric>.py``: the reader of one metric (``read(ctx)``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["Cell", "load", "load_metric", "metrics_for", "HERE", "ROOT"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: ``(name, unit)`` of the end-to-end metrics, then of the per-layer
    #: ones, that this cell reports
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def family(self):
        return importlib.import_module(
            f"portbench.families.{self.config['family']}")


def _read(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _read(Path(root) / "BENCHMARK.json")


def metrics_for(spec, workload):
    """``(end_to_end, per_layer)``: the ``(name, unit)`` of each metric
    that cell ``workload`` reports."""
    def pick(entries):
        return [(m["name"], m["unit"]) for m in entries
                if workload in m.get("workloads", [workload])]
    return pick(spec["end_to_end"]), pick(spec["per_layer"])


def load(workload, root=ROOT):
    """The cell named ``workload`` in ``root``'s ``BENCHMARK.json``."""
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    traffic = _read(HERE / "workloads" / f"{entry['traffic']}.json")
    if traffic["ranks"] != entry["chips"]:
        raise SystemExit(f"{workload}: the traffic runs on "
                         f"{traffic['ranks']} ranks, the cell asks "
                         f"{entry['chips']} chips")
    e2e, layers = metrics_for(spec, workload)
    return Cell(name=workload, chips=entry["chips"],
                config=_read(HERE / "configs" / f"{entry['config']}.json"),
                traffic=traffic,
                limits=_read(HERE / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=layers)


def load_metric(name):
    """The ``read(ctx)`` of ``metrics/<name>.py`` (a name may hold dots,
    so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
