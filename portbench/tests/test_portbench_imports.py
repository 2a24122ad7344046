"""What a run loads and what the benchmark's file may say.

* A dry run of the harness on the CPU loads no module whose top-level
  name is ``jax``, ``jaxlib``, ``flax`` or the JAX package's, compared as
  whole names (the port's own name begins with the JAX package's).
* No file of ``portbench/reference/`` imports the program.
* Every name, unit and text of ``BENCHMARK.json`` keeps to its
  characters, and every file it names is there.
"""

import ast
import json
import re
import subprocess
import sys

from portbench import run as runner
from portbench.cell import HERE, ROOT, load, metrics_for

FORBIDDEN = {"jax", "jaxlib", "flax", "chainermn_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_forbidden_names_are_whole_names():
    before = dict(sys.modules)
    try:
        sys.modules["chainermn_tpu_torch_probe"] = object()
        sys.modules["jaxish"] = object()
        assert runner.forbidden_modules() == sorted(
            FORBIDDEN & {n.split(".")[0] for n in before})
        sys.modules["jaxlib.probe"] = object()
        assert "jaxlib" in runner.forbidden_modules()
    finally:
        for name in ("chainermn_tpu_torch_probe", "jaxish", "jaxlib.probe"):
            if name not in before:
                sys.modules.pop(name, None)


def test_dry_run_loads_no_jax():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from portbench import run as runner
from portbench.tests.conftest import tiny_cell
cell = tiny_cell("gpt-tiny")
records = runner.run(cell, 2**32 + 1, 0.1, False, device="cpu")
result = runner.assemble(cell, records, False, 0.0, "cpu")
print(json.dumps({{"found": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "correct": result["correct"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["correct"]
    assert "chainermn_tpu_torch" in seen["found"]
    assert not FORBIDDEN & set(seen["found"])


def test_reference_sources_import_no_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN | {"chainermn_tpu_torch",
                                               "portbench"}, (path, name)


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_file_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in spec["paths"])
    assert all(_text_ok(w) for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) \
        and 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text_ok(c["source"]) \
            and _text_ok(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg.get("published", {}))
        names.add(c["name"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _text_ok(w["why"])
        assert (HERE / "workloads" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
        cells.add(w["name"])
        load(w["name"])
    assert len({(w["config"], w["traffic"])
                for w in spec["workloads"]}) == len(spec["workloads"])
    metrics = set()
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            keys = {"name", "unit", "better", "source"}
            keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == keys, m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", [])) <= cells
            assert (HERE / "metrics" / f"{m['name']}.py").exists()
            assert m["name"] not in metrics
            metrics.add(m["name"])
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert _text_ok(m["layer"])
    moves = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in moves
    for cell in cells:
        e2e, layers = metrics_for(spec, cell)
        assert "setup_s" in dict(e2e) and len(e2e) >= 2 and layers
