#!/usr/bin/env python3
"""The end-to-end phases of ``chip_smoke.py`` from two checkouts, in turns,
on one card.

    python3 tools/chip_e2e_compare.py --parent PATH [--rounds N]

``PATH`` is another checkout of the repository (e.g. the parent commit,
unpacked with ``git archive <commit> | tar -x -C build/parent``).  Each
round runs the parent, this checkout, this checkout and the parent, each
in a process of its own that builds its own kernels and runs
``chip_smoke``'s ``serving``, ``train``, ``train_dp`` and
``train_resnet`` phases from its own tree.  Prints one JSON line per run
(tokens/s of serving, median step ms of the three training phases,
images/s) and last a summary: per metric, each side's readings and
medians.  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

#: (phase, field) pairs read from each run
METRICS = [("serving", "tokens_per_s"), ("train", "median_step_ms"),
           ("train_dp", "median_step_ms"),
           ("train_resnet", "median_step_ms"),
           ("train_resnet", "images_per_s")]


def child(tree):
    """Run the phases from ``tree`` (this process's working directory)."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from chainermn_tpu_torch._build import load_library
    from chainermn_tpu_torch.models import TransformerLM
    if not torch.cuda.is_available():
        raise SystemExit("chip_e2e_compare: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library()
    model = TransformerLM(compute_dtype=torch.bfloat16, device="cuda",
                          **cs.MODEL)
    cs.phase_serving(model)
    del model
    torch.cuda.empty_cache()
    cs.phase_train()
    cs.phase_train_dp()
    torch.cuda.empty_cache()
    cs.phase_train_resnet()


def run(tree, label, log_dir):
    """One child run from ``tree``: its metrics, read from the JSON lines
    it printed (its whole output goes to ``log_dir``)."""
    tree = os.path.abspath(tree)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree],
        cwd=tree, capture_output=True, text=True, check=False)
    with open(os.path.join(log_dir, f"e2e_{label}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode:
        raise SystemExit(f"chip_e2e_compare: run {label} failed "
                         f"({proc.returncode}): {proc.stderr[-2000:]}")
    rows = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            rows.setdefault(row.get("phase"), row)
    out = {"run": label, "tree": tree}
    for phase, field in METRICS:
        out[f"{phase}.{field}"] = rows[phase][field]
    print(json.dumps(out), flush=True)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--child")
    args = parser.parse_args()
    if args.child:
        child(args.child)
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log_dir = os.path.join(here, "chiprun_out")
    os.makedirs(log_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"parent": [], "change": []}
    for r in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            tree = args.parent if side == "parent" else here
            runs[side].append(run(tree, f"{side}{len(runs[side])}_r{r}",
                                  log_dir))
    summary = {}
    for phase, field in METRICS:
        key = f"{phase}.{field}"
        summary[key] = {side: sorted(x[key] for x in xs)
                        for side, xs in runs.items()}
    print(json.dumps({"summary": summary, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
