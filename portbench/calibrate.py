#!/usr/bin/env python3
"""The readings a cell's limits are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --mode program|frozen|half_batch|no_exchange|float8_e4m3|bfloat16 \\
        [--out FILE]

``program``: the check's numbers of the program on each seed (the lower
reading is their largest), through the benchmark's own set-up and first
steps, one process per card and one set-up of the process group for all
seeds; a fault of ``portbench/faults.py`` (``frozen``, ``half_batch``,
``no_exchange``) runs the same with that fault planted in the program.
A precision (``float8_e4m3``, the one below the configuration's bf16,
or ``bfloat16``, a witness) puts the plain reference in the program's
place, computed in it: the control; it runs on one card whatever the
cell's, the reference following every rank's shard.
``--set`` changes a key of the configuration for a witness run (the
program in float32, say).  Prints one line per seed and a last line with
each number's smallest and largest reading; ``--out`` also writes the rows
with their readings.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run as runner  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--mode", default="program")
    p.add_argument("--out")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=JSON",
                   help="change a key of the configuration (a witness, "
                        "not the cell: say compute_dtype=\"float32\", "
                        "which also turns TF32 off)")
    args = p.parse_args(argv)
    runner.set_environment(False)
    from portbench.cell import load
    cell = load(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        cell.config[key] = json.loads(value)
    import torch
    if cell.config["compute_dtype"] == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from portbench.reference.quant import PRECISIONS
    program = args.mode not in PRECISIONS
    if not torch.cuda.is_available() or (
            program and torch.cuda.device_count() < cell.chips):
        print("no card for this cell", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    if program and cell.chips > 1:
        rows = runner.launch(cell, {"seeds": seeds, "mode": args.mode,
                                    "device": "cuda"})[0]
    else:
        from portbench.harness import calibrate_rank
        rows = calibrate_rank(cell, seeds, "cuda", 0, 1, args.mode)
    for row in rows:
        print(json.dumps({"workload": cell.name, "mode": args.mode,
                          "seed": row["seed"], "correct": row["correct"],
                          **row["numbers"]}), flush=True)
    print(json.dumps({"workload": cell.name, "mode": args.mode,
                      "seeds": len(rows), **{
                          k: [min(r["numbers"][k] for r in rows),
                              max(r["numbers"][k] for r in rows)]
                          for k in rows[0]["numbers"]}}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps({"workload": cell.name,
                                    "mode": args.mode, "set": args.set,
                                    **row}) + "\n")
    if runner.forbidden_modules():
        print(f"loaded {runner.forbidden_modules()}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
