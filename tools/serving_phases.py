#!/usr/bin/env python3
"""The serving engine's disaggregated and tensor-parallel phases and the
serving fleet's of ``chip_smoke.py`` alone, on one CUDA card: phase 3's
chat load, phase 44's chunked load, phases 48-50 (``serving_disagg``,
``serving_disagg_chunked`` with ``disagg_chunk_parity``, ``serving_tp``)
and 51-52 (``serving_fleet`` with ``serving_fleet_join``,
``serving_capacity``) against them, and phase 3's load once more, so that
the spread of its tokens/s in the same call can be read beside theirs.

    python3 tools/serving_phases.py

Prints the card's name and power limit, the Python, PyTorch and CUDA
versions and the kernels' build seconds, then ``chip_smoke.py``'s JSON
rows.  A failed gate exits non-zero, as in ``chip_smoke.py``.  Needs a
card.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("serving_phases: no CUDA device", file=sys.stderr)
        return 2
    from chainermn_tpu_torch._build import load_library
    from chainermn_tpu_torch.models import TransformerLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    load_library()
    print("build_s", time.perf_counter() - t0, flush=True)
    model = TransformerLM(compute_dtype=torch.bfloat16, device="cuda",
                          **cs.MODEL)
    launches, streams = cs.phase_serving(model)
    chunked_row, chunked_streams = cs.phase_serving_chunked(model, streams)
    cs.phases_a13b(model, streams, launches, chunked_row, chunked_streams)
    cs.phases_a13c(model, streams, launches)
    cs.run_serving_load("serving_again", model, streams)
    return 0


if __name__ == "__main__":
    sys.exit(main())
