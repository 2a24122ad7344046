"""The 90th percentile of the window's steps on rank 0, each from one
step-end CUDA event to the next (the first from the window's start)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.step_ms, 90)) if ctx.step_ms else None
