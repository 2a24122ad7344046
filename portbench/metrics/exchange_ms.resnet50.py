"""Device ms a step of the NCCL kernels: the gradient allreduce, the
batch-norm statistics' and the loss's means.  A collective's kernel runs
from its launch on this rank until every rank has joined, so the reading
is the exchange plus this rank's wait for the slowest one."""

from portbench.readers import class_ms

PATTERNS = (r"nccl",)


def read(ctx):
    return class_ms(ctx, PATTERNS)
