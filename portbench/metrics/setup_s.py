"""Seconds from the process's start to the window's first step: the
kernels' build (the first run of a checkout), the process group, the
model and its seeded weights, the data, the check's first steps and the
steps that time the window."""


def read(ctx):
    return ctx.setup_s
