"""Training tokens the job's ranks completed in the window, over the
window."""


def read(ctx):
    return ctx.items_per_s if ctx.family.ITEM == "tokens" else None
