"""Host ms a step that the update spent pulling its batch: the port's
``train/input_stall`` span around the iterator's ``next()``."""


def read(ctx):
    spans = ctx.spans.get("train/input_stall")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
