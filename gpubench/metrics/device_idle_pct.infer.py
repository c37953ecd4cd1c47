"""Percent of the traced stretch of inference jobs in which no operation
ran on the card (the complement of the union of device intervals)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["job"].kind != "infer" or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
