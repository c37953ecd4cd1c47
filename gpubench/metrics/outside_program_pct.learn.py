"""Percent of the traced stretch of learning jobs spent in no span of the
program: 100 x (1 - the root spans' inclusive seconds / the stretch's
seconds): a job's own host copies and reindex, and the glue between
the entry points (``sampler_tpu_torch.observe.spans``)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["job"].kind != "learn" or tr.window_s <= 0:
        return None
    try:
        from sampler_tpu_torch.observe import spans
    except ImportError:
        return None
    roots = [r.end_ns - r.start_ns for r in spans()
             if r.parent < 0 and r.end_ns is not None]
    if not roots:
        return None
    return 100.0 * (1.0 - sum(roots) * 1e-9 / tr.window_s)
