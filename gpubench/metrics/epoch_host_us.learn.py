"""Host microseconds of a learning epoch in the traced learning jobs: the
mean inclusive time of the program's ``engine.epoch`` spans (the fold,
both worlds' sweeps, the gradient and the update enqueued;
``sampler_tpu_torch.observe.spans``)."""


def read(ctx):
    if ctx.get("trace") is None or ctx["job"].kind != "learn":
        return None
    try:
        from sampler_tpu_torch.observe import spans
    except ImportError:
        return None
    ns = [r.end_ns - r.start_ns for r in spans()
          if r.name == "engine.epoch" and r.end_ns is not None]
    return sum(ns) * 1e-3 / len(ns) if ns else None
