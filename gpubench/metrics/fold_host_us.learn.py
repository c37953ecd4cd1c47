"""Host microseconds an epoch of the fold in the traced learning jobs:
the inclusive time of the program's ``engine.fold`` spans under
``engine.epoch`` spans, over the epochs
(``sampler_tpu_torch.observe.spans``)."""


def read(ctx):
    if ctx.get("trace") is None or ctx["job"].kind != "learn":
        return None
    try:
        from sampler_tpu_torch.observe import spans
    except ImportError:
        return None
    recs = spans()
    epochs, fold_ns = 0, 0
    for r in recs:
        if r.end_ns is None:
            continue
        if r.name == "engine.epoch":
            epochs += 1
        elif (r.name == "engine.fold" and r.parent >= 0
              and recs[r.parent].name == "engine.epoch"):
            fold_ns += r.end_ns - r.start_ns
    return fold_ns * 1e-3 / epochs if epochs else None
