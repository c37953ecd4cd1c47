"""Host microseconds a sweep that the kernel wrappers take in the traced
inference jobs: the self time of the ``op.*`` spans (a wrapper's
argument checks, its launch and counter) under the program's
``engine.run_inference`` spans, over the ``engine.sweep`` spans under
them (``sampler_tpu_torch.observe.spans``)."""


def read(ctx):
    if ctx.get("trace") is None or ctx["job"].kind != "infer":
        return None
    try:
        from sampler_tpu_torch.observe import self_ns, spans
    except ImportError:
        return None
    recs = spans()
    own = self_ns(recs)
    inside = []                 # under an engine.run_inference span
    op_ns, sweeps = 0, 0
    for r, s in zip(recs, own):
        up = inside[r.parent] if r.parent >= 0 else False
        inside.append(up or r.name == "engine.run_inference")
        if not up:
            continue
        if r.name == "engine.sweep":
            sweeps += 1
        elif r.name.startswith("op.") and s is not None:
            op_ns += s
    return op_ns * 1e-3 / sweeps if sweeps else None
