"""Host microseconds a sweep of the traced inference jobs: the inclusive
time of the program's ``engine.run_inference`` spans over the
``engine.sweep`` spans under them, so a sweep's host enqueue time, the
tally's included (``sampler_tpu_torch.observe.spans``; spans record only
while a profiler runs, so the records are the traced stretch's)."""


def read(ctx):
    if ctx.get("trace") is None or ctx["job"].kind != "infer":
        return None
    try:
        from sampler_tpu_torch.observe import spans
    except ImportError:
        return None
    recs = spans()
    run = []                    # index of the enclosing run, or -1
    run_ns, sweeps = 0, 0
    for r in recs:
        outer = run[r.parent] if r.parent >= 0 else -1
        if r.name == "engine.run_inference" and r.end_ns is not None:
            run.append(len(run))
            run_ns += r.end_ns - r.start_ns
            continue
        run.append(outer)
        if r.name == "engine.sweep" and outer >= 0:
            sweeps += 1
    return run_ns * 1e-3 / sweeps if sweeps else None
