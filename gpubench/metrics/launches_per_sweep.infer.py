"""Device kernels a sweep in the traced inference jobs (burn-in and
counted sweeps; the tally, the fold and the copies included)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["job"].kind != "infer" or not tr.sweeps:
        return None
    return tr.n_kernels / tr.sweeps
