"""Device kernels a learning epoch in the traced learning jobs (fold,
the sweeps of both worlds, gradient, update)."""


def read(ctx):
    tr, job = ctx.get("trace"), ctx["job"]
    if tr is None or job.kind != "learn" or not tr.jobs:
        return None
    return tr.n_kernels / (tr.jobs * job.cfg.n_epochs)
