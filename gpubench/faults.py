"""Faults planted in the program's timed path, to show that the verdict
catches them (``tests/test_gpubench_faults.py`` on the CPU,
``readings.py`` on the card at a cell's own size).  Each fault wraps one
function of ``sampler_tpu_torch.engine.multichain``, which the entry
points look up by name at every call; each job kind lists the faults its
path can have (``FAULTS`` in ``gpubench/kinds/<kind>.py``).

"Half of the batch" is half of the chains, or, with one chain, half of
the rows (positions): the lattice's sites are then the batch."""
from __future__ import annotations

import contextlib

import torch


def _half(values) -> tuple:
    """(index of the kept half, of the other half) of ``values`` [P, NC]."""
    P, NC = values.shape[:2]
    if NC >= 2:
        return (slice(None), slice(0, NC // 2)), (slice(None),
                                                  slice(NC // 2, NC))
    return (slice(0, P // 2), slice(None)), (slice(P // 2, P), slice(None))


def unchanged(orig):
    """A sweep that returns its state unchanged."""
    def sweep(dg, values, *a, **k):
        return values
    return sweep


def half_batch(orig):
    """A sweep of half the batch; the rest keep their values."""
    def sweep(dg, values, *a, **k):
        before = values.clone()
        out = orig(dg, values, *a, **k)
        _, rest = _half(values)
        out[rest] = before[rest]
        return out
    return sweep


def altered_draws(orig):
    """A sweep whose draws of every 13th row are flipped where made."""
    def sweep(dg, values, *a, **k):
        out = orig(dg, values, *a, **k)
        out[::13] = 1 - out[::13]
        return out
    return sweep


def half_tally(orig):
    """The tally of half the batch, doubled: the mean over the rest."""
    def tally(counts, values):
        part = torch.zeros_like(counts)
        orig(part, values)
        P, NC = values.shape[:2]
        if NC >= 2:
            part.zero_()
            orig(part, values[:, : NC // 2].contiguous())
        else:
            part.view(-1, P)[:, P // 2:] = 0
        counts += 2 * part
    return tally


def altered_tally(orig):
    """One count altered where it is produced."""
    def tally(counts, values):
        orig(counts, values)
        counts.view(-1)[3] += 1
    return tally


def half_gradient(orig):
    """The gradient of half the batch, doubled: the mean over the rest
    (one chain: the other rows' free values set to their evidence-world
    values, so their terms cancel)."""
    def grad(dg, v_ev, v_free, *a, **k):
        keep, rest = _half(v_ev)
        if v_ev.shape[1] >= 2:
            c = keep[1]
            return orig(dg, v_ev[:, c].contiguous(),
                        v_free[:, c].contiguous(), *a, **k)
        free = v_free.clone()
        free[rest] = v_ev[rest]
        return 2 * orig(dg, v_ev, free, *a, **k)
    return grad


def altered_gradient(orig):
    """One gradient entry altered where it is produced."""
    def grad(*a, **k):
        g = orig(*a, **k).clone()
        g[0] += 0.05 * float(g.abs().max()) + 0.5
        return g
    return grad


@contextlib.contextmanager
def planted(target: str, wrap):
    """``engine.multichain.<target>`` replaced by ``wrap(original)``."""
    import sampler_tpu_torch.engine.multichain as mc

    orig = getattr(mc, target)
    setattr(mc, target, wrap(orig))
    try:
        yield
    finally:
        setattr(mc, target, orig)
