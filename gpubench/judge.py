"""What decides ``correct``: the program's outputs held to the reference.

The judge reads the program's worlds in variable-id space through the
compiled graph's ``pos_of_vid`` (the map the program's own marginals use)
and the coloring that set-up handed to ``compile_graph`` (a sweep draws
the colors in increasing order; the judge checks that no factor holds two
variables of one color).  Everything else it works out from the graph
arrays (``gpubench.reference``).  Each job kind
(``gpubench/kinds/<kind>.py``) makes its numbers from the pieces here.

``draw_z`` pools the judged sweeps of every kept job: each draw's
(x - p) and p(1 - p), p the reference's conditional probability given
what the sweep saw, summed in bins of the reference's log-odds (0.5 wide
over -8..8, two tails); the number is the largest |sum (x - p)| /
sqrt(sum p(1 - p)) of any bin.  Each draw's x - p has mean 0 given every
draw before it in the sweep's order, so a bin's z is a standard normal
under a sound program, over as many jobs as are kept.

``control=True`` puts the lower-precision control (the reference in
bfloat16) in the program's place on the same conditioning worlds: its
draws are Bernoulli draws from its own probabilities, its weight change
its own step in bfloat16.
"""
from __future__ import annotations

import torch

from . import reference as ref

BIN_W, BIN_LO, BIN_HI = 0.5, -8.0, 8.0
N_BINS = int(round((BIN_HI - BIN_LO) / BIN_W)) + 2
ROW_BLOCK = 1 << 14
CONTROL = torch.bfloat16


class ZBins:
    """Draws against the reference's conditionals, pooled by log-odds."""

    def __init__(self, device):
        z = dict(dtype=torch.float64, device=device)
        self.n, self.s1, self.s2 = (torch.zeros(N_BINS, **z) for _ in range(3))

    def add(self, fa, weights, old, new, colors, drawn, control=False,
            gen=None) -> None:
        """The draws from ``old`` to ``new`` (vid space [V, NC]) of the
        variables ``drawn`` (bool [V])."""
        delta = ref.logodds(fa, weights, old, new, colors)
        if control:
            pc = torch.sigmoid(ref.logodds(fa, weights, old, new, colors,
                                           CONTROL))
            x = torch.bernoulli(pc.to(torch.float64), generator=gen).to(
                torch.int8)
            del pc
        else:
            x = new
        rows = torch.nonzero(drawn)[:, 0]
        for r0 in range(0, len(rows), ROW_BLOCK):
            r = rows[r0:r0 + ROW_BLOCK]
            d = delta[r].to(torch.float64)
            p = torch.sigmoid(d)
            b = (torch.floor((d - BIN_LO) / BIN_W).clamp(-1, N_BINS - 2)
                 + 1).long().reshape(-1)
            self.n.index_add_(0, b, torch.ones_like(p).reshape(-1))
            self.s1.index_add_(0, b, (x[r].to(torch.float64) - p).reshape(-1))
            self.s2.index_add_(0, b, (p * (1 - p)).reshape(-1))

    def z(self) -> torch.Tensor:
        return self.s1 / self.s2.clamp(min=1).sqrt()

    def max(self) -> float:
        return float(self.z().abs().max())

    def table(self) -> list:
        """[log-odds bin's lower edge, draws, z] of every bin drawn in."""
        z = self.z().tolist()
        return [[BIN_LO + (i - 1) * BIN_W, int(n), z[i]]
                for i, n in enumerate(self.n.tolist()) if n]


def proper(fa, colors) -> bool:
    """No factor holds two distinct variables of one color."""
    c = torch.as_tensor(colors, device=fa.device).long()[fa.vids]
    for s in range(fa.A):
        for t in range(s + 1, fa.A):
            bad = (fa.mask[:, s] & fa.mask[:, t] & (c[:, s] == c[:, t])
                   & (fa.vids[:, s] != fa.vids[:, t]))
            if bool(bad.any()):
                return False
    return True


def clamped_moved(fa, world) -> int:
    ev = fa.role == ref.ROLE_EVIDENCE
    return int((world[ev] != fa.label[ev][:, None]).sum())


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit,
    and every limit read."""
    rows = [(k, numbers.get(k), limits[k]) for k in sorted(limits)]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows
