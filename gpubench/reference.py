"""The plain reference the benchmark holds the program to.

Plain PyTorch over the benchmark's own graph arrays (``gpubench.graphs``):
it imports nothing of the program and takes none of its derived data (no
folded coefficients, tiers, streams or plans).  It works in variable-id
space on boolean graphs, factor by factor, from the definitions of the
factor functions (DeepDive's semantics: a literal is ``(value == 1)`` when
the edge is positive, its negation otherwise; head = the last edge):

    IMPLY_NATURAL, AND   1 iff every literal is true
    OR                   1 iff some literal is true
    EQUAL                1 iff all literals agree
    ISTRUE               the head literal
    IMPLY_MLN            1 if some body literal is false, else the head

Everything is computed in ``dtype``: float64 for the reference, bfloat16
for the lower-precision control (the weights rounded to it, every sum and
the sigmoid taken in it).
"""
from __future__ import annotations

import numpy as np
import torch

FUNC_IMPLY_NATURAL, FUNC_OR, FUNC_AND, FUNC_EQUAL = 0, 1, 2, 3
FUNC_ISTRUE, FUNC_IMPLY_MLN = 4, 13
KNOWN = (FUNC_IMPLY_NATURAL, FUNC_OR, FUNC_AND, FUNC_EQUAL, FUNC_ISTRUE,
         FUNC_IMPLY_MLN)
ROLE_EVIDENCE = 1
CHUNK_ELEMS = 1 << 26           # (factor, slot, chain) triples at a time


class Factors:
    """A boolean graph's factors as padded [F, A] tables on ``device``."""

    def __init__(self, g: dict, device):
        if (np.asarray(g["var_card"]) != 2).any():
            raise ValueError("the reference handles boolean graphs only")
        ftype = np.asarray(g["f_type"])
        bad = np.setdiff1d(np.unique(ftype), KNOWN)
        if len(bad):
            raise ValueError(f"factor types {bad.tolist()} are not in the "
                             "reference")
        f_ptr = np.asarray(g["f_ptr"], np.int64)
        arity = np.diff(f_ptr)
        A = int(arity.max())
        mask = np.arange(A) < arity[:, None]
        idx = np.where(mask, f_ptr[:-1, None] + np.arange(A), f_ptr[:-1, None])
        vids = np.asarray(g["e_vid"], np.int64)[idx]
        # a literal is true on value 1 exactly where (eqpred == 1) == ispos
        lit1 = (np.asarray(g["e_eqpred"])[idx] == 1) == np.asarray(
            g["e_ispos"], bool)[idx]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.device = torch.device(device)
        self.V, self.F, self.A = len(g["var_card"]), len(arity), A
        self.W = len(g["w_init"])
        self.vids, self.mask, self.lit1 = t(vids), t(mask), t(lit1)
        self.n = t(arity)
        self.ftype, self.wid = t(ftype.astype(np.int64)), t(
            np.asarray(g["f_wid"], np.int64))
        self.feat = t(np.asarray(g["f_feat"], np.float64))
        self.role = t(np.asarray(g["var_role"], np.int64))
        self.label = t(np.asarray(g["var_init"], np.int64))
        # slot s is the first slot of its variable in its factor
        first = np.ones_like(mask)
        for s in range(1, A):
            first[:, s] = ~((vids[:, :s] == vids[:, s:s + 1])
                            & mask[:, :s]).any(axis=1)
        self.first = t(first & mask)

    def chunks(self, NC: int):
        step = max(1, CHUNK_ELEMS // max(1, self.A * NC))
        for f0 in range(0, self.F, step):
            yield slice(f0, min(self.F, f0 + step))


def phi(ftype, lits, mask, n) -> torch.Tensor:
    """φ [Fc, NC] (bool) of factors with literals ``lits`` [Fc, A, NC]."""
    m = mask[:, :, None]
    nlit = (lits & m).sum(dim=1)
    n = n[:, None]
    last = (n - 1)[:, :, None].expand(-1, 1, lits.shape[2])
    head = lits.gather(1, last)[:, 0]
    every = nlit == n
    out = every                                     # AND, IMPLY_NATURAL
    ft = ftype[:, None]
    out = torch.where(ft == FUNC_OR, nlit > 0, out)
    out = torch.where(ft == FUNC_EQUAL, every | (nlit == 0), out)
    out = torch.where(ft == FUNC_ISTRUE, head, out)
    body_false = (nlit - head.to(nlit.dtype)) < (n - 1)
    return torch.where(ft == FUNC_IMPLY_MLN, body_false | head, out)


def _lits(fa: Factors, sl, values) -> torch.Tensor:
    """Literals [Fc, A, NC] of factors ``sl`` on boolean ``values``."""
    return (values[fa.vids[sl]] == 1) == fa.lit1[sl][:, :, None]


def logodds(fa: Factors, weights, old, new, colors, dtype=torch.float64):
    """Each variable's conditional log-odds [V, NC] in ``dtype``, as a
    chromatic sweep that draws the colors in increasing order sees it:
    a neighbour of a lower color at its value in ``new``, of a higher color
    at its value in ``old`` (``old`` = ``new`` for a fixed world).  A
    variable in several slots of one factor is set in all of them."""
    NC = old.shape[1]
    w = torch.as_tensor(weights, device=fa.device).to(dtype)
    coef_all = (w[fa.wid] * fa.feat.to(dtype))
    delta = torch.zeros((fa.V, NC), dtype=dtype, device=fa.device)
    col = torch.as_tensor(colors, device=fa.device).to(torch.int64)
    for sl in fa.chunks(NC):
        vids, mask, n, ft = fa.vids[sl], fa.mask[sl], fa.n[sl], fa.ftype[sl]
        lo, hi = _lits(fa, sl, old), _lits(fa, sl, new)
        c = col[vids]
        coef = coef_all[sl]
        for s in range(fa.A):
            keep = fa.first[sl][:, s]
            if not bool(keep.any()):
                continue
            cond = torch.where((c < c[:, s:s + 1])[:, :, None], hi, lo)
            same = ((vids == vids[:, s:s + 1]) & mask)[:, :, None]
            l1 = fa.lit1[sl][:, :, None]
            d = (phi(ft, torch.where(same, l1, cond), mask, n).to(dtype)
                 - phi(ft, torch.where(same, ~l1, cond), mask, n).to(dtype))
            delta.index_add_(0, vids[keep, s], (coef[keep, None] * d[keep]))
    return delta


def gradient(fa: Factors, ev, free, dtype=torch.float64) -> torch.Tensor:
    """The learning gradient [W] of one evidence and one free world: the
    chain mean of feat * (φ(ev) - φ(free)) summed by weight, over the
    factors with an evidence member (DeepDive's default).  Each term is
    taken in ``dtype`` and the terms summed in float32, as torch sums
    bfloat16 (in float64 for the reference), then rounded to ``dtype``."""
    NC = ev.shape[1]
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    grad = torch.zeros(fa.W, dtype=acc, device=fa.device)
    for sl in fa.chunks(NC):
        mask, n, ft = fa.mask[sl], fa.n[sl], fa.ftype[sl]
        keep = ((fa.role[fa.vids[sl]] == ROLE_EVIDENCE) & mask).any(dim=1)
        diff = (phi(ft, _lits(fa, sl, ev), mask, n).to(dtype)
                - phi(ft, _lits(fa, sl, free), mask, n).to(dtype))
        term = fa.feat[sl].to(dtype) * diff.mean(dim=1, dtype=dtype)
        grad.index_add_(0, fa.wid[sl][keep], term[keep].to(acc))
    return grad.to(dtype)


def tally(values_vid, K: int = 2) -> torch.Tensor:
    """Counts [K, V] int64 of each value over the chains."""
    return torch.stack([(values_vid == k).sum(dim=1) for k in range(K)])
