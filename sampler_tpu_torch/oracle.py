"""Exact-enumeration oracle: ground-truth marginals for small graphs.

Replaces reference-output parity (the reference binary is unavailable — see
SURVEY.md §0/§4): the sampler is validated against exact marginals computed by
brute-force enumeration of every joint assignment, which is strictly stronger
than matching another sampler's Monte-Carlo output.
"""
from __future__ import annotations

import numpy as np

from . import factor_functions as ff
from .graph import FactorGraph


def enumerate_assignments(graph: FactorGraph, clamp_evidence: bool) -> np.ndarray:
    """All joint assignments [N, V] (mixed-radix); evidence optionally clamped."""
    cards = graph.var_card.astype(np.int64)
    free = np.ones(graph.n_vars, bool)
    if clamp_evidence:
        free = graph.var_role == 0
    radices = np.where(free, cards, 1)
    n = int(np.prod(radices))
    if n > (1 << 24):
        raise ValueError(f"graph too large for exact enumeration: {n} states")
    idx = np.arange(n, dtype=np.int64)
    cols = []
    for v in range(graph.n_vars):
        if free[v]:
            cols.append((idx % radices[v]).astype(np.int32))
            idx = idx // radices[v]
        else:
            cols.append(np.full(n, graph.var_init[v], np.int32))
    return np.stack(cols, axis=1)


def log_potential(graph: FactorGraph, assignments: np.ndarray,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """Unnormalized log p for each assignment row: Σ_f w·feat·φ_f."""
    w = graph.w_init if weights is None else np.asarray(weights, np.float64)
    # sparse per-combination tables: fid -> {combination tuple: wid}
    cw = {}
    if graph.cw_fid is not None:
        arity = graph.arities()
        for e in range(len(graph.cw_fid)):
            f = int(graph.cw_fid[e])
            key = tuple(graph.cw_cats[e, : arity[f]])
            cw.setdefault(f, {})[key] = int(graph.cw_wid[e])
    logp = np.zeros(len(assignments), np.float64)
    for f in range(graph.n_factors):
        lo, hi = graph.f_ptr[f], graph.f_ptr[f + 1]
        vids = graph.e_vid[lo:hi]
        if f in cw:
            # sparse variant: the weight of the CURRENT combination applies
            # (absent combinations contribute 0); f_wid is ignored
            table = cw[f]
            wids = np.array(
                [table.get(tuple(row), -1) for row in assignments[:, vids]],
                np.int64)
            w_ext = np.append(w, 0.0)
            logp += w_ext[wids] * graph.f_feat[f]
            continue
        lits = ff.literals(
            assignments[:, vids], graph.e_eqpred[lo:hi][None, :],
            graph.e_ispos[lo:hi][None, :],
        )
        phi = ff.eval_factor(int(graph.f_type[f]), lits)
        logp += w[graph.f_wid[f]] * graph.f_feat[f] * phi
    return logp


def exact_marginals(graph: FactorGraph, clamp_evidence: bool = True,
                    weights: np.ndarray | None = None) -> np.ndarray:
    """Exact marginals P(v = k) as float64 [V, max_card].

    Evidence variables (when clamped) get probability 1 on their value.
    Entries k >= card(v) are 0.
    """
    A = enumerate_assignments(graph, clamp_evidence)
    logp = log_potential(graph, A, weights)
    p = np.exp(logp - logp.max())
    p /= p.sum()
    K = int(graph.var_card.max())
    marg = np.zeros((graph.n_vars, K), np.float64)
    for v in range(graph.n_vars):
        for k in range(int(graph.var_card[v])):
            marg[v, k] = p[A[:, v] == k].sum()
    return marg


def log_partition(graph: FactorGraph, clamp_evidence: bool = False,
                  weights: np.ndarray | None = None) -> float:
    A = enumerate_assignments(graph, clamp_evidence)
    logp = log_potential(graph, A, weights)
    m = logp.max()
    return float(m + np.log(np.exp(logp - m).sum()))
