"""Vectorized large-graph constructors for benchmarks (no per-factor Python
loops — these must scale to 10^7+ variables).

The canonical benchmark is a 2-D Ising grid with per-node bias (ISTRUE) and
nearest-neighbour coupling (EQUAL) — the same shape as the reference's
KBC-style boolean workloads and exactly 2-colorable analytically (so bench
setup skips greedy coloring).
"""
from __future__ import annotations

import numpy as np

from . import format_spec as fs
from .graph import FactorGraph


def big_ising_grid(rows: int, cols: int, w_pair: float = 0.5,
                   w_bias: float = 0.2):
    """Returns (FactorGraph, colors) for an R×C grid, built vectorized."""
    V = rows * cols
    r, c = np.divmod(np.arange(V, dtype=np.int64), cols)

    # bias factors: one ISTRUE per variable
    bias_vids = np.arange(V, dtype=np.int64)
    # horizontal pairs (r, c)-(r, c+1)
    hmask = c < cols - 1
    h_a = np.nonzero(hmask)[0]
    h_b = h_a + 1
    # vertical pairs (r, c)-(r+1, c)
    vmask = r < rows - 1
    v_a = np.nonzero(vmask)[0]
    v_b = v_a + cols

    n_bias, n_h, n_v = V, len(h_a), len(v_a)
    F = n_bias + n_h + n_v
    f_type = np.concatenate([
        np.full(n_bias, fs.FUNC_ISTRUE, np.int32),
        np.full(n_h + n_v, fs.FUNC_EQUAL, np.int32),
    ])
    f_wid = np.concatenate([
        np.zeros(n_bias, np.int32), np.ones(n_h + n_v, np.int32)])
    f_feat = np.ones(F, np.float64)
    arity = np.concatenate([
        np.ones(n_bias, np.int64), np.full(n_h + n_v, 2, np.int64)])
    f_ptr = np.zeros(F + 1, np.int64)
    np.cumsum(arity, out=f_ptr[1:])

    pair_edges = np.stack([np.concatenate([h_a, v_a]),
                           np.concatenate([h_b, v_b])], axis=1).reshape(-1)
    e_vid = np.concatenate([bias_vids, pair_edges]).astype(np.int32)
    E = len(e_vid)

    g = FactorGraph(
        var_dtype=np.zeros(V, np.uint8),
        var_role=np.zeros(V, np.uint8),
        var_init=np.zeros(V, np.int32),
        var_card=np.full(V, 2, np.int32),
        w_init=np.asarray([w_bias, w_pair], np.float64),
        w_fixed=np.zeros(2, bool),
        f_type=f_type, f_wid=f_wid, f_feat=f_feat, f_ptr=f_ptr,
        e_vid=e_vid,
        e_ispos=np.ones(E, bool),
        e_eqpred=np.ones(E, np.int32),
    )
    colors = ((r + c) % 2).astype(np.int32)  # checkerboard: exact 2-coloring
    return g, colors


def random_kbc_graph(n_vars: int, n_factors: int, max_arity: int = 3,
                     n_weights: int = 1000, seed: int = 0,
                     evidence_frac: float = 0.1, skew: float = 0.0,
                     window: int = 0, hub_frac: float = 0.05,
                     scramble: bool = False):
    """Random boolean graph with mixed factor types, built vectorized.

    Shape mimics KBC workloads:
      * mixed arities 1..max_arity, many shared weights;
      * ``skew`` > 0: a POWER-LAW degree head — hub members drawn with
        probability ∝ (rank+1)^-skew, so a handful of hub entities touch
        orders of magnitude more factors than the median (real DeepDive
        entity-mention graphs);
      * ``window`` > 0: DOCUMENT LOCALITY — each factor's non-hub members
        come from a ±window band around a random center (mentions in one
        document), which is what makes a bandwidth-reducing ordering and
        the banded gather applicable to KBC shapes;
      * ``scramble``: destroy the id-space locality with a random
        permutation (the ordering must then be RECOVERED by rcm_order —
        tests use this to prove the ordering does real work).
    Returns FactorGraph (coloring left to greedy).
    """
    rng = np.random.default_rng(seed)
    arity = rng.integers(1, max_arity + 1, size=n_factors).astype(np.int64)
    f_ptr = np.zeros(n_factors + 1, np.int64)
    np.cumsum(arity, out=f_ptr[1:])
    E = int(f_ptr[-1])
    if window > 0:
        centers = rng.integers(0, n_vars, size=n_factors)
        base = np.repeat(centers, arity)
        offs = rng.integers(-window, window + 1, size=E)
        e_vid = np.clip(base + offs, 0, n_vars - 1).astype(np.int32)
    else:
        e_vid = rng.integers(0, n_vars, size=E).astype(np.int32)
    if skew > 0:
        w = (np.arange(1, n_vars + 1, dtype=np.float64)) ** (-skew)
        cdf = np.cumsum(w)
        cdf /= cdf[-1]
        hub_vid = np.minimum(np.searchsorted(cdf, rng.random(E)),
                             n_vars - 1).astype(np.int32)
        if window > 0:
            hub = rng.random(E) < hub_frac
            e_vid = np.where(hub, hub_vid, e_vid)
        else:
            e_vid = hub_vid
    if scramble:
        perm = rng.permutation(n_vars).astype(np.int32)
        e_vid = perm[e_vid]
    funcs = np.array([fs.FUNC_IMPLY_NATURAL, fs.FUNC_OR, fs.FUNC_AND,
                      fs.FUNC_IMPLY_MLN, fs.FUNC_ISTRUE], np.int32)
    f_type = funcs[rng.integers(0, len(funcs), size=n_factors)]
    f_type[arity == 1] = fs.FUNC_ISTRUE

    g = FactorGraph(
        var_dtype=np.zeros(n_vars, np.uint8),
        var_role=(rng.random(n_vars) < evidence_frac).astype(np.uint8),
        var_init=rng.integers(0, 2, size=n_vars).astype(np.int32),
        var_card=np.full(n_vars, 2, np.int32),
        w_init=rng.normal(0, 0.5, size=n_weights),
        w_fixed=np.zeros(n_weights, bool),
        f_type=f_type,
        f_wid=rng.integers(0, n_weights, size=n_factors).astype(np.int32),
        f_feat=np.ones(n_factors, np.float64),
        f_ptr=f_ptr,
        e_vid=e_vid,
        e_ispos=rng.random(E) < 0.8,
        e_eqpred=np.ones(E, np.int32),
    )
    return g


def big_potts_grid(rows: int, cols: int, card: int = 4,
                   w_pair: float = 0.5, w_bias: float = 0.2, seed: int = 0):
    """Categorical (configs[2]-shaped) benchmark: an R×C grid of card-K
    variables with AND_CATEGORICAL unary biases and EQUAL pairwise
    couplings on random equality predicates.  Runs the GENERAL
    [B, D, K, A, NC] candidate path (all_boolean is False), with the
    banded MXU gather still applicable (card <= 127).  Returns
    (FactorGraph, colors)."""
    rng = np.random.default_rng(seed)
    V = rows * cols
    r, c = np.divmod(np.arange(V, dtype=np.int64), cols)

    bias_vids = np.arange(V, dtype=np.int64)
    hmask = c < cols - 1
    h_a = np.nonzero(hmask)[0]
    h_b = h_a + 1
    vmask = r < rows - 1
    v_a = np.nonzero(vmask)[0]
    v_b = v_a + cols

    n_bias, n_pair = V, len(h_a) + len(v_a)
    F = n_bias + n_pair
    f_type = np.concatenate([
        np.full(n_bias, fs.FUNC_AND_CATEGORICAL, np.int32),
        np.full(n_pair, fs.FUNC_EQUAL, np.int32),
    ])
    f_wid = np.concatenate([
        np.zeros(n_bias, np.int32), np.ones(n_pair, np.int32)])
    f_feat = np.ones(F, np.float64)
    arity = np.concatenate([
        np.ones(n_bias, np.int64), np.full(n_pair, 2, np.int64)])
    f_ptr = np.zeros(F + 1, np.int64)
    np.cumsum(arity, out=f_ptr[1:])

    pair_edges = np.stack([np.concatenate([h_a, v_a]),
                           np.concatenate([h_b, v_b])], axis=1).reshape(-1)
    e_vid = np.concatenate([bias_vids, pair_edges]).astype(np.int32)
    E = len(e_vid)

    g = FactorGraph(
        var_dtype=np.ones(V, np.uint8),        # categorical
        var_role=np.zeros(V, np.uint8),
        var_init=np.zeros(V, np.int32),
        var_card=np.full(V, card, np.int32),
        w_init=np.asarray([w_bias, w_pair], np.float64),
        w_fixed=np.zeros(2, bool),
        f_type=f_type, f_wid=f_wid, f_feat=f_feat, f_ptr=f_ptr,
        e_vid=e_vid,
        e_ispos=np.ones(E, bool),
        e_eqpred=rng.integers(0, card, size=E).astype(np.int32),
    )
    colors = ((r + c) % 2).astype(np.int32)
    return g, colors


def big_triple_grid(rows: int, cols: int, w_tri: float = 0.3,
                    w_bias: float = 0.2):
    """Arity-3 boolean benchmark: ISTRUE biases + OR factors over each
    horizontal (c, c+1, c+2) triple.  Exercises the A=3 general path (no
    affine fusion).  Deterministic 3-coloring: columns mod 3 (all factor
    members sit in one row within a 3-column window).  Returns
    (FactorGraph, colors)."""
    V = rows * cols
    r, c = np.divmod(np.arange(V, dtype=np.int64), cols)

    bias_vids = np.arange(V, dtype=np.int64)
    tmask = c < cols - 2
    t_a = np.nonzero(tmask)[0]

    n_bias, n_tri = V, len(t_a)
    F = n_bias + n_tri
    f_type = np.concatenate([
        np.full(n_bias, fs.FUNC_ISTRUE, np.int32),
        np.full(n_tri, fs.FUNC_OR, np.int32),
    ])
    f_wid = np.concatenate([
        np.zeros(n_bias, np.int32), np.ones(n_tri, np.int32)])
    f_feat = np.ones(F, np.float64)
    arity = np.concatenate([
        np.ones(n_bias, np.int64), np.full(n_tri, 3, np.int64)])
    f_ptr = np.zeros(F + 1, np.int64)
    np.cumsum(arity, out=f_ptr[1:])

    tri_edges = np.stack([t_a, t_a + 1, t_a + 2], axis=1).reshape(-1)
    e_vid = np.concatenate([bias_vids, tri_edges]).astype(np.int32)
    E = len(e_vid)

    g = FactorGraph(
        var_dtype=np.zeros(V, np.uint8),
        var_role=np.zeros(V, np.uint8),
        var_init=np.zeros(V, np.int32),
        var_card=np.full(V, 2, np.int32),
        w_init=np.asarray([w_bias, w_tri], np.float64),
        w_fixed=np.zeros(2, bool),
        f_type=f_type, f_wid=f_wid, f_feat=f_feat, f_ptr=f_ptr,
        e_vid=e_vid,
        e_ispos=np.ones(E, bool),
        e_eqpred=np.ones(E, np.int32),
    )
    colors = (c % 3).astype(np.int32)
    return g, colors
