"""Synthetic factor-graph fixture generators.

Substitutes for the reference's checked-in test fixtures (ref: test/<name>/
binary dirs — recalled, unavailable): each generator returns a FactorGraph
with known structure; correctness is asserted against the exact oracle.
Covers BASELINE.json configs[0..4].
"""
from __future__ import annotations

import numpy as np

from . import format_spec as fs
from .graph import FactorGraph


def biased_coin(w: float = 1.5) -> FactorGraph:
    """Single boolean variable with an ISTRUE factor: P(x=1) = sigmoid(w).

    The reference's canonical statistical test (SURVEY.md §4).
    """
    return FactorGraph.build(
        var_card=[2],
        weights=[w],
        factors=[(fs.FUNC_ISTRUE, 0, 1.0, [(0, True)])],
    )


def ising_chain(n: int = 8, w_pair: float = 0.8, w_bias: float = 0.3) -> FactorGraph:
    """Boolean chain: bias (ISTRUE) on each node, EQUAL coupling on each edge."""
    factors = [(fs.FUNC_ISTRUE, 0, 1.0, [(i, True)]) for i in range(n)]
    factors += [(fs.FUNC_EQUAL, 1, 1.0, [(i, True), (i + 1, True)]) for i in range(n - 1)]
    return FactorGraph.build(var_card=[2] * n, weights=[w_bias, w_pair], factors=factors)


def ising_grid(rows: int = 4, cols: int = 4, w_pair: float = 0.5,
               w_bias: float = 0.2) -> FactorGraph:
    """2-D boolean grid Ising model (configs[0] smoke graph)."""
    n = rows * cols
    vid = lambda r, c: r * cols + c
    factors = [(fs.FUNC_ISTRUE, 0, 1.0, [(i, True)]) for i in range(n)]
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                factors.append((fs.FUNC_EQUAL, 1, 1.0, [(vid(r, c), True), (vid(r, c + 1), True)]))
            if r + 1 < rows:
                factors.append((fs.FUNC_EQUAL, 1, 1.0, [(vid(r, c), True), (vid(r + 1, c), True)]))
    return FactorGraph.build(var_card=[2] * n, weights=[w_bias, w_pair], factors=factors)


def all_functions_graph(seed: int = 0, n: int = 10) -> FactorGraph:
    """Boolean graph exercising every boolean factor function + negated edges
    + evidence clamping (configs[1])."""
    rng = np.random.default_rng(seed)
    funcs = [fs.FUNC_IMPLY_NATURAL, fs.FUNC_OR, fs.FUNC_AND, fs.FUNC_EQUAL,
             fs.FUNC_ISTRUE, fs.FUNC_LINEAR, fs.FUNC_RATIO, fs.FUNC_LOGICAL,
             fs.FUNC_IMPLY_MLN]
    weights = rng.normal(0, 0.8, size=len(funcs)).round(3)
    factors = []
    for i, f in enumerate(funcs):
        arity = 1 if f == fs.FUNC_ISTRUE else (2 if f == fs.FUNC_EQUAL else 3)
        vids = rng.choice(n, size=arity, replace=False)
        edges = [(int(v), bool(rng.integers(2))) for v in vids]
        factors.append((f, i, float(rng.choice([0.5, 1.0, 2.0])), edges))
    role = np.zeros(n, np.uint8)
    role[:2] = fs.ROLE_EVIDENCE
    init = np.zeros(n, np.int32)
    init[0] = 1
    return FactorGraph.build(var_card=[2] * n, weights=weights, factors=factors,
                             var_role=role, var_init=init)


def categorical_graph(seed: int = 0, n: int = 6, card: int = 4) -> FactorGraph:
    """Categorical variables with multi-arity AND_CATEGORICAL factors
    (configs[2])."""
    rng = np.random.default_rng(seed)
    weights = rng.normal(0, 0.7, size=8).round(3)
    factors = []
    for i in range(8):
        arity = int(rng.integers(1, 4))
        vids = rng.choice(n, size=arity, replace=False)
        edges = [(int(v), True, int(rng.integers(card))) for v in vids]
        factors.append((fs.FUNC_AND_CATEGORICAL, i, 1.0, edges))
    return FactorGraph.build(var_card=[card] * n, weights=weights, factors=factors)


def sparse_categorical_graph(seed: int = 0, n: int = 6,
                             card: int = 3) -> FactorGraph:
    """FUNC_AND_CATEGORICAL with SPARSE PER-COMBINATION weights (SURVEY.md
    §2b note): unary factors share a per-category weight table; pairwise
    factors share a (card x card) table with one combination deliberately
    ABSENT (contributes 0).  Exercises the dense mixed-radix lookup."""
    rng = np.random.default_rng(seed)
    # weights 0..card-1: unary table; card..card+card^2-1: pairwise table
    n_w = card + card * card
    weights = rng.normal(0, 0.5, size=n_w).round(3)
    unary_tab = [((k,), k) for k in range(card)]
    pair_tab = [((a, b), card + a * card + b)
                for a in range(card) for b in range(card)
                if not (a == 0 and b == 0)]            # (0,0) absent
    factors = []
    for v in range(n):
        factors.append((fs.FUNC_AND_CATEGORICAL, 0, 1.0, [(v, True, 0)],
                        unary_tab))
    for v in range(n - 1):
        factors.append((fs.FUNC_AND_CATEGORICAL, 0, 1.0,
                        [(v, True, 0), (v + 1, True, 0)], pair_tab))
    return FactorGraph.build(var_card=[card] * n, weights=weights,
                             factors=factors)


def labeled_categorical_graph(n_obs: int = 400, probs=(0.6, 0.3, 0.1),
                              seed: int = 0) -> FactorGraph:
    """Learning fixture for sparse per-combination weights: n_obs evidence
    categorical draws share one per-category weight table; SGD must recover
    softmax(w) ≈ empirical category frequencies."""
    rng = np.random.default_rng(seed)
    card = len(probs)
    labels = rng.choice(card, size=n_obs, p=probs).astype(np.int32)
    tab = [((k,), k) for k in range(card)]
    factors = [(fs.FUNC_AND_CATEGORICAL, 0, 1.0, [(i, True, 0)], tab)
               for i in range(n_obs)]
    return FactorGraph.build(
        var_card=[card] * n_obs,
        weights=[0.0] * card,
        factors=factors,
        var_role=np.full(n_obs, fs.ROLE_EVIDENCE, np.uint8),
        var_init=labels,
    )


def mixed_graph(seed: int = 0) -> FactorGraph:
    """Boolean + categorical variables in one graph, mixed factor types."""
    rng = np.random.default_rng(seed)
    card = [2, 2, 2, 3, 4, 2]
    weights = rng.normal(0, 0.6, size=6).round(3)
    factors = [
        (fs.FUNC_ISTRUE, 0, 1.0, [(0, True)]),
        (fs.FUNC_EQUAL, 1, 1.0, [(0, True), (1, True)]),
        (fs.FUNC_AND_CATEGORICAL, 2, 1.0, [(3, True, 1), (4, True, 2)]),
        (fs.FUNC_OR, 3, 1.0, [(1, True), (2, False), (5, True)]),
        (fs.FUNC_AND_CATEGORICAL, 4, 2.0, [(4, True, 0)]),
        (fs.FUNC_IMPLY_MLN, 5, 1.0, [(2, True), (5, True)]),
    ]
    return FactorGraph.build(var_card=card, weights=weights, factors=factors)


def labeled_coin_graph(n_flips: int = 200, p_heads: float = 0.8,
                       seed: int = 0) -> FactorGraph:
    """Learning fixture (configs[3]): n evidence coin flips sharing one
    ISTRUE weight.  SGD must recover w* = logit(p̂_heads)."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(n_flips) < p_heads).astype(np.int32)
    factors = [(fs.FUNC_ISTRUE, 0, 1.0, [(i, True)]) for i in range(n_flips)]
    return FactorGraph.build(
        var_card=[2] * n_flips,
        weights=[0.0],
        factors=factors,
        var_role=np.full(n_flips, fs.ROLE_EVIDENCE, np.uint8),
        var_init=labels,
    )


def random_boolean_graph(n_vars: int, n_factors: int, max_arity: int = 3,
                         seed: int = 0, evidence_frac: float = 0.0) -> FactorGraph:
    """Random boolean graph for fuzz/parity tests and benchmarks."""
    rng = np.random.default_rng(seed)
    funcs = np.array([fs.FUNC_IMPLY_NATURAL, fs.FUNC_OR, fs.FUNC_AND,
                      fs.FUNC_ISTRUE, fs.FUNC_IMPLY_MLN, fs.FUNC_EQUAL])
    n_weights = max(2, n_factors // 4)
    weights = rng.normal(0, 0.5, size=n_weights).round(4)
    factors = []
    for _ in range(n_factors):
        f = int(rng.choice(funcs))
        arity = 1 if f == fs.FUNC_ISTRUE else int(rng.integers(2, max_arity + 1))
        arity = min(arity, n_vars)
        vids = rng.choice(n_vars, size=arity, replace=False)
        edges = [(int(v), bool(rng.integers(2))) for v in vids]
        factors.append((f, int(rng.integers(n_weights)), 1.0, edges))
    role = (rng.random(n_vars) < evidence_frac).astype(np.uint8)
    init = rng.integers(0, 2, size=n_vars).astype(np.int32)
    return FactorGraph.build(var_card=[2] * n_vars, weights=weights,
                             factors=factors, var_role=role, var_init=init)
