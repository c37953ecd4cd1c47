"""Factor-function semantics — the NumPy reference implementation.

This module is the executable specification of φ_f for every factor-function
type (SURVEY.md §2b; ref: src/factor.cc CompactFactor::potential — recalled).
It is used by the exact-enumeration oracle and by the truth-table tests.
The JAX engine (engine/potentials.py) re-implements the same semantics
independently and is tested against this module — a deliberate
double-implementation guard.

Uniform literal convention
--------------------------
Every edge (factor membership) carries ``is_positive`` and ``equal_predicate``.
A variable with value v contributes the literal

    lit = (v == equal_predicate)  XNOR  is_positive

For boolean variables the loader sets ``equal_predicate = 1``, so
``lit = (v == 1)`` when positive and ``(v != 1)`` when negated — exactly the
reference's boolean semantics; categorical variables compare against their
per-edge predicate.

φ definitions (head = literal of the LAST edge, body = all earlier edges):

    IMPLY_NATURAL   1 if all body lits true AND head true, else 0
                    (neutral 0 when body unsatisfied)
    OR              1 iff any literal true
    AND             1 iff all literals true
    EQUAL           1 iff all literals agree (specified pairwise; arity 2 in
                    practice)
    ISTRUE          the single literal
    LINEAR          # of body literals b_i with (b_i => head) satisfied;
                    for arity 1, the head literal itself
    RATIO           log(1 + LINEAR)
    LOGICAL         1 iff LINEAR > 0
    AND_CATEGORICAL 1 iff every edge's variable equals its equal_predicate
                    (same as AND under the uniform literal convention)
    IMPLY_MLN       classical implication: 1 if body unsatisfied, else head
"""
from __future__ import annotations

import numpy as np

from . import format_spec as fs


def literals(values, eqpred, ispos):
    """Uniform literal: (value == eqpred) XNOR ispos.  All args broadcast."""
    eq = np.asarray(values) == np.asarray(eqpred)
    return np.where(np.asarray(ispos).astype(bool), eq, ~eq)


def eval_factor(ftype: int, lits, mask=None) -> np.ndarray:
    """Evaluate φ for one factor type.

    Parameters
    ----------
    ftype : factor-function enum value (format_spec.FUNC_*)
    lits  : bool array [..., A] — per-edge literals (A = padded arity)
    mask  : bool array [..., A] — True on real edges; None = all real.

    Returns float64 array [...] of potentials.
    """
    lits = np.asarray(lits, dtype=bool)
    if mask is None:
        mask = np.ones_like(lits, dtype=bool)
    else:
        mask = np.asarray(mask, dtype=bool)
    n = mask.sum(axis=-1)  # true arity per factor
    nlit = (lits & mask).sum(axis=-1)  # satisfied literals

    # head = literal at the last REAL slot (index n-1)
    head_idx = np.maximum(n - 1, 0)
    head = np.take_along_axis(lits, head_idx[..., None], axis=-1)[..., 0]
    nbody = nlit - head.astype(nlit.dtype)
    n_body = np.maximum(n - 1, 0)

    if ftype in (fs.FUNC_AND, fs.FUNC_AND_CATEGORICAL, fs.FUNC_IMPLY_NATURAL):
        return (nlit == n).astype(np.float64)
    if ftype == fs.FUNC_OR:
        return (nlit > 0).astype(np.float64)
    if ftype == fs.FUNC_EQUAL:
        return ((nlit == 0) | (nlit == n)).astype(np.float64)
    if ftype == fs.FUNC_ISTRUE:
        return head.astype(np.float64)
    if ftype == fs.FUNC_IMPLY_MLN:
        return np.where(nbody < n_body, 1.0, head.astype(np.float64))
    # LINEAR family: count of satisfied body implications (b_i => head)
    lin = np.where(head, n_body, n_body - nbody).astype(np.float64)
    lin = np.where(n == 1, head.astype(np.float64), lin)
    if ftype == fs.FUNC_LINEAR:
        return lin
    if ftype == fs.FUNC_RATIO:
        return np.log1p(lin)
    if ftype == fs.FUNC_LOGICAL:
        return (lin > 0).astype(np.float64)
    raise ValueError(f"unknown factor function type {ftype}")
