"""Factor-function evaluation on torch tensors (counterpart of
sampler_tpu/engine/potentials.py, the device-side twin of
factor_functions.py).

Branchless over factor types and specialized to the types present in the
compiled graph (CompileInfo.present_funcs): only the needed variants are
computed, and a single-type graph gets no select at all.  The engine
(engine/multichain.py) evaluates φ with the chain axis trailing
(``_eval_phi_ax2``, ``_factor_phis_mc``); ``eval_phi`` and
``factor_phis`` are those at one chain.  ``literals`` is
factor_functions' (NumPy).
"""
from __future__ import annotations

import torch

from .. import format_spec as fs
from ..compile import factor_records
from ..factor_functions import literals  # noqa: F401  (re-exported)


def _need_head(present) -> bool:
    return any(t in present for t in (
        fs.FUNC_ISTRUE, fs.FUNC_IMPLY_MLN, fs.FUNC_LINEAR, fs.FUNC_RATIO,
        fs.FUNC_LOGICAL))


def _phi_from_counts(nlit, head, n, f_type, present):
    """φ from sufficient statistics: nlit = # true literals, head = head
    literal (None if no present type needs it), n = true arity.
    Branchless over ``present``; all args broadcast together."""
    f32 = torch.float32
    if head is not None:
        nbody = nlit - head.to(torch.int32)
        n_body = torch.clamp(n - 1, min=0)

    def variant(t):
        if t in (fs.FUNC_AND, fs.FUNC_AND_CATEGORICAL, fs.FUNC_IMPLY_NATURAL):
            return (nlit == n).to(f32)
        if t == fs.FUNC_OR:
            return (nlit > 0).to(f32)
        if t == fs.FUNC_EQUAL:
            return ((nlit == 0) | (nlit == n)).to(f32)
        if t == fs.FUNC_ISTRUE:
            return head.to(f32)
        if t == fs.FUNC_IMPLY_MLN:
            return torch.where(nbody < n_body, 1.0, head.to(f32))
        # LINEAR family: count of satisfied body implications (b_i => head)
        lin = torch.where(head, n_body, n_body - nbody).to(f32)
        lin = torch.where(n == 1, head.to(f32), lin)
        if t == fs.FUNC_LINEAR:
            return lin
        if t == fs.FUNC_RATIO:
            return torch.log1p(lin)
        if t == fs.FUNC_LOGICAL:
            return (lin > 0).to(f32)
        raise ValueError(f"unknown factor function type {t}")

    present = tuple(present)
    if len(present) == 1:
        return variant(present[0])
    out = torch.zeros((), dtype=f32, device=nlit.device)
    for t in reversed(present):             # the first match wins
        out = torch.where(f_type == t, variant(t), out)
    return out


def _eval_phi_ax2(lits, mask, f_type, f_arity, present, hmask=None):
    """φ with the arity axis at -2 (chain axis trailing).

    lits [.., A, NC] bool; mask broadcastable to lits; f_type / f_arity
    of rank lits.ndim - 1 (every lits axis but A, with broadcast-1 dims
    where needed, e.g. [F, 1] for lits [F, A, NC]).  ``hmask``, bool
    broadcastable to lits, marks the head slot; it is needed where the A
    axis is permuted own-last (the cs streams).  None takes slot
    arity - 1, the factor records' order.  Returns float32 [.., NC]."""
    lits = lits & mask
    nlit = lits.sum(dim=-2, dtype=torch.int32)
    head = None
    if _need_head(present):
        if hmask is None:
            iota_a = torch.arange(lits.shape[-2],
                                  device=lits.device)[:, None]
            hmask = iota_a == (f_arity.to(torch.int64) - 1)[..., None]
        head = (lits & hmask).any(dim=-2)
    return _phi_from_counts(nlit, head, f_arity.to(torch.int32), f_type,
                            present)


def _factor_phis_mc(dg, values, present) -> torch.Tensor:
    """φ float32 [F', NC] of every factor in every chain of ``values``
    [P, NC] (``present`` None: every factor type)."""
    f_vids, f_ispos, f_eqpred, f_mask = factor_records(dg)
    NC = values.shape[-1]
    vals = values.index_select(0, f_vids.reshape(-1)) \
        .reshape(f_vids.shape + (NC,))
    eq = f_eqpred[..., None].to(values.dtype)
    lits = (vals == eq) == f_ispos[..., None]
    return _eval_phi_ax2(lits, f_mask[..., None], dg.f_type[:, None],
                         dg.f_arity[:, None],
                         fs.ALL_FACTOR_FUNCS if present is None else present)


def eval_phi(lits, mask, f_type, f_arity, present=None) -> torch.Tensor:
    """φ float32 [...] for a batch of factors: ``_eval_phi_ax2`` with a
    chain axis of 1.

    lits [..., A] bool per-edge literals (padded slots arbitrary), mask
    [..., A] bool (True on real edges), f_type and f_arity [...] (the
    factor-function enum and the true arity), ``present`` the factor types
    to specialize to (None: all of them)."""
    present = tuple(fs.ALL_FACTOR_FUNCS if present is None else present)
    return _eval_phi_ax2(lits[..., None], mask[..., None], f_type[..., None],
                         f_arity[..., None], present)[..., 0]


def factor_phis(dg, values, present=None) -> torch.Tensor:
    """φ float32 [F'] of every factor under one full assignment ``values``
    [P] (no substitution; the dummy row's φ is irrelevant, its feature is
    0): ``_factor_phis_mc`` with one chain."""
    return _factor_phis_mc(dg, values[:, None], present)[:, 0]
