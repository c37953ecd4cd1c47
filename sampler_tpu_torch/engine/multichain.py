"""Chains-last multi-chain Gibbs engine on PyTorch (counterpart of
sampler_tpu/engine/multichain.py).

The assignment of all chains is one int8 tensor ``values[P, NC]``: a row
holds one position's value in every chain.  A sweep visits the colors in
order; a color step draws every variable of that color in every chain at
once (chromatic Gibbs) and writes the new values into ``values`` in place.

This port runs marginal inference and weight learning on all-boolean
graphs:

  * affine2 tiers (pairwise boolean, banded) with the fused mode on draw a
    whole color in ``ops.fused.fused_color_draw`` (one CUDA kernel);
  * the other tiers, and every tier with the fused mode off, compute the
    log-odds with ``color_delta_multilin`` (deltam tiers) or
    ``color_delta_bool``, gathering neighbour values with
    ``ops.banded.banded_gather`` (banded tiers) or ``index_select``;
  * ``learn_mc`` runs contrastive SGD over an evidence and a free world of
    NC chains each; its gradient (``mc_weight_gradient_cs``) goes through
    ``ops.grad.grad_pair_tile`` (one CUDA kernel a color) on affine2 tiers
    with the band mode on, and through the chunked cs-stream route
    (``_phi_streams``) elsewhere.

``modes = (band, fused)``, each "cuda" (the kernel), "plain" (its plain
PyTorch version) or "off"; the default is "cuda" on a CUDA device and
"plain" on the CPU, gated by what the compiled graph supports.  What lies
outside the slice (categorical variables, sparse per-combination weights,
hub tiers, multi-window banding, the multilinear and categorical fused
kernels) raises NotImplementedError naming the missing piece.

Randomness comes from one explicit ``torch.Generator`` on the run's device:
the initial worlds, the uniforms of the unfused draw, and two int32 seed
words per (sweep, color, tier) for the fused kernel's counter hash.  In
learning the one generator drives both worlds' sweeps in turn.

Unlike the JAX package, the port runs the chain count it is asked for: the
TPU rounds chains up to its 128 lanes (effective_chains, demote_modes), and
a GPU kernel has no such constraint.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import format_spec as fs
from ..compile import factor_records, resolve_device, tier_geom
from ..ops.banded import banded_gather, banded_gather_plain
from ..ops.fused import (fold_affine, fold_deltam, fused_color_draw,
                         fused_color_draw_plain)
from ..ops.grad import GRAD_W_MAX, grad_pair_tile, grad_pair_tile_plain
from ..ops.weights import expand_wf, segment_reduce
from .learn import apply_update

MECHANISMS = ("cuda", "plain", "off")


def resolve_modes(info, device) -> tuple:
    """Default (band, fused) mechanisms for this graph on ``device``."""
    mech = "cuda" if torch.device(device).type == "cuda" else "plain"
    band = mech if info.band_w > 0 else "off"
    fused = band if info.affine2 else "off"
    return band, fused


def check_modes(modes, device) -> tuple:
    modes = tuple(modes)
    if len(modes) != 2 or any(m not in MECHANISMS for m in modes):
        raise ValueError(f"modes must be two of {MECHANISMS}, got {modes}")
    if "cuda" in modes and torch.device(device).type != "cuda":
        raise ValueError(f"mode 'cuda' needs a CUDA device, not {device}")
    return modes


def tier_modes(ti, modes) -> tuple:
    """Per-tier gating: a tier without a banding plan gathers with
    index_select; a tier without a fused plan never routes to a fused
    kernel."""
    band, fused = modes
    if ti.band_w <= 0:
        band = "off"
    if not (ti.affine2 or ti.affinek or ti.fusedm):
        fused = "off"
    return band, fused


def check_slice(info, modes) -> None:
    """Raise NotImplementedError for what this port does not run yet."""
    if info.has_sparse_cw:
        raise NotImplementedError(
            "sparse per-combination weights (color_logits_mc's sparse "
            "branch) are not ported yet")
    if not info.all_boolean or info.max_card > 2:
        raise NotImplementedError(
            "categorical variables (color_logits_mc, and the fused_cat_draw "
            "kernel) are not ported yet")
    if info.has_hub:
        raise NotImplementedError("the hub tier (hub_color_draw) is not "
                                  "ported yet")
    for ti in info.tiers:
        band, fused = tier_modes(ti, modes)
        if band != "off" and ti.band_k >= 2:
            raise NotImplementedError(
                "multi-window banded gather (banded_gather_pallas_multi) is "
                "not ported yet; pass modes with band 'off'")
        if fused != "off" and (ti.fusedm or ti.affinek):
            raise NotImplementedError(
                "the fused_dm_draw / fused_cat_draw kernels are not ported "
                "yet; pass modes with fused 'off'")


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None
                                          or t.device.index == dev.index)


def _setup(dg, values, weights, device, info, modes) -> tuple:
    """Resolve and check the device, the modes and the weights of a run."""
    dev = resolve_device(device)
    for name, t in (("graph", dg.var_card), ("values", values)):
        if t is not None and not _on(t, dev):
            raise ValueError(f"{name} is on {t.device}, the run on {dev}: "
                             "move the graph with to_device(dg, device)")
    modes = check_modes(resolve_modes(info, dev) if modes is None else modes,
                        dev)
    check_slice(info, modes)
    w = torch.as_tensor(weights, dtype=torch.float32).to(dg.var_card.device)
    return modes, w


def init_values_mc(dg, generator, n_chains: int, info,
                   random_init: bool = True) -> torch.Tensor:
    """Initial worlds [P, NC]: evidence at labels, query random per
    chain."""
    P = dg.var_card.shape[0]
    dt = torch.int8                  # boolean worlds (check_slice)
    base = dg.var_init.to(dt)[:, None].expand(P, n_chains)
    if not random_init:
        return base.contiguous()
    r = torch.randint(0, 1 << 30, (P, n_chains), generator=generator,
                      device=dg.var_card.device, dtype=torch.int32)
    rand_vals = (r % dg.var_card.clamp(min=1)[:, None]).to(dt)
    return torch.where((dg.var_role == 0)[:, None], rand_vals, base)


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
    for t in reversed(present):
        out = torch.where(f_type == t, variant(t), out)
    return out


def _eval_phi_ax2(lits, mask, f_type, f_arity, present):
    """φ with the arity axis at -2 (chain axis trailing).

    lits [.., A, NC] bool; mask broadcastable to lits; f_type / f_arity
    of rank lits.ndim - 1 (every lits axis but A, with broadcast-1 dims
    where needed, e.g. [F, 1] for lits [F, A, NC]); the head literal is
    slot arity - 1.  Returns float32 [.., NC]."""
    lits = lits & mask
    nlit = lits.sum(dim=-2, dtype=torch.int32)
    head = None
    if _need_head(present):
        iota_a = torch.arange(lits.shape[-2], device=lits.device)[:, None]
        hmask = iota_a == (f_arity.to(torch.int64) - 1)[..., None]
        head = (lits & hmask).any(dim=-2)
    return _phi_from_counts(nlit, head, f_arity.to(torch.int32), f_type,
                            present)


def _tc(arr: torch.Tensor, c: int, shape) -> torch.Tensor:
    """Color-``c`` slice of a flat tier stream (compile.to_device) in its
    logical ``shape``."""
    n = 1
    for s in shape:
        n *= s
    return arr[c * n:(c + 1) * n].view(shape)


def _gather_nbr(ts, ti, values, nbr, c, modes, r0: int = 0) -> torch.Tensor:
    """values at the [B, D, A1] neighbour positions ``nbr`` of color c,
    rows ``r0 ..`` of the tier: the banded gather on banded tiers,
    index_select elsewhere."""
    B, D, A1 = nbr.shape
    NC = values.shape[-1]
    band = tier_modes(ti, modes)[0]
    if band == "off":
        vals = values.index_select(0, nbr.reshape(-1))
    else:
        gather = banded_gather if band == "cuda" else banded_gather_plain
        t0, ntiles = r0 // ti.band_tb, B // ti.band_tb
        vals = gather(values, nbr.reshape(ntiles, ti.band_tb * D * A1),
                      ts.bd_start[c, t0:t0 + ntiles], ti.band_w)
    return vals.reshape(B, D, A1, NC)


def _nbr_lits(ts, ti, values, c, info, modes):
    """Gather + literal-ize the NEIGHBOR slots of boolean tier ``ts``,
    color ``c``: (nbr_lit [B, D, A-1, NC] bool, pos [B, D, A]).  Only the
    leading A-1 (own-last-permuted) slots are gathered: the own slots'
    literals come from the candidate."""
    B, D, A = tier_geom(ts, ti, info.n_colors)
    A1 = A - 1
    pos = _tc(ts.cs_pos, c, (B, D, A))
    if A1 == 0:                       # unary-only tier: nothing to gather
        return (torch.zeros((B, D, 0, values.shape[-1]), dtype=torch.bool,
                            device=values.device), pos)
    vals = _gather_nbr(ts, ti, values, _tc(ts.cs_nbr, c, (B, D, A1)), c,
                       modes)
    return (vals == 1) == pos[..., :A1, None], pos


def color_delta_bool(ts, ti, values, weights, c, info, modes=("off", "off")):
    """Boolean path: logit(v=1) − logit(v=0), [B, NC], from literal counts.

    The candidate's contribution at its own slots reduces to compile-time
    literal counts (k=1 → own literal == ispos; k=0 → == ¬ispos), so
    φ(1) − φ(0) needs one [B, D, NC] evaluation."""
    B, D, A = tier_geom(ts, ti, info.n_colors)
    nbr_lit, pos = _nbr_lits(ts, ti, values, c, info, modes)
    msk = _tc(ts.cs_mask, c, (B, D, A))
    ismine = _tc(ts.cs_ismine, c, (B, D, A))
    A1 = nbr_lit.shape[-2]
    present = ti.present_funcs or info.present_funcs

    nbrm = (msk & ~ismine)[..., :A1, None]
    nl = (nbr_lit & nbrm).sum(dim=-2, dtype=torch.int32)        # [B, D, NC]
    ownm = ismine & msk
    o1 = (ownm & pos).sum(dim=-1, dtype=torch.int32)[..., None]  # [B, D, 1]
    o0 = ownm.sum(dim=-1, dtype=torch.int32)[..., None] - o1
    n = _tc(ts.cs_arity, c, (B, D)).to(torch.int32)[..., None]

    if _need_head(present):
        hmask = _tc(ts.cs_hmask, c, (B, D, A))
        head_own = (hmask & ismine).any(dim=-1)[..., None]
        headpos = (hmask & ismine & pos).any(dim=-1)[..., None]
        hl = (nbr_lit & (hmask & ~ismine)[..., :A1, None]).any(dim=-2)
        head1 = torch.where(head_own, headpos, hl)
        head0 = torch.where(head_own, ~headpos, hl)
    else:
        head1 = head0 = None

    f_type = _tc(ts.cs_type, c, (B, D))[..., None]
    phi1 = _phi_from_counts(nl + o1, head1, n, f_type, present)
    phi0 = _phi_from_counts(nl + o0, head0, n, f_type, present)
    wf = expand_wf(weights, _tc(ts.cs_wid, c, (B, D)),
                   _tc(ts.cs_feat, c, (B, D)))[..., None]
    return (wf * (phi1 - phi0)).sum(dim=1)                      # [B, NC]


def color_delta_multilin(ts, ti, values, c, info, folded_t, modes):
    """Boolean log-odds from the compile-time multilinear φ fold:
    delta[b] = base[b] + Σ_d (b1·n1 + b2·n2 + bx·n1·n2), with
    (base, b1, b2, bx) = fold_deltam's weight-scaled streams.  Exact in
    exact arithmetic; differs from color_delta_bool only in rounding."""
    B, D, A = tier_geom(ts, ti, info.n_colors)
    A1 = A - 1
    base_f, b1_f, b2_f, bx_f = folded_t
    vals = _gather_nbr(ts, ti, values, _tc(ts.cs_nbr, c, (B, D, A1)), c,
                       modes)
    f32 = torch.float32
    base = _tc(base_f, c, (B,))[:, None]
    n1 = vals[:, :, 0, :].to(f32)
    contrib = _tc(b1_f, c, (B, D))[..., None] * n1
    if A1 >= 2 and b2_f is not None:
        n2 = vals[:, :, 1, :].to(f32)
        contrib = (contrib + _tc(b2_f, c, (B, D))[..., None] * n2
                   + _tc(bx_f, c, (B, D))[..., None] * (n1 * n2))
    return base + contrib.sum(dim=1)                            # [B, NC]


def prepare_fold(dg, weights, info, modes):
    """Per-tier folded coefficient streams (None for tiers no folded path
    covers), or None when nothing folds: fold_affine for affine2 tiers with
    the fused mode on, fold_deltam for the other deltam tiers.  Called once
    per weights value, outside the sweep loop."""
    use_fused = modes[1] != "off" and info.affine2
    if not (use_fused or any(ti.deltam for ti in info.tiers)):
        return None
    w = weights.to(torch.float32)
    C = info.n_colors

    def fold_one(ts, ti):
        if ti.affine2 and use_fused:
            return fold_affine(ts, ti, C, w)
        if ti.deltam:
            return fold_deltam(ts, ti, C, w)
        return None

    return tuple(fold_one(ts, ti) for ts, ti in zip(dg.tiers, info.tiers))


def color_draw_tier(dg, ts, ti, values, weights, generator, c, info,
                    folded_t=None, modes=("off", "off")) -> torch.Tensor:
    """Draw new values [B_t, NC] for one tier of color ``c``."""
    if ti.hub:
        raise NotImplementedError("the hub tier (hub_color_draw) is not "
                                  "ported yet")
    if folded_t is not None and tier_modes(ti, modes)[1] != "off":
        if not ti.affine2:
            raise NotImplementedError(
                "the fused_dm_draw / fused_cat_draw kernels are not ported "
                "yet")
        seed = torch.randint(-(1 << 31), 1 << 31, (2,), generator=generator,
                             device=values.device, dtype=torch.int32)
        draw = fused_color_draw if modes[1] == "cuda" \
            else fused_color_draw_plain
        return draw(values, ts.bd_nbr, ts.bd_start[c], folded_t[0],
                    folded_t[1], c, seed, ti.band_w, ti.band_tb, ti.degree)
    if not (info.all_boolean and info.max_card == 2):
        raise NotImplementedError("categorical variables (color_logits_mc) "
                                  "are not ported yet")
    if ti.deltam and folded_t is not None:
        delta = color_delta_multilin(ts, ti, values, c, info, folded_t,
                                     modes)
    else:
        delta = color_delta_bool(ts, ti, values, weights, c, info, modes)
    u = torch.rand(delta.shape, generator=generator, device=delta.device,
                   dtype=delta.dtype)
    return (u < torch.sigmoid(delta)).to(values.dtype)


def color_step_mc(dg, values, weights, generator, c, sample_evidence: bool,
                  info, folded=None, modes=("off", "off")) -> torch.Tensor:
    """Resample color ``c`` in all chains, writing into ``values`` in place
    (tiers of one color share no factor, so tier by tier is the
    simultaneous block update); returns ``values``."""
    B = info.block_size
    if folded is None:
        folded = (None,) * len(dg.tiers)
    for t, (ts, ti) in enumerate(zip(dg.tiers, info.tiers)):
        drawn = color_draw_tier(dg, ts, ti, values, weights, generator, c,
                                info, folded[t], modes)
        resample = (ts.cm_resample_ev[c] if sample_evidence
                    else ts.cm_resample[c])
        start = c * B + ti.off
        old = values[start:start + ti.block]
        old.copy_(torch.where(resample[:, None], drawn, old))
    return values


def sweep_mc(dg, values, weights, generator, sample_evidence: bool, info,
             folded=None, modes=("off", "off")) -> torch.Tensor:
    """One sweep over the colors, in place; returns ``values``."""
    for c in range(info.n_colors):
        color_step_mc(dg, values, weights, generator, c, sample_evidence,
                      info, folded, modes)
    return values


def run_sweeps_mc(dg, values, weights, generator, n_sweeps: int,
                  sample_evidence: bool, info, modes=None,
                  device="cuda") -> torch.Tensor:
    """``n_sweeps`` sweeps from ``values`` (not modified); returns the new
    worlds [P, NC]."""
    modes, w = _setup(dg, values, weights, device, info, modes)
    values = values.clone()
    folded = prepare_fold(dg, w, info, modes)
    for _ in range(n_sweeps):
        sweep_mc(dg, values, w, generator, sample_evidence, info, folded,
                 modes)
    return values


def run_inference_mc(dg, values, weights, generator, n_sweeps: int,
                     sample_evidence: bool, info, modes=None,
                     device="cuda") -> tuple:
    """Returns (values [P, NC], counts int32 flat [K*P] = row-major [K, P],
    pooled over chains and sweeps).  ``values`` is not modified."""
    modes, w = _setup(dg, values, weights, device, info, modes)
    values = values.clone()
    K = info.max_card
    counts = torch.zeros((K, values.shape[0]), dtype=torch.int32,
                         device=values.device)
    folded = prepare_fold(dg, w, info, modes)
    for _ in range(n_sweeps):
        sweep_mc(dg, values, w, generator, sample_evidence, info, folded,
                 modes)
        for k in range(K):
            counts[k] += (values == k).sum(dim=1, dtype=torch.int32)
    return values, counts.reshape(-1)


def infer_mc(dg, weights, generator, n_burn: int, n_sweeps: int, info,
             n_chains: int, sample_evidence: bool = False,
             random_init: bool = True, modes=None, device="cuda") -> tuple:
    """Chains-last inference; returns (marginals [V, K] float32 numpy,
    values [P, NC]).

    ``dg`` comes from ``to_device(dg, device)`` and ``generator`` is a
    torch.Generator on ``device``.  With the default ``device="cuda"`` and
    no card present this raises; pass ``device="cpu"`` for the plain
    versions."""
    modes, w = _setup(dg, None, weights, device, info, modes)
    values = init_values_mc(dg, generator, n_chains, info, random_init)
    if n_burn:
        values = run_sweeps_mc(dg, values, w, generator, n_burn,
                               sample_evidence, info, modes, device)
    values, counts = run_inference_mc(dg, values, w, generator, n_sweeps,
                                      sample_evidence, info, modes, device)
    K = info.max_card
    cnt = counts.cpu().numpy().reshape(K, -1).T
    marg = cnt[dg.pos_of_vid.cpu().numpy()].astype(np.float32) \
        / np.float32(n_sweeps * n_chains)
    return marg, values


# --------------------------------------------------------------------------
# weight learning
# --------------------------------------------------------------------------

def mc_factor_phis(dg, values, info) -> torch.Tensor:
    """φ for every factor in every chain: [F', NC] (values [P, NC])."""
    f_vids, f_ispos, f_eqpred, f_mask = factor_records(dg)
    NC = values.shape[-1]
    vals = values.index_select(0, f_vids.reshape(-1)) \
        .reshape(f_vids.shape + (NC,))
    eq = f_eqpred[..., None].to(values.dtype)
    lits = (vals == eq) == f_ispos[..., None]
    return _eval_phi_ax2(lits, f_mask[..., None], dg.f_type[:, None],
                         dg.f_arity[:, None], info.present_funcs)


def _mc_weight_gradient_factors(dg, v_ev, v_free, learn_non_evidence: bool,
                                info) -> torch.Tensor:
    """Weight gradient [W] averaged over the chain axis of [P, NC] worlds,
    factor by factor: the reference the cs-stream routes are held to."""
    if info.has_sparse_cw:
        raise NotImplementedError(
            "the gradient of sparse per-combination weights "
            "(sparse_comb_wids) is not ported yet")
    diff = dg.f_feat[:, None] * (mc_factor_phis(dg, v_ev, info)
                                 - mc_factor_phis(dg, v_free, info))
    if not learn_non_evidence:
        f_vids, _, _, f_mask = factor_records(dg)
        role = dg.var_role.index_select(0, f_vids.reshape(-1)) \
            .reshape(f_vids.shape)
        touches_ev = ((role == fs.ROLE_EVIDENCE) & f_mask).any(dim=-1)
        diff = torch.where(touches_ev[:, None], diff, 0.0)
    return segment_reduce(diff.mean(dim=1), dg.f_wid, dg.w_init.shape[0])


def _phi_streams(values, ownv, ts, ti, c, r0, rc, present, modes):
    """φ [rc, D, NC] of rows ``r0 .. r0+rc`` of one boolean tier's color
    ``c`` at the current ``values``, with the variable's own value
    ``ownv`` [rc, NC] as the candidate.  Neighbour values come through the
    same gather as the draw (``_gather_nbr``).  Counts-based: the slot axis
    is reduced at once, so no [rc, D, A, NC] literal tensor is made."""
    C = ts.bd_start.shape[0]
    _, D, A = tier_geom(ts, ti, C)
    A1 = A - 1
    NC = values.shape[-1]

    def rows(arr, *tail):
        n = 1
        for x in tail:
            n *= x
        B = arr.numel() // (C * n)
        base = (c * B + r0) * n
        return arr[base:base + rc * n].view((rc,) + tail)

    pos = rows(ts.cs_pos, D, A)
    ismine = rows(ts.cs_ismine, D, A)
    msk = rows(ts.cs_mask, D, A)
    hmask = rows(ts.cs_hmask, D, A)
    if A1 > 0:
        vals = _gather_nbr(ts, ti, values, rows(ts.cs_nbr, D, A1), c, modes,
                           r0)
        nbr_lit = (vals == 1) == pos[..., :A1, None]
        nbrm = (msk & ~ismine)[..., :A1, None]
        nl = (nbr_lit & nbrm).sum(dim=-2, dtype=torch.int32)
    else:
        nbr_lit = None
        nl = torch.zeros((rc, D, NC), dtype=torch.int32, device=values.device)
    ownm = ismine & msk
    o1 = (ownm & pos).sum(dim=-1, dtype=torch.int32)            # [rc, D]
    o0 = ownm.sum(dim=-1, dtype=torch.int32) - o1
    v1 = (ownv == 1)[:, None, :]                                # [rc, 1, NC]
    nown = torch.where(v1, o1[..., None], o0[..., None])
    head = None
    if _need_head(present):
        head_own = (hmask & ismine).any(dim=-1)[..., None]
        headpos = (hmask & ismine & pos).any(dim=-1)[..., None]
        if nbr_lit is not None:
            hl = (nbr_lit & (hmask & ~ismine)[..., :A1, None]).any(dim=-2)
        else:
            hl = torch.zeros(nl.shape, dtype=torch.bool, device=nl.device)
        head = torch.where(head_own, torch.where(v1, headpos, ~headpos), hl)
    n = rows(ts.cs_arity, D).to(torch.int32)[..., None]
    typ = rows(ts.cs_type, D)[..., None]
    return _phi_from_counts(nl + nown, head, n, typ, present)


def _grad_row_chunk(ti, B: int, D: int, A: int, NC: int) -> int:
    """Rows per gradient sub-block: bounds the [rows, D, A, NC]
    temporaries to ~64 Mi elements however large the color block is.
    Banded gathers need the chunk tile-aligned."""
    target = 1 << 26
    step = ti.band_tb if ti.band_w else 1
    rc = max(1, target // max(D * A * NC, 1))
    rc = min(max(step, (rc // step) * step), B)
    while rc > step and B % rc:
        rc -= step
    return rc if rc > 0 and B % rc == 0 else B


def mc_weight_gradient_cs(dg, v_ev, v_free, learn_non_evidence: bool, info,
                          modes=("off", "off"),
                          row_chunk: int | None = None) -> torch.Tensor:
    """Weight gradient [W] on the cs streams: each factor counted once via
    its compile-time owner record (cs_gowner, or cs_gtouch unless
    ``learn_non_evidence``), averaged over the NC chains.

    An affine2 tier with W <= GRAD_W_MAX and its band mode on ("cuda" or
    "plain") and no ``row_chunk`` goes through ``grad_pair_tile`` (the
    kernel, or its plain version), one call a color.  Every other tier
    runs the chunked route: both worlds side by side on the chain axis,
    rows in chunks of ``row_chunk`` (default ``_grad_row_chunk``), φ from
    ``_phi_streams`` and a segment sum per weight."""
    check_slice(info, modes)
    W = dg.w_init.shape[0]
    NC = v_ev.shape[-1]
    gB = info.block_size
    C = info.n_colors
    grad = torch.zeros(W, dtype=torch.float32, device=v_ev.device)
    v_both = None
    for ts, ti in zip(dg.tiers, info.tiers):
        Bl, D, A = tier_geom(ts, ti, C)
        band = tier_modes(ti, modes)[0]
        if (ti.affine2 and W <= GRAD_W_MAX and band != "off"
                and row_chunk is None):
            kernel = grad_pair_tile if band == "cuda" else grad_pair_tile_plain
            coef = ts.gd_cown if learn_non_evidence else ts.gd_ctch
            for c in range(C):
                parts = kernel(v_ev, v_free, ts.bd_nbr, ts.bd_start[c],
                               ts.gd_wid, coef, ts.gd_ao, ts.gd_an,
                               ts.gd_ax, c, c * gB + ti.off, ti.band_w,
                               ti.band_tb, D, W)
                grad = grad + (parts.sum(dim=0, dtype=torch.float64)
                               / NC).to(torch.float32)
            continue
        if v_both is None:
            # one gather a chunk serves both worlds
            v_both = torch.cat([v_ev, v_free], dim=-1)
        rc = min(row_chunk or _grad_row_chunk(ti, Bl, D, A, 2 * NC), Bl)
        if Bl % rc or (ti.band_w and band != "off" and rc % ti.band_tb):
            raise ValueError(f"row_chunk {rc} must divide tier block {Bl}"
                             " (and be a multiple of its band tile)")
        present = ti.present_funcs or info.present_funcs
        gsrc = ts.cs_gowner if learn_non_evidence else ts.cs_gtouch
        for c in range(C):
            for r0 in range(0, Bl, rc):
                start = c * gB + ti.off + r0
                phi = _phi_streams(v_both, v_both[start:start + rc], ts, ti,
                                   c, r0, rc, present, modes)
                sl = slice((c * Bl + r0) * D, (c * Bl + r0 + rc) * D)
                diff = (phi[..., :NC] - phi[..., NC:]).mean(dim=-1) \
                    * ts.cs_feat[sl].view(rc, D)
                diff = torch.where(gsrc[sl].view(rc, D), diff, 0.0)
                grad = grad + segment_reduce(diff, ts.cs_wid[sl], W)
    return grad


def mc_weight_gradient(dg, v_ev, v_free, learn_non_evidence: bool, info,
                       modes=None) -> torch.Tensor:
    """The cs-stream gradient when modes are given; the per-factor route
    (the modes-free reference) when they are None."""
    if modes is not None:
        return mc_weight_gradient_cs(dg, v_ev, v_free, learn_non_evidence,
                                     info, modes)
    return _mc_weight_gradient_factors(dg, v_ev, v_free, learn_non_evidence,
                                       info)


def _learn_mc_from(dg, weights, v_ev, v_free, alpha, generator, cfg, info,
                   modes=None, device="cuda") -> tuple:
    """Multi-chain contrastive SGD from explicit worlds and step size: per
    epoch the weights are refolded, both worlds take
    ``cfg.n_sweeps_per_epoch`` sweeps in turn (the evidence world with
    evidence clamped, the free world with none), and the chain-averaged
    gradient updates the weights.  ``v_ev`` and ``v_free`` are not
    modified.  Returns (weights, v_ev, v_free, alpha), so a run resumes at
    epoch granularity by passing the last three back in with the same
    generator."""
    modes, w = _setup(dg, v_ev, weights, device, info, modes)
    if not _on(v_free, v_ev.device):
        raise ValueError(f"v_free is on {v_free.device}, v_ev on "
                         f"{v_ev.device}")
    v_ev, v_free = v_ev.clone(), v_free.clone()
    alpha = np.float32(alpha)
    diminish = np.float32(cfg.diminish)
    for _ in range(cfg.n_epochs):
        folded = prepare_fold(dg, w, info, modes)
        for _ in range(cfg.n_sweeps_per_epoch):
            sweep_mc(dg, v_ev, w, generator, False, info, folded, modes)
            sweep_mc(dg, v_free, w, generator, True, info, folded, modes)
        grad = mc_weight_gradient(dg, v_ev, v_free, cfg.learn_non_evidence,
                                  info, modes)
        w = apply_update(w, grad, dg.w_fixed, float(alpha),
                         cfg.regularization, cfg.reg_param)
        alpha = alpha * diminish
    return w, v_ev, v_free, float(alpha)


def learn_mc(dg, weights, generator, cfg, info, n_chains: int, modes=None,
             v_ev=None, v_free=None, alpha=None, device="cuda") -> tuple:
    """Multi-chain learning; returns (weights [W] float32, v_ev, v_free).

    Fresh worlds of ``n_chains`` chains come from ``generator`` (evidence
    world first); pass (v_ev, v_free, alpha) to continue a checkpointed
    run instead.  With the default ``device="cuda"`` and no card present
    this raises; pass ``device="cpu"`` for the plain versions."""
    modes = _setup(dg, v_ev, weights, device, info, modes)[0]
    if v_ev is None:
        v_ev = init_values_mc(dg, generator, n_chains, info)
    if v_free is None:
        v_free = init_values_mc(dg, generator, n_chains, info)
    if alpha is None:
        alpha = cfg.stepsize
    w, v_ev, v_free, _ = _learn_mc_from(dg, weights, v_ev, v_free, alpha,
                                        generator, cfg, info, modes, device)
    return w, v_ev, v_free
