"""Chains-last multi-chain Gibbs engine on PyTorch (counterpart of
sampler_tpu/engine/multichain.py).

The assignment of all chains is one int8 tensor ``values[P, NC]``: a row
holds one position's value in every chain.  A sweep visits the colors in
order; a color step draws every variable of that color in every chain at
once (chromatic Gibbs) and writes the new values into ``values`` in place.

This slice runs marginal inference on all-boolean graphs:

  * affine2 tiers (pairwise boolean, banded) with the fused mode on draw a
    whole color in ``ops.fused.fused_color_draw`` (one CUDA kernel);
  * the other tiers, and every tier with the fused mode off, compute the
    log-odds with ``color_delta_multilin`` (deltam tiers) or
    ``color_delta_bool``, gathering neighbour values with
    ``ops.banded.banded_gather`` (banded tiers) or ``index_select``.

``modes = (band, fused)``, each "cuda" (the kernel), "plain" (its plain
PyTorch version) or "off"; the default is "cuda" on a CUDA device and
"plain" on the CPU, gated by what the compiled graph supports.  What lies
outside the slice (categorical variables, sparse per-combination weights,
hub tiers, multi-window banding, the multilinear and categorical fused
kernels) raises NotImplementedError naming the missing piece.

Randomness comes from one explicit ``torch.Generator`` on the run's device:
the initial worlds, the uniforms of the unfused draw, and two int32 seed
words per (sweep, color, tier) for the fused kernel's counter hash.

Unlike the JAX package, the port runs the chain count it is asked for: the
TPU rounds chains up to its 128 lanes (effective_chains, demote_modes), and
a GPU kernel has no such constraint.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import format_spec as fs
from ..compile import resolve_device, tier_geom
from ..ops.banded import banded_gather, banded_gather_plain
from ..ops.fused import (fold_affine, fold_deltam, fused_color_draw,
                         fused_color_draw_plain)
from ..ops.weights import expand_wf

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


def _tc(arr: torch.Tensor, c: int, shape) -> torch.Tensor:
    """Color-``c`` slice of a flat tier stream (compile.to_device) in its
    logical ``shape``."""
    n = 1
    for s in shape:
        n *= s
    return arr[c * n:(c + 1) * n].view(shape)


def _gather_nbr(ts, ti, values, nbr, c, modes) -> torch.Tensor:
    """values at the [B, D, A1] neighbour positions ``nbr`` of color c:
    the banded gather on banded tiers, index_select elsewhere."""
    B, D, A1 = nbr.shape
    NC = values.shape[-1]
    band = tier_modes(ti, modes)[0]
    if band == "off":
        vals = values.index_select(0, nbr.reshape(-1))
    else:
        gather = banded_gather if band == "cuda" else banded_gather_plain
        ntiles = B // ti.band_tb
        vals = gather(values, nbr.reshape(ntiles, ti.band_tb * D * A1),
                      ts.bd_start[c], ti.band_w)
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
