"""Chains-last multi-chain Gibbs engine on PyTorch (counterpart of
sampler_tpu/engine/multichain.py).

The assignment of all chains is one tensor ``values[P, NC]`` (int8 while
every cardinality is at most 127, else int32: ``values_dtype``): a row
holds one position's value in every chain.  A sweep visits the colors in
order; a color step draws every variable of that color in every chain at
once (chromatic Gibbs) and writes the new values into ``values`` in place.

This port runs marginal inference and weight learning on boolean,
categorical and mixed graphs with dense weights, single-window and
multi-window banded alike, hub tiers included:

  * affine2 tiers (pairwise boolean, one window a tile) with the fused
    mode on draw a whole color in ``ops.fused.fused_color_draw`` (one CUDA
    kernel);
  * fusedm tiers (banded boolean of arity <= 3 that affine2 does not
    take: arity 3, or band_k >= 2 windows a tile, as on any graph of more
    than 2 colors) with the fused mode on draw a whole color in
    ``ops.fused.fused_dm_draw`` (one CUDA kernel);
  * affinek tiers (categorical or mixed, arity <= 2, one own slot a
    factor, one window a tile, 2 <= K <= 32) with the fused mode on draw a
    whole color in ``ops.fused.fused_cat_draw`` (one CUDA kernel);
  * the other tiers, and every tier with the fused mode off, compute the
    log-odds with ``color_delta_multilin`` (deltam tiers) or
    ``color_delta_bool`` on all-boolean graphs, and the K candidates'
    log-potentials with ``color_logits_mc`` (a Gumbel-argmax draw, a block
    of rows at a time) on the others, gathering neighbour values with
    ``ops.banded.banded_gather`` (band_k 1), ``banded_gather_multi``
    (band_k >= 2) or ``index_select`` (band off);
  * a hub tier (the variables of more than ``hub_cap`` factors) draws in
    ``hub_color_draw``: its chunks of records are evaluated like rows of a
    dense tier, and their deltas or logits summed onto their rows with
    ``index_add_``;
  * the tallies of inference go through ``ops.tally.tally_counts`` (one
    CUDA kernel a sweep);
  * ``learn_mc`` runs contrastive SGD over an evidence and a free world of
    NC chains each; its gradient (``mc_weight_gradient_cs``) goes through
    ``ops.grad.grad_pair_tile`` (one CUDA kernel a color) on affine2 tiers
    with the band mode on, and through the chunked cs-stream route
    (``_phi_streams``, with the same gathers as the draw) elsewhere.

``modes = (band, fused)``, each "cuda" (the kernel), "plain" (its plain
PyTorch version) or "off"; the default is "cuda" on a CUDA device and
"plain" on the CPU, gated by what the compiled graph supports, as the JAX
package's resolve_band / resolve_fused gate them.  What lies outside the
slice (sparse per-combination weights) raises NotImplementedError naming
the missing piece.  The fused draws write straight into the world's block
(their world-write mode); the other tiers draw a block and write it under
the resample mask.

Randomness comes from one explicit ``torch.Generator`` on the run's device:
the initial worlds, the uniforms and Gumbel noise of the unfused draws, and
two int32 seed words per (sweep, color, tier) for the fused kernels'
counter hash.  In learning the one generator drives both worlds' sweeps in
turn.

Unlike the JAX package, the port runs the chain count it is asked for: the
TPU rounds chains up to its 128 lanes (effective_chains, demote_modes), and
a GPU kernel has no such constraint.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import format_spec as fs
from ..compile import factor_records, resolve_device, tier_geom
from ..ops.banded import (banded_gather, banded_gather_multi,
                          banded_gather_multi_plain, banded_gather_plain)
from ..ops.fused import (fold_affine, fold_affine_cat, fold_deltam,
                         fold_deltam_tiles, fused_cat_draw,
                         fused_cat_draw_plain, fused_color_draw,
                         fused_color_draw_plain, fused_dm_draw,
                         fused_dm_draw_plain)
from ..ops.grad import GRAD_W_MAX, grad_pair_tile, grad_pair_tile_plain
from ..ops.tally import tally_counts, tally_plain
from ..ops.weights import expand_wf, segment_reduce
from .learn import apply_update

MECHANISMS = ("cuda", "plain", "off")


def values_dtype(info) -> torch.dtype:
    """The worlds' dtype: int8 while every cardinality fits, else int32."""
    return torch.int8 if info.max_card <= 127 else torch.int32


def resolve_modes(info, device) -> tuple:
    """Default (band, fused) mechanisms for this graph on ``device``: band
    on where the graph has a banding plan and int8-sized values, fused
    following band where a tier has a fused plan (JAX resolve_band and
    resolve_fused in their "auto" setting)."""
    mech = "cuda" if torch.device(device).type == "cuda" else "plain"
    band = mech if info.band_w > 0 and info.max_card <= 127 else "off"
    fused = band if (info.affine2 or info.affinek or info.fusedm) else "off"
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


INIT_CHUNK_ELEMS = 1 << 22      # (position, chain) pairs drawn at a time


def init_values_mc(dg, generator, n_chains: int, info,
                   random_init: bool = True) -> torch.Tensor:
    """Initial worlds [P, NC] of ``values_dtype(info)``: evidence at
    labels, query uniform over var_card per chain.  The int32 draws and
    their modulo are made a block of rows at a time into the worlds, so no
    int32 [P, NC] temporary exists beside int8 worlds (the JAX package
    jits its version for the same reason)."""
    P = dg.var_card.shape[0]
    dt = values_dtype(info)
    out = dg.var_init.to(dt)[:, None].expand(P, n_chains).contiguous()
    if not random_init:
        return out
    card = dg.var_card.clamp(min=1)
    query = dg.var_role == 0
    step = max(1, INIT_CHUNK_ELEMS // max(n_chains, 1))
    for r0 in range(0, P, step):
        r1 = min(P, r0 + step)
        r = torch.randint(0, 1 << 30, (r1 - r0, n_chains),
                          generator=generator, device=out.device,
                          dtype=torch.int32)
        rand_vals = (r % card[r0:r1, None]).to(dt)
        blk = out[r0:r1]
        blk.copy_(torch.where(query[r0:r1, None], rand_vals, blk))
    return out


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


def _tc(arr: torch.Tensor, c: int, shape) -> torch.Tensor:
    """Color-``c`` slice of a flat tier stream (compile.to_device) in its
    logical ``shape``."""
    n = 1
    for s in shape:
        n *= s
    return arr[c * n:(c + 1) * n].view(shape)


def _gather_nbr(ts, ti, values, nbr, c, modes, r0: int = 0) -> torch.Tensor:
    """values at the [B, D, A1] neighbour positions ``nbr`` of color c,
    rows ``r0 ..`` of the tier: the banded gather on banded tiers (the
    multi-window one over the remapped bd_rnbr when band_k >= 2),
    index_select elsewhere."""
    B, D, A1 = nbr.shape
    NC = values.shape[-1]
    band = tier_modes(ti, modes)[0]
    if band == "off":
        return values.index_select(0, nbr.reshape(-1)).reshape(B, D, A1, NC)
    t0, ntiles = r0 // ti.band_tb, B // ti.band_tb
    tiles = slice(t0, t0 + ntiles)
    if ti.band_k >= 2:
        gather = (banded_gather_multi if band == "cuda"
                  else banded_gather_multi_plain)
        vals = gather(values, ts.bd_rnbr[c, tiles], ts.bd_start[c, tiles],
                      ti.band_w)
    else:
        gather = banded_gather if band == "cuda" else banded_gather_plain
        vals = gather(values, nbr.reshape(ntiles, ti.band_tb * D * A1),
                      ts.bd_start[c, tiles], ti.band_w)
    return vals.reshape(B, D, A1, NC)


def _nbr_lits(ts, ti, values, c, info, modes, r0: int = 0,
              rc: int | None = None):
    """Gather + literal-ize the NEIGHBOR slots of tier ``ts``, color ``c``,
    rows ``r0 .. r0+rc`` (all rows by default): (nbr_lit [rc, D, A-1, NC]
    bool, pos [rc, D, A], eq [rc, D, A] or None on all-boolean graphs, the
    raw gathered values [rc, D, A-1, NC] or None on unary tiers).  Only
    the leading A-1 (own-last-permuted) slots are gathered: the own slots'
    literals come from the candidate.  A literal is ``value == 1`` on
    all-boolean graphs and ``value == eq`` elsewhere, each compared with
    the slot's sign ``pos``."""
    B, D, A = tier_geom(ts, ti, info.n_colors)
    rc = B - r0 if rc is None else rc
    rows = slice(r0, r0 + rc)
    A1 = A - 1
    pos = _tc(ts.cs_pos, c, (B, D, A))[rows]
    eq = None if info.all_boolean else _tc(ts.cs_eq, c, (B, D, A))[rows]
    if A1 == 0:                       # unary-only tier: nothing to gather
        return (torch.zeros((rc, D, 0, values.shape[-1]), dtype=torch.bool,
                            device=values.device), pos, eq, None)
    vals = _gather_nbr(ts, ti, values, _tc(ts.cs_nbr, c, (B, D, A1))[rows],
                       c, modes, r0)
    if eq is None:
        return (vals == 1) == pos[..., :A1, None], pos, eq, vals
    nbr_lit = (vals == eq[..., :A1, None].to(values.dtype)) \
        == pos[..., :A1, None]
    return nbr_lit, pos, eq, vals


def color_delta_bool(ts, ti, values, weights, c, info, modes=("off", "off")):
    """Boolean path: logit(v=1) − logit(v=0), [B, NC], from literal counts.

    The candidate's contribution at its own slots reduces to compile-time
    literal counts (k=1 → own literal == ispos; k=0 → == ¬ispos), so
    φ(1) − φ(0) needs one [B, D, NC] evaluation."""
    B, D, A = tier_geom(ts, ti, info.n_colors)
    nbr_lit, pos, _, _ = _nbr_lits(ts, ti, values, c, info, modes)
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


def color_logits_mc(dg, ts, ti, values, weights, c, info,
                    modes=("off", "off"), r0: int = 0,
                    rc: int | None = None) -> torch.Tensor:
    """Conditional log-potentials [rc, K, NC] of the candidates
    k = 0 .. K-1 for rows ``r0 .. r0+rc`` (all rows by default) of tier
    ``ts``, color ``c``: Σ_d wf·φ with the candidate at the own slots and
    the gathered neighbour values at the others (dense weights; the
    caller masks k >= card with cm_kmask).  Its [rc, D, K, A, NC] literal
    and [rc, D, K, NC] φ temporaries scale with ``rc``."""
    K = info.max_card
    B, D, A = tier_geom(ts, ti, info.n_colors)
    rc = B - r0 if rc is None else rc
    rows = slice(r0, r0 + rc)
    A1 = A - 1
    NC = values.shape[-1]
    nbr_lit, pos, eq, _ = _nbr_lits(ts, ti, values, c, info, modes, r0, rc)
    ks = torch.arange(K, device=values.device)[None, None, :, None]
    cand = ks == 1 if eq is None else ks == eq[:, :, None, :]
    cand_lit = cand == pos[:, :, None, :]                       # [rc,D,K,A]
    is_mine = _tc(ts.cs_ismine, c, (B, D, A))[rows]
    # candidate at own slots, gathered literal at neighbour slots; slot
    # A-1 is always own (own-last permutation)
    lit_head = torch.where(is_mine[:, :, None, :A1, None],
                           cand_lit[:, :, :, :A1, None],
                           nbr_lit[:, :, None, :, :])
    lit_last = cand_lit[:, :, :, A1:, None].expand(rc, D, K, 1, NC)
    lit_k = torch.cat([lit_head, lit_last], dim=-2)            # [rc,D,K,A,NC]
    present = ti.present_funcs or info.present_funcs
    phi = _eval_phi_ax2(
        lit_k, _tc(ts.cs_mask, c, (B, D, A))[rows][:, :, None, :, None],
        _tc(ts.cs_type, c, (B, D))[rows][:, :, None, None],
        _tc(ts.cs_arity, c, (B, D))[rows][:, :, None, None], present,
        hmask=_tc(ts.cs_hmask, c, (B, D, A))[rows][:, :, None, :, None])
    wf = expand_wf(weights, _tc(ts.cs_wid, c, (B, D))[rows],
                   _tc(ts.cs_feat, c, (B, D))[rows])[:, :, None, None]
    return (wf * phi).sum(dim=1)                                # [rc, K, NC]


def _row_chunk(ti, B: int, D: int, A: int, NC: int) -> int:
    """Rows per sub-block of the chunked gradient and of the unfused
    categorical draw: bounds their [rows, D, A, NC] temporaries (A is K·A
    for the draw's candidates) to ~64 Mi elements however large the color
    block is.  Banded gathers need the chunk tile-aligned."""
    target = 1 << 26
    step = ti.band_tb if ti.band_w else 1
    rc = max(1, target // max(D * A * NC, 1))
    rc = min(max(step, (rc // step) * step), B)
    while rc > step and B % rc:
        rc -= step
    return rc if rc > 0 and B % rc == 0 else B


def _gumbel(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log u) from ``generator``, with u a
    24-bit uniform strictly inside (0, 1), so no log(0) occurs."""
    r = torch.randint(0, 1 << 24, shape, generator=generator, device=device,
                      dtype=torch.int32)
    u = (r.to(torch.float32) + 0.5) * (2.0 ** -24)
    return -torch.log(-torch.log(u))


def color_draw_categorical(dg, ts, ti, values, weights, generator, c, info,
                           modes=("off", "off")) -> torch.Tensor:
    """Unfused categorical draw of one tier, color ``c``: Gumbel-argmax
    over color_logits_mc + cm_kmask, a block of rows at a time so the
    logits' temporaries stay bounded (~64 Mi literals a block)."""
    B, D, A = tier_geom(ts, ti, info.n_colors)
    K = info.max_card
    NC = values.shape[-1]
    kmask = _tc(ts.cm_kmask, c, (B, K))
    out = torch.empty((B, NC), dtype=values.dtype, device=values.device)
    rc = _row_chunk(ti, B, D, K * A, NC)
    for r0 in range(0, B, rc):
        logits = color_logits_mc(dg, ts, ti, values, weights, c, info, modes,
                                 r0, rc) + kmask[r0:r0 + rc, :, None]
        logits += _gumbel(logits.shape, generator, values.device)
        out[r0:r0 + rc] = logits.argmax(dim=1).to(values.dtype)
    return out


def prepare_fold(dg, weights, info, modes):
    """Per-tier folded coefficient streams (None for tiers no folded path
    covers), or None when nothing folds: with the fused mode on,
    fold_affine for affine2 tiers, fold_affine_cat for affinek tiers and
    fold_deltam_tiles (the kernel's tile layout) for fusedm tiers;
    fold_deltam for the other deltam tiers.
    color_draw_tier routes a tier to a fused draw under the same
    condition, so a layout never reaches the wrong path.  Called once per
    weights value, outside the sweep loop."""
    use_fused = modes[1] != "off" and (info.affine2 or info.affinek
                                       or info.fusedm)
    if not (use_fused or any(ti.deltam for ti in info.tiers)):
        return None
    w = weights.to(torch.float32)
    C = info.n_colors

    def fold_one(ts, ti):
        if ti.affine2 and use_fused:
            return fold_affine(ts, ti, C, w)
        if ti.affinek and use_fused:
            return fold_affine_cat(ts, ti, C, w)
        if ti.fusedm and use_fused:
            return fold_deltam_tiles(ts, ti, C, w)
        if ti.deltam:
            return fold_deltam(ts, ti, C, w)
        return None

    return tuple(fold_one(ts, ti) for ts, ti in zip(dg.tiers, info.tiers))


def hub_color_draw(dg, ts, ti, values, weights, generator, c, info,
                   modes=("off", "off"), folded_t=None) -> torch.Tensor:
    """Draw new values [B_t, NC] for a chunked-CSR hub tier of color ``c``:
    its [M, G, A] chunk streams are evaluated with the dense tiers' code (a
    chunk is a row of D = G records), and the chunks' deltas (boolean) or
    logits (categorical) are summed onto their rows with ``index_add_``
    into [B_t + 1, ...]: the pad chunks, whose ``hb_row`` is B_t, land in
    the extra row, which is dropped.  Then the Bernoulli or Gumbel-argmax
    draw, as on the unfused dense tiers."""
    Bh = ti.block
    NC = values.shape[-1]
    dev = values.device
    row = ts.hb_row[c].to(torch.int64)                          # [M]
    if info.all_boolean and info.max_card == 2:
        if ti.deltam and folded_t is not None:
            dchunk = color_delta_multilin(ts, ti, values, c, info, folded_t,
                                          modes)
        else:
            dchunk = color_delta_bool(ts, ti, values, weights, c, info,
                                      modes)
        delta = torch.zeros((Bh + 1, NC), dtype=dchunk.dtype, device=dev)
        delta = delta.index_add_(0, row, dchunk)[:Bh]
        u = torch.rand(delta.shape, generator=generator, device=dev,
                       dtype=delta.dtype)
        return (u < torch.sigmoid(delta)).to(values.dtype)
    K = info.max_card
    M, G, A = tier_geom(ts, ti, info.n_colors)
    logits = torch.zeros((Bh + 1, K, NC), dtype=torch.float32, device=dev)
    rc = _row_chunk(ti, M, G, K * A, NC)
    for r0 in range(0, M, rc):
        logits.index_add_(0, row[r0:r0 + rc],
                          color_logits_mc(dg, ts, ti, values, weights, c,
                                          info, modes, r0, rc))
    masked = logits[:Bh] + _tc(ts.cm_kmask, c, (Bh, K))[:, :, None]
    masked += _gumbel(masked.shape, generator, dev)
    return masked.argmax(dim=1).to(values.dtype)


def _fused(ti, folded_t, modes) -> bool:
    """A tier that draws in a fused kernel (or its plain version)."""
    return (not ti.hub and folded_t is not None
            and tier_modes(ti, modes)[1] != "off")


def color_draw_tier(dg, ts, ti, values, weights, generator, c, info,
                    folded_t=None, modes=("off", "off"), write=None):
    """Draw new values [B_t, NC] for one tier of color ``c``.  A fused tier
    given ``write = (row0, mask)`` draws straight into the world's block
    instead (the kernels' world-write mode) and returns ``values``."""
    if ti.hub:
        return hub_color_draw(dg, ts, ti, values, weights, generator, c,
                              info, modes, folded_t)
    if _fused(ti, folded_t, modes):
        seed = torch.randint(-(1 << 31), 1 << 31, (2,), generator=generator,
                             device=values.device, dtype=torch.int32)
        cuda = modes[1] == "cuda"
        if ti.affine2:
            draw = fused_color_draw if cuda else fused_color_draw_plain
            return draw(values, ts.bd_nbr, ts.bd_start[c], folded_t[0],
                        folded_t[1], c, seed, ti.band_w, ti.band_tb,
                        ti.degree, write=write)
        if ti.affinek:
            av, bv, kmask = folded_t         # fold_affine_cat layout
            draw = fused_cat_draw if cuda else fused_cat_draw_plain
            return draw(values, ts.bd_nbr, ts.bd_start[c], ts.bd_eqo,
                        ts.bd_eqn, av, bv, kmask, c, seed, ti.band_w,
                        ti.band_tb, ti.degree, info.max_card, write=write)
        base, b1, b2, bx = folded_t          # fold_deltam_tiles layout
        draw = fused_dm_draw if cuda else fused_dm_draw_plain
        return draw(values, ts.bd_dmnbr, ts.bd_start[c], base, b1, b2, bx,
                    c, seed, ti.band_w, ti.band_tb, ti.degree, ti.arity - 1,
                    ti.band_k, write=write)
    if not (info.all_boolean and info.max_card == 2):
        return color_draw_categorical(dg, ts, ti, values, weights, generator,
                                      c, info, modes)
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
    simultaneous block update); returns ``values``.  A fused tier's kernel
    writes its draws into the block itself, under the resample mask; the
    other tiers' draws are written under it here."""
    B = info.block_size
    if folded is None:
        folded = (None,) * len(dg.tiers)
    for t, (ts, ti) in enumerate(zip(dg.tiers, info.tiers)):
        resample = (ts.cm_resample_ev[c] if sample_evidence
                    else ts.cm_resample[c])
        start = c * B + ti.off
        if _fused(ti, folded[t], modes):
            color_draw_tier(dg, ts, ti, values, weights, generator, c, info,
                            folded[t], modes, write=(start, resample))
            continue
        drawn = color_draw_tier(dg, ts, ti, values, weights, generator, c,
                                info, folded[t], modes)
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


def tally(counts: torch.Tensor, values: torch.Tensor) -> None:
    """Add each position's count of every value k over the chains to
    ``counts`` [K, P] int32, in place: the CUDA kernel (ops.tally) for a
    world on the card, its plain version, in bincount blocks of about
    INIT_CHUNK_ELEMS entries above 16 values, on the CPU."""
    if values.device.type == "cpu":
        tally_plain(counts, values, INIT_CHUNK_ELEMS)
    else:
        tally_counts(counts, values)


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
        tally(counts, values)
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


def _phi_streams(values, ownv, ts, ti, c, r0, rc, present, modes,
                 all_boolean: bool = True):
    """φ [rc, D, NC] of rows ``r0 .. r0+rc`` of one tier's color ``c`` at
    the current ``values``, with the variable's own value ``ownv``
    [rc, NC] as the candidate.  Neighbour values come through the same
    gather as the draw (``_gather_nbr``).  On all-boolean graphs it is
    counts-based: the slot axis is reduced at once, so no [rc, D, A, NC]
    literal tensor is made; elsewhere a literal is ``value == cs_eq`` and
    that tensor is made (the caller's row chunk bounds it)."""
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
    n = rows(ts.cs_arity, D).to(torch.int32)[..., None]
    typ = rows(ts.cs_type, D)[..., None]
    if not all_boolean:
        eq = rows(ts.cs_eq, D, A).to(values.dtype)
        own_lit = (ownv[:, None, None, :] == eq[..., None]) == pos[..., None]
        if A1 > 0:
            vals = _gather_nbr(ts, ti, values, rows(ts.cs_nbr, D, A1), c,
                               modes, r0)
            nbr_lit = (vals == eq[..., :A1, None]) == pos[..., :A1, None]
            lit_head = torch.where(ismine[..., :A1, None],
                                   own_lit[..., :A1, :], nbr_lit)
            lit = torch.cat([lit_head, own_lit[..., A1:, :]], dim=-2)
        else:
            lit = own_lit
        return _eval_phi_ax2(lit, msk[..., None], typ, n, present,
                             hmask=hmask[..., None])          # [rc, D, NC]
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
    return _phi_from_counts(nl + nown, head, n, typ, present)


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
    rows in chunks of ``row_chunk`` (default ``_row_chunk``), φ from
    ``_phi_streams`` and a segment sum per weight.  A hub tier's stream
    rows are its chunks, each with its row's own value."""
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
        rc = min(row_chunk or _row_chunk(ti, Bl, D, A, 2 * NC), Bl)
        if Bl % rc or (ti.band_w and band != "off" and rc % ti.band_tb):
            raise ValueError(f"row_chunk {rc} must divide tier block {Bl}"
                             " (and be a multiple of its band tile)")
        present = ti.present_funcs or info.present_funcs
        gsrc = ts.cs_gowner if learn_non_evidence else ts.cs_gtouch
        for c in range(C):
            for r0 in range(0, Bl, rc):
                if ti.hub:
                    # stream rows are chunks: a chunk's own value is its
                    # row's (a pad chunk's, row ti.block, is masked by gsrc)
                    hrow = ts.hb_row[c, r0:r0 + rc].clamp(max=ti.block - 1)
                    own = v_both.index_select(
                        0, c * gB + ti.off + hrow.to(torch.int64))
                else:
                    start = c * gB + ti.off + r0
                    own = v_both[start:start + rc]
                phi = _phi_streams(v_both, own, ts, ti, c, r0, rc, present,
                                   modes, info.all_boolean)
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
