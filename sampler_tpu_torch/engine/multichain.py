"""Chains-last multi-chain Gibbs engine on PyTorch (counterpart of
sampler_tpu/engine/multichain.py).

The assignment of all chains is one tensor ``values[P, NC]`` (int8 while
every cardinality is at most 127, else int32: ``values_dtype``): a row
holds one position's value in every chain.  A sweep visits the colors in
order; a color step draws every variable of that color in every chain at
once (chromatic Gibbs) and writes the new values into ``values`` in place.

This port runs marginal inference and weight learning on boolean,
categorical and mixed graphs with dense or sparse per-combination weights,
single-window and multi-window banded alike, hub tiers included:

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
  * the other deltam tiers (boolean, arity 2 or 3, multilinear
    coefficients, no banded plan: the KBC class's dense tiers and its hub
    tier) with the fused mode on draw a whole color, all those tiers of it
    together, in ``ops.fused.dm_gather_draw_tiers`` (one CUDA kernel a
    color, gathering by global position; a hub row's chunks summed as one
    deep row in a fixed order and drawn in the kernel); under graph
    sharding a tier at a time, a hub tier's chunk log-odds from the same
    kernel's delta mode;
  * the other tiers, and every tier with the fused mode off, compute the
    log-odds with ``color_delta_multilin`` (deltam tiers) or
    ``color_delta_bool`` on all-boolean graphs, and the K candidates'
    log-potentials with ``color_logits_mc`` (a Gumbel-argmax draw, a block
    of rows at a time) on the others, gathering neighbour values with
    ``ops.banded.banded_gather`` (band_k 1), ``banded_gather_multi``
    (band_k >= 2) or ``index_select`` (band off);
  * a hub tier (the variables of more than ``hub_cap`` factors) that the
    kernel does not draw draws in ``hub_color_draw``: its chunks of
    records are evaluated like rows of a dense tier, and their deltas or
    logits summed onto their rows with ``index_add_``;
  * the tallies of inference go through ``ops.tally.tally_counts`` (one
    CUDA kernel a sweep);
  * ``learn_mc`` runs contrastive SGD over an evidence and a free world of
    NC chains each; its gradient (``mc_weight_gradient_cs``) goes, tier by
    tier as ``gradient_route`` says, through ``ops.grad.grad_pair_tile``
    (one CUDA kernel a color) on affine2 tiers with the band mode on,
    through ``ops.grad.grad_records_sum`` on the other tiers while the
    fused mode is on (all of them together: one launch of the owner
    records' terms, then their float64 sums by weight, over a plan of
    the owner records built once a graph), and through the chunked
    cs-stream route (``_phi_streams``, with the same gathers as the draw)
    with it off;
  * sparse per-combination weights (a factor whose weight is looked up by
    its members' joint values in ``cwt_wid``; compile turns the affine
    and fused plans off beside them) take the candidate route
    (``color_logits_mc``'s sparse branch); in the gradient their dense
    owner records take ``grad_records_sum`` and their sparse owner
    records the table lookup beside it, over a list of those records
    built once a graph; every table index is clipped to the table, and a miss lands on
    the reserved zero weight at index W, whose gradient is held at 0.

Graph sharding (``parallel.graph_shard``) runs the same color step on a
rank's slice of the streams: ``color_step_mc`` and ``sweep_mc`` take a
``shard`` (the rank's index on the graph axis, the hub tier's partial-sum
reduce and the exchange after each tier), the fused draws write the
rank's rows at c*B + off + g*Bl, and ``mc_weight_gradient_cs`` takes
(n_graph, g) to find a local record's own row.

``modes = (band, fused)``, each "cuda" (the kernel), "plain" (its plain
PyTorch version) or "off"; the default is "cuda" on a CUDA device and
"plain" on the CPU, the band mode gated by what the compiled graph
supports, as the JAX package's resolve_band gates it, and the fused mode
gated tier by tier (``tier_modes`` for the draws, ``gradient_route`` for
the gradient).  The fused draws write
straight into the world's block (their world-write mode); the other tiers
draw a block and write it under the resample mask.

Randomness comes from one explicit ``torch.Generator`` on the run's device:
the initial worlds, the uniforms and Gumbel noise of the unfused draws, and
two int32 seed words per (sweep, color, tier) for the fused kernels'
counter hash.  In learning the one generator drives both worlds' sweeps in
turn.

Unlike the JAX package, the port's entry points run the chain count they
are asked for: the TPU rounds chains up to its 128 lanes so its kernels
stay on (demote_modes turns them off otherwise), and a GPU kernel runs at
any count.  ``effective_chains`` keeps the command line's rounding, to a
multiple of 16 on the card, where the kernels take their 16-byte variants.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import format_spec as fs
from ..compile import factor_records, resolve_device, tier_geom
from ..ops.banded import (banded_gather, banded_gather_multi,
                          banded_gather_multi_plain, banded_gather_plain)
from ..ops.fused import (DM_MAX_TIERS, DmTier, dm_gather_draw,
                         dm_gather_draw_plain, dm_gather_draw_table,
                         dm_gather_draw_tiers_plain, dm_tier_table,
                         fold_affine, fold_affine_cat, fold_deltam,
                         fold_deltam_tiles, fused_cat_draw,
                         fused_cat_draw_plain, fused_color_draw,
                         fused_color_draw_plain, fused_dm_draw,
                         fused_dm_draw_plain)
from ..ops.grad import (GRAD_W_MAX, RecordTier, grad_pair_tile,
                        grad_pair_tile_plain, grad_records_sum,
                        grad_records_sum_plain, record_phi, record_plan,
                        records_diff)
from ..ops.tally import tally_counts, tally_plain
from ..ops.weights import expand_wf, segment_reduce
from .learn import apply_update
from .potentials import (_eval_phi_ax2, _factor_phis_mc, _need_head,
                         _phi_from_counts)

MECHANISMS = ("cuda", "plain", "off")


def values_dtype(info) -> torch.dtype:
    """The worlds' dtype: int8 while every cardinality fits, else int32."""
    return torch.int8 if info.max_card <= 127 else torch.int32


def resolve_modes(info, device) -> tuple:
    """Default (band, fused) mechanisms for this graph on ``device``: band
    on where the graph has a banding plan and int8-sized values (JAX
    resolve_band in its "auto" setting), fused on wherever XLA fuses the
    JAX package's draws or gradient.  A tier draws through a fused kernel
    only where ``tier_modes`` finds it a plan (a banded affine2 / affinek
    / fusedm tier, whose band is then on, as JAX resolve_fused follows
    band, or the multilinear coefficients of dm_gather_draw): a graph with
    sparse per-combination weights has none, and its tiers draw eagerly
    (the table lookup) whatever the fused mode.  Every tier that
    ``gradient_route`` reaches takes the records route (grad_records_sum),
    the dense records of sparse-weight graphs too."""
    mech = "cuda" if torch.device(device).type == "cuda" else "plain"
    band = mech if info.band_w > 0 and info.max_card <= 127 else "off"
    return band, mech


def check_modes(modes, device) -> tuple:
    modes = tuple(modes)
    if len(modes) != 2 or any(m not in MECHANISMS for m in modes):
        raise ValueError(f"modes must be two of {MECHANISMS}, got {modes}")
    if "cuda" in modes and torch.device(device).type != "cuda":
        raise ValueError(f"mode 'cuda' needs a CUDA device, not {device}")
    return modes


def tier_modes(ti, modes) -> tuple:
    """Per-tier gating: a tier without a banding plan gathers with
    index_select; a tier without a fused plan (a banded one, or the
    multilinear coefficients of dm_gather_draw) never routes to a fused
    kernel."""
    band, fused = modes
    if ti.band_w <= 0:
        band = "off"
    if not (ti.affine2 or ti.affinek or ti.fusedm or ti.deltam):
        fused = "off"
    return band, fused


CHAIN_ROUND = 16                # chains a thread in the kernels' 16-byte rows
AUTOCHAIN_BYTES = 1 << 30       # the rounded worlds' budget (as in JAX)


def effective_chains(info, device, n_chains: int, n_positions: int,
                     n_worlds: int = 1) -> int:
    """The chain count the command line runs: on a CUDA device, ``n_chains``
    rounded up to a multiple of CHAIN_ROUND, so the kernels take their
    16-byte variants (16 chains a thread) instead of their byte variants.
    The extra chains are real chains pooled into the same tallies and
    chain-averaged gradients.  Kept as asked on the CPU, and where the
    rounded worlds would pass AUTOCHAIN_BYTES, as the JAX package keeps
    its lane rounding under the same budget."""
    if torch.device(device).type != "cuda" or n_chains % CHAIN_ROUND == 0:
        return n_chains
    new = -(-n_chains // CHAIN_ROUND) * CHAIN_ROUND
    bytes_per = 1 if info.max_card <= 127 else 4
    if n_positions * new * n_worlds * bytes_per > AUTOCHAIN_BYTES:
        return n_chains
    return new


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
    exact arithmetic; differs from color_delta_bool only in rounding.
    The eager route of a deltam tier with the fused mode off (the JAX
    package's arithmetic, pass by pass); with it on, dm_gather_draw."""
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
    the gathered neighbour values at the others (the caller masks
    k >= card with cm_kmask).  Its [rc, D, K, A, NC] literal
    and [rc, D, K, NC] φ temporaries scale with ``rc``.

    A sparse factor (cs_issparse) contributes weights[cwt_wid[m]]·feat
    instead, with m = cs_cwbase + Σ_slot stride·value over the candidate at
    the own slots and the gathered values at the others; m is clipped to
    the table, and a combination the table lacks holds the reserved zero
    weight, so no mask is needed."""
    K = info.max_card
    B, D, A = tier_geom(ts, ti, info.n_colors)
    rc = B - r0 if rc is None else rc
    rows = slice(r0, r0 + rc)
    A1 = A - 1
    NC = values.shape[-1]
    nbr_lit, pos, eq, vals_raw = _nbr_lits(ts, ti, values, c, info, modes,
                                           r0, rc)
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
    feat = _tc(ts.cs_feat, c, (B, D))[rows]
    wf = expand_wf(weights, _tc(ts.cs_wid, c, (B, D))[rows],
                   feat)[:, :, None, None]
    contrib = wf * phi                                          # [rc,D,K,NC]
    if info.has_sparse_cw:
        stride = _tc(ts.cs_cwstride, c, (B, D, A))[rows]
        s_own = torch.where(is_mine, stride, 0).sum(dim=-1,
                                                    dtype=torch.int32)
        m = (_tc(ts.cs_cwbase, c, (B, D))[rows][:, :, None, None]
             + s_own[:, :, None, None] * ks.to(torch.int32)
             + _stride_sum(stride, vals_raw, A1, NC)[:, :, None, :])
        swid = _table_wid(dg, m)
        sc = expand_wf(weights, swid) * feat[:, :, None, None]
        contrib = torch.where(
            _tc(ts.cs_issparse, c, (B, D))[rows][:, :, None, None], sc,
            contrib)
    return contrib.sum(dim=1)                                   # [rc, K, NC]


def _stride_sum(stride, nbr_vals, A1: int, NC: int) -> torch.Tensor:
    """Σ over the neighbour slots of stride·value, [rows, D, NC] int32
    (zeros on a unary tier, whose ``nbr_vals`` is None)."""
    if nbr_vals is None:
        return torch.zeros(stride.shape[:2] + (NC,), dtype=torch.int32,
                           device=stride.device)
    return (stride[..., :A1, None].to(torch.int32)
            * nbr_vals.to(torch.int32)).sum(dim=-2, dtype=torch.int32)


def _table_wid(dg, m: torch.Tensor) -> torch.Tensor:
    """cwt_wid at the combination indices ``m``, clipped to [0, T-1] as
    JAX clips a gather index."""
    T = dg.cwt_wid.shape[0]
    idx = m.clamp(0, T - 1).to(torch.int64)
    return dg.cwt_wid.index_select(0, idx.reshape(-1)).reshape(m.shape)


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


class Folded(tuple):
    """prepare_fold's per-tier folded streams; ``dm`` is the plan of
    dm_gather_draw's launches a color step (_DmPlan), or None."""
    dm = None


def prepare_fold(dg, weights, info, modes, plan: bool = True):
    """Per-tier folded coefficient streams (None for tiers no folded path
    covers), as a Folded tuple, or None when nothing folds: with the fused
    mode on, fold_affine for affine2 tiers, fold_affine_cat for affinek
    tiers and fold_deltam_tiles (the kernel's tile layout) for fusedm
    tiers; fold_deltam for the other deltam tiers.
    color_draw_tier routes a tier to a fused draw under the same
    condition, so a layout never reaches the wrong path.  With ``plan``
    (an unsharded graph) the Folded also carries dm_gather_draw's plan
    (``dm``).  Called once per weights value, outside the sweep loop."""
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

    folded = Folded(fold_one(ts, ti) for ts, ti in zip(dg.tiers, info.tiers))
    if plan and modes[1] != "off":
        dm = _DmPlan(dg, info, folded, modes)
        folded.dm = dm if dm.tiers else None
    return folded


def hub_partial(dg, ts, ti, values, weights, c, info, modes=("off", "off"),
                folded_t=None) -> torch.Tensor:
    """The chunk sums of a chunked-CSR hub tier of color ``c`` on its rows:
    its [M, G, A] chunk streams are evaluated with the dense tiers' code
    (a chunk is a row of D = G records; a deltam tier's with the fused
    mode on by dm_gather_draw's delta mode), and the chunks' deltas
    [M, NC] (boolean) or logits [M, K, NC] (categorical) are summed onto
    their rows with ``index_add_`` into [B_t + 1, ...]: the pad chunks, whose
    ``hb_row`` is B_t, land in the extra row, which is dropped.  Under
    graph sharding ``ts`` holds a rank's run of chunks, and the result is
    that rank's partial sums over the whole tier block."""
    Bh = ti.block
    NC = values.shape[-1]
    dev = values.device
    row = ts.hb_row[c].to(torch.int64)                          # [M]
    if info.all_boolean and info.max_card == 2:
        fused = tier_modes(ti, modes)[1]
        if ti.deltam and folded_t is not None and fused != "off":
            delta_of = (dm_gather_draw if fused == "cuda"
                        else dm_gather_draw_plain)
            dchunk = delta_of(values, *_dm_streams(ts, ti, c, info,
                                                   folded_t), None)
        elif ti.deltam and folded_t is not None:
            dchunk = color_delta_multilin(ts, ti, values, c, info, folded_t,
                                          modes)
        else:
            dchunk = color_delta_bool(ts, ti, values, weights, c, info,
                                      modes)
        delta = torch.zeros((Bh + 1, NC), dtype=dchunk.dtype, device=dev)
        return delta.index_add_(0, row, dchunk)[:Bh]
    K = info.max_card
    M, G, A = tier_geom(ts, ti, info.n_colors)
    logits = torch.zeros((Bh + 1, K, NC), dtype=torch.float32, device=dev)
    rc = _row_chunk(ti, M, G, K * A, NC)
    for r0 in range(0, M, rc):
        logits.index_add_(0, row[r0:r0 + rc],
                          color_logits_mc(dg, ts, ti, values, weights, c,
                                          info, modes, r0, rc))
    return logits[:Bh]


def hub_color_draw(dg, ts, ti, values, weights, generator, c, info,
                   modes=("off", "off"), folded_t=None,
                   psum=None) -> torch.Tensor:
    """Draw new values [B_t, NC] for a chunked-CSR hub tier of color ``c``:
    ``hub_partial``'s sums, then the Bernoulli or Gumbel-argmax draw, as
    on the unfused dense tiers.  The color step takes it for a hub tier
    that dm_gather_draw does not draw: the categorical hubs, the fused
    mode off, and under graph sharding.

    Under graph sharding ``psum`` sums a tensor over the graph group in
    place: the ranks' partial sums are combined, and each rank draws the
    whole block with its own noise (the caller keeps its row slice).
    cm_kmask is split by rows there, so the K mask of the whole block is
    rebuilt from var_card (as the JAX package does)."""
    Bh = ti.block
    dev = values.device
    sums = hub_partial(dg, ts, ti, values, weights, c, info, modes, folded_t)
    if psum is not None:
        psum(sums)
    if sums.dim() == 2:
        u = torch.rand(sums.shape, generator=generator, device=dev,
                       dtype=sums.dtype)
        return (u < torch.sigmoid(sums)).to(values.dtype)
    K = info.max_card
    if psum is not None:
        start = c * info.block_size + ti.off
        card = dg.var_card[start:start + Bh]
        kmask = torch.where(torch.arange(K, device=dev)[None, :]
                            < card[:, None], 0.0, -1e30)
    else:
        kmask = _tc(ts.cm_kmask, c, (Bh, K))
    masked = sums + kmask[:, :, None]
    masked += _gumbel(masked.shape, generator, dev)
    return masked.argmax(dim=1).to(values.dtype)


def _fused(ti, folded_t, modes) -> bool:
    """A tier that draws in a fused kernel (or its plain version)."""
    return (not ti.hub and folded_t is not None
            and tier_modes(ti, modes)[1] != "off")


def _dm_tier(ti, folded_t, modes) -> bool:
    """A tier that dm_gather_draw draws: a deltam tier without a banded
    plan (the hub tier too) with its fold and the fused mode on."""
    return (ti.deltam and not (ti.affine2 or ti.fusedm)
            and folded_t is not None and tier_modes(ti, modes)[1] != "off")


# derived device arrays of a graph, built once: keyed by the stream they
# come from, so they live as long as the graph
_DERIVED = WeakIdKeyDictionary()


def _derived(key: torch.Tensor, make):
    got = _DERIVED.get(key)
    if got is None:
        got = _DERIVED[key] = make()
    return got


def hub_rows(ts, ti, c: int) -> torch.Tensor:
    """The chunk offsets int32 [block + 1] of color ``c``'s hub rows: row r
    is chunks rows[r] .. rows[r+1]-1 of the color's [M, G] chunk streams.
    A row's chunks are consecutive and in row order; the pad chunks, whose
    hb_row is the block, come last and belong to no row.  Built once a
    graph (unsharded: a rank's run of chunks is not a color's)."""
    def make():
        row = ts.hb_row.to(torch.int64)                     # [C, M]
        C = row.shape[0]
        n = torch.zeros((C, ti.block + 1), dtype=torch.int64,
                        device=row.device)
        n.scatter_add_(1, row, torch.ones_like(row))
        offs = torch.zeros((C, ti.block + 1), dtype=torch.int64,
                           device=row.device)
        offs[:, 1:] = n[:, :ti.block].cumsum(dim=1)
        return offs.to(torch.int32)
    return _derived(ts.hb_row, make)[c]


def _dm_tier_list(dg, info, tiers, folded, c: int, ev: bool) -> list:
    """The DmTier of color ``c`` of each planned tier, drawing into the world
    under its resample mask (``ev``: the sample-evidence one)."""
    out = []
    for t in tiers:
        ts, ti = dg.tiers[t], info.tiers[t]
        mask = ts.cm_resample_ev[c] if ev else ts.cm_resample[c]
        out.append(DmTier(*_dm_streams(ts, ti, c, info, folded[t]),
                          rows=hub_rows(ts, ti, c) if ti.hub else None,
                          write=(c * info.block_size + ti.off, mask)))
    return out


def _dm_tables(dg, info, tiers, folded) -> tuple:
    """The planned tiers' launch tables, int64 [C, 2, T, 16] (color, mask
    of the resample or the sample-evidence mode, tier), and the graph's
    streams they point into: a template built once a graph
    (dm_tier_table: its streams checked, its rows and masks), kept with
    those streams and rebuilt when a tier's stream is another tensor, with
    this fold's coefficient pointers written in, so a fold costs a few
    numpy writes."""
    C = info.n_colors
    refs = tuple(x for t in tiers for x in (
        dg.tiers[t].cs_nbr, dg.tiers[t].cm_resample,
        dg.tiers[t].cm_resample_ev, dg.tiers[t].hb_row))
    cache = _derived(dg.var_card, dict)
    key = tuple(tiers)
    got = cache.get(key)
    if got is None or any(a is not b for a, b in zip(got[0], refs)):
        got = cache[key] = (refs, np.stack([np.stack([
            dm_tier_table(_dm_tier_list(dg, info, tiers, folded, c, ev))
            for ev in (False, True)]) for c in range(C)]))
    tab = got[1].copy()
    colors = np.arange(C, dtype=np.int64)[:, None]
    for i, t in enumerate(tiers):
        B, D, _ = tier_geom(dg.tiers[t], info.tiers[t], C)
        base, b1, b2, bx = folded[t]                 # fold_deltam layout
        for col, x, n in ((4, base, B), (1, b1, B * D), (2, b2, B * D),
                          (3, bx, B * D)):
            if x is None:
                continue
            if (x.dtype != torch.float32 or not x.is_contiguous()
                    or x.numel() != C * n or x.device != dg.var_card.device):
                raise ValueError(f"dm_gather_draw: folded stream {col} of "
                                 f"tier {t}: {x.dtype} {tuple(x.shape)}")
            tab[:, :, i, col] = x.data_ptr() + colors * (4 * n)
    return tab, refs


class _DmPlan:
    """dm_gather_draw's launches a color step, built by prepare_fold: the
    tiers it draws (``_dm_tier``: the KBC class's dense tiers and its hub
    tier), at most DM_MAX_TIERS a launch, each drawing into the world under
    its resample mask or, in the sample-evidence mode, the other one.  On
    the card their launch tables (``_dm_tables``), holding the fold's
    coefficient streams and the graph's streams the tables point into; on
    the CPU the DmTier lists of each (color, mode) for the plain version.
    It holds no Folded, so it adds no reference cycle."""

    def __init__(self, dg, info, folded, modes):
        self.tiers = [t for t, (ti, f) in enumerate(zip(info.tiers, folded))
                      if _dm_tier(ti, f, modes)]
        self.tables = self.lists = None
        if not self.tiers:
            return
        if modes[1] == "cuda":
            self.tables, graph = _dm_tables(dg, info, self.tiers, folded)
            self.streams = (graph, [folded[t] for t in self.tiers])
        else:
            self.lists = {(c, ev): _dm_tier_list(dg, info, self.tiers, folded,
                                                 c, ev)
                          for c in range(info.n_colors)
                          for ev in (False, True)}

    def draw(self, values, c: int, sample_evidence: bool, generator):
        """Draw color ``c`` of every planned tier into ``values``: two
        int32 seed words a tier from ``generator``, one launch (a launch
        for each DM_MAX_TIERS tiers)."""
        T, M = len(self.tiers), DM_MAX_TIERS
        seeds = torch.randint(-(1 << 31), 1 << 31, (T, 2),
                              generator=generator, device=values.device,
                              dtype=torch.int32)
        for i in range(0, T, M):
            if self.tables is not None:
                dm_gather_draw_table(
                    values, self.tables[c, int(sample_evidence), i:i + M],
                    seeds[i:i + M])
            else:
                dm_gather_draw_tiers_plain(
                    values, self.lists[c, sample_evidence][i:i + M],
                    seeds[i:i + M])


def _dm_streams(ts, ti, c, info, folded_t) -> tuple:
    """dm_gather_draw's streams of color ``c`` of a deltam tier (a hub
    tier's chunks as rows): (nbr [B, D, A1], base [B], b1, b2, bx [B, D];
    b2, bx None on pairwise tiers), views of cs_nbr and of fold_deltam's
    flat coefficients."""
    B, D, A = tier_geom(ts, ti, info.n_colors)
    base, b1, b2, bx = folded_t                 # fold_deltam layout
    cross = (None, None) if b2 is None else (_tc(b2, c, (B, D)),
                                             _tc(bx, c, (B, D)))
    return (_tc(ts.cs_nbr, c, (B, D, A - 1)), _tc(base, c, (B,)),
            _tc(b1, c, (B, D)), *cross)


def color_draw_tier(dg, ts, ti, values, weights, generator, c, info,
                    folded_t=None, modes=("off", "off"), write=None,
                    psum=None):
    """Draw new values [B_t, NC] for one tier of color ``c``.  A fused tier
    given ``write = (row0, mask)`` draws straight into the world's block
    instead (the kernels' world-write mode) and returns ``values``.
    ``psum`` goes to a hub tier's draw (graph sharding)."""
    if ti.hub:
        return hub_color_draw(dg, ts, ti, values, weights, generator, c,
                              info, modes, folded_t, psum)
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
        if not ti.fusedm:                    # a deltam tier, no band plan
            draw = dm_gather_draw if cuda else dm_gather_draw_plain
            return draw(values, *_dm_streams(ts, ti, c, info, folded_t),
                        seed, write=write)
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
                  info, folded=None, modes=("off", "off"),
                  shard=None) -> torch.Tensor:
    """Resample color ``c`` in all chains, writing into ``values`` in place
    (tiers of one color share no factor, so tier by tier is the
    simultaneous block update); returns ``values``.  A fused tier's kernel
    writes its draws into the block itself, under the resample mask; the
    other tiers' draws are written under it here.  Unsharded, the tiers
    that dm_gather_draw takes (the KBC class's, its hub tier included)
    draw first, all in one launch (``_DmPlan``).

    Under graph sharding ``shard`` (``parallel.graph_shard.Shard``) is
    this rank's place on the graph axis: ``dg`` holds the rank's stream
    slices, the rank draws rows g*Bl .. (g+1)*Bl of each tier segment
    (Bl = block / n_graph; a hub tier's block comes whole from
    ``shard.psum`` and is cut to them), and ``shard.exchange`` brings the
    other ranks' slices in after each tier."""
    B = info.block_size
    n, g = (1, 0) if shard is None else (shard.n_graph, shard.g)
    psum = None if shard is None else shard.psum
    plan = None if shard is not None else getattr(folded, "dm", None)
    if plan is not None:
        plan.draw(values, c, sample_evidence, generator)
    if folded is None:
        folded = (None,) * len(dg.tiers)
    for t, (ts, ti) in enumerate(zip(dg.tiers, info.tiers)):
        if plan is not None and t in plan.tiers:
            continue
        resample = (ts.cm_resample_ev[c] if sample_evidence
                    else ts.cm_resample[c])
        Bl = ti.block // n
        start = c * B + ti.off + g * Bl
        if _fused(ti, folded[t], modes):
            color_draw_tier(dg, ts, ti, values, weights, generator, c, info,
                            folded[t], modes, write=(start, resample))
        else:
            drawn = color_draw_tier(dg, ts, ti, values, weights, generator,
                                    c, info, folded[t], modes, psum=psum)
            if ti.hub and n > 1:
                drawn = drawn[g * Bl:(g + 1) * Bl]
            old = values[start:start + Bl]
            old.copy_(torch.where(resample[:, None], drawn, old))
        if shard is not None:
            shard.exchange(values, c, t)
    return values


def sweep_mc(dg, values, weights, generator, sample_evidence: bool, info,
             folded=None, modes=("off", "off"), shard=None) -> torch.Tensor:
    """One sweep over the colors, in place; returns ``values``.  ``shard``:
    as in color_step_mc."""
    for c in range(info.n_colors):
        color_step_mc(dg, values, weights, generator, c, sample_evidence,
                      info, folded, modes, shard)
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
    return _factor_phis_mc(dg, values, info.present_funcs)


def sparse_comb_wids(dg, values) -> torch.Tensor:
    """Per-factor sparse-table weight ids int32 for world(s) ``values``:
    [P] -> [F'], [P, NC] -> [F', NC].  Factors that are not sparse map to
    the reserved zero-weight slot."""
    f_vids = factor_records(dg)[0]
    Fp, A = f_vids.shape
    tail = () if values.ndim == 1 else (values.shape[-1],)
    vals = values.index_select(0, f_vids.reshape(-1)).to(torch.int32) \
        .reshape((Fp, A) + tail)
    stride = dg.f_cwstride.reshape(Fp, -1)
    base = dg.f_cwbase
    if values.ndim > 1:
        stride, base = stride[..., None], base[:, None]
    m = base + (stride * vals).sum(dim=1, dtype=torch.int32)
    zero = dg.w_init.shape[0] - 1                    # reserved zero slot
    return torch.where(base >= 0, _table_wid(dg, m), zero).to(torch.int32)


def _mc_weight_gradient_factors(dg, v_ev, v_free, learn_non_evidence: bool,
                                info) -> torch.Tensor:
    """Weight gradient [W] averaged over the chain axis of [P, NC] worlds,
    factor by factor: the reference the cs-stream routes are held to."""
    return factor_gradient(dg, v_ev, v_free, learn_non_evidence,
                           info.present_funcs, info.has_sparse_cw)


def factor_gradient(dg, v_ev, v_free, learn_non_evidence: bool, present,
                    has_sparse_cw: bool) -> torch.Tensor:
    """The per-factor gradient of ``_mc_weight_gradient_factors`` (and of
    the single-chain ``engine.learn.weight_gradient``, at NC = 1).  A
    sparse factor's φ is 1 on its current combination, so it adds +feat at
    the weight its evidence world selects and -feat at the free world's."""
    W = dg.w_init.shape[0]
    NC = v_ev.shape[-1]
    diff = dg.f_feat[:, None] * (_factor_phis_mc(dg, v_ev, present)
                                 - _factor_phis_mc(dg, v_free, present))
    keep = torch.ones_like(dg.f_feat, dtype=torch.bool)
    if not learn_non_evidence:
        f_vids, _, _, f_mask = factor_records(dg)
        role = dg.var_role.index_select(0, f_vids.reshape(-1)) \
            .reshape(f_vids.shape)
        keep = ((role == fs.ROLE_EVIDENCE) & f_mask).any(dim=-1)
    issparse = dg.f_cwbase >= 0 if has_sparse_cw else None
    dense = keep if issparse is None else keep & ~issparse
    diff = torch.where(dense[:, None], diff, 0.0)
    grad = segment_reduce(diff.mean(dim=1), dg.f_wid, W)
    if issparse is None:
        return grad
    sel = torch.where(keep & issparse, dg.f_feat / NC, 0.0)[:, None] \
        .expand(-1, NC)
    grad = grad + segment_reduce(
        torch.cat([sel, -sel], dim=-1),
        torch.cat([sparse_comb_wids(dg, v_ev),
                   sparse_comb_wids(dg, v_free)], dim=-1), W)
    grad[W - 1] = 0.0                   # keep the reserved slot inert
    return grad


def _rows(arr, C: int, c: int, r0: int, rc: int, *tail) -> torch.Tensor:
    """Rows ``r0 .. r0+rc`` of color ``c`` of a flat tier stream whose
    logical shape is [C, rows, *tail]."""
    n = 1
    for x in tail:
        n *= x
    B = arr.numel() // (C * n)
    base = (c * B + r0) * n
    return arr[base:base + rc * n].view((rc,) + tail)


def _phi_streams(values, ownv, ts, ti, c, r0, rc, present, modes,
                 all_boolean: bool = True) -> tuple:
    """(φ [rc, D, NC], gathered neighbour values [rc, D, A-1, NC] or None on
    a unary tier) of rows ``r0 .. r0+rc`` of one tier's color ``c`` at the
    current ``values``, with the variable's own value ``ownv`` [rc, NC] as
    the candidate.  Neighbour values come through the same gather as the
    draw (``_gather_nbr``); the sparse-weight gradient reuses them for its
    table lookup.  φ is ``ops.grad.record_phi``, the math of
    ``grad_records_plain``."""
    C = ts.bd_start.shape[0]
    _, D, A = tier_geom(ts, ti, C)
    A1 = A - 1

    def rows(arr, *tail):
        return _rows(arr, C, c, r0, rc, *tail)

    vals = None
    if A1 > 0:
        vals = _gather_nbr(ts, ti, values, rows(ts.cs_nbr, D, A1), c, modes,
                           r0)
    eq = None if all_boolean else rows(ts.cs_eq, D, A)
    phi = record_phi(ownv, vals, rows(ts.cs_pos, D, A),
                     rows(ts.cs_ismine, D, A), rows(ts.cs_mask, D, A),
                     rows(ts.cs_hmask, D, A), eq, rows(ts.cs_arity, D),
                     rows(ts.cs_type, D), present, all_boolean)
    return phi, vals


def _record_streams(ts, ti, C: int, gB: int, gsrc, n_graph: int, g: int,
                    all_boolean: bool) -> tuple:
    """The arguments of ``grad_records`` (and the first of a RecordTier) for
    one tier after the two worlds and before ``present``: its streams,
    color-major, and its own rows (a dense row r of color c at c*gB + off
    + g*(block // n_graph) + r; a hub chunk's row from hb_row, which names
    rows of the whole block, a pad chunk's clamped into it, where gsrc
    masks it)."""
    Bl, D, A = tier_geom(ts, ti, C)

    def rows(arr, *tail):
        return arr.view((C, Bl) + tail)

    if ti.hub:
        own_base = ti.off
        own_idx = ts.hb_row.clamp(max=ti.block - 1)
    else:
        own_base = ti.off + g * (ti.block // n_graph)
        own_idx = None
    nbr = (rows(ts.cs_nbr, D, A - 1) if A > 1 else torch.empty(
        (C, Bl, D, 0), dtype=torch.int32, device=ts.cs_type.device))
    return (nbr, rows(ts.cs_pos, D, A), rows(ts.cs_ismine, D, A),
            rows(ts.cs_mask, D, A), rows(ts.cs_hmask, D, A),
            None if all_boolean else rows(ts.cs_eq, D, A),
            rows(ts.cs_type, D), rows(ts.cs_arity, D), rows(ts.cs_feat, D),
            rows(gsrc, D), own_base, gB, own_idx)


def gradient_route(ti, info, modes, W: int, row_chunk: int | None = None,
                   n_graph: int = 1) -> tuple:
    """(route, mechanism) of one tier's gradient under ``modes``:

      * ("pair", band): an affine2 tier with W <= GRAD_W_MAX, its band
        mode on, no ``row_chunk`` and no graph sharding (as in the JAX
        package) takes ``grad_pair_tile``;
      * ("records", fused): with the fused mode on, every other tier takes
        ``grad_records_sum`` ("cuda") or ``grad_records_sum_plain``
        ("plain"), all such tiers in one call; on a graph with sparse
        per-combination weights its dense owner records, the sparse ones
        going to ``_sparse_grad_records`` beside it;
      * ("chunked", "off"): with the fused mode off, the chunked route."""
    band, fused = modes
    tband = tier_modes(ti, modes)[0]
    if (ti.affine2 and W <= GRAD_W_MAX and tband != "off"
            and row_chunk is None and n_graph == 1):
        return "pair", tband
    if fused != "off":
        return "records", fused
    return "chunked", "off"


def mc_weight_gradient_cs(dg, v_ev, v_free, learn_non_evidence: bool, info,
                          modes=("off", "off"),
                          row_chunk: int | None = None, n_graph: int = 1,
                          g: int = 0) -> torch.Tensor:
    """Weight gradient [W] on the cs streams: each factor counted once via
    its compile-time owner record (cs_gowner, or cs_gtouch unless
    ``learn_non_evidence``), averaged over the NC chains.  Each tier takes
    its ``gradient_route``:

      * "pair": ``grad_pair_tile`` (the kernel, or its plain version), one
        call a color;
      * "records": every such tier in one call of ``grad_records_sum``
        (the kernels: the owner records' terms, all tiers in one launch,
        then their float64 sums by weight, rounded once) or of
        ``grad_records_sum_plain`` (``grad_records_plain`` a tier, in
        chunks of ``row_chunk`` rows, then one ``segment_reduce``), over
        the tiers' plan (``_record_plan``, built once a graph and owner
        mask).  On a graph with sparse per-combination weights the plan
        holds the dense owner records (``_sparse_owners``), and the
        sparse ones take ``_sparse_grad_records``: the table lookup of
        each world's combination over a list of those records, one pass
        a tier;
      * "chunked": both worlds side by side on the chain axis, rows in
        chunks of ``row_chunk`` (default ``_row_chunk``), φ from
        ``_phi_streams`` (the same ``record_phi``) and ``records_diff``,
        then the segment sum.  A sparse factor's owner record adds +feat
        at the table weight of its evidence world's combination and -feat
        at its free world's, the draw's table lookup with the own value as
        the candidate.

    A hub tier's stream rows are its chunks, each with its row's own
    value.  Under graph sharding ``dg`` holds rank ``g``'s stream slices
    of ``n_graph`` while the worlds are whole: a local record's own row is
    c*B + ti.off + g*(ti.block // n_graph) + r (a hub chunk's comes from
    hb_row, which names rows of the whole block).  Owner records are
    disjoint across the ranks, so their gradients sum over the graph
    group."""
    W = dg.w_init.shape[0]
    NC = v_ev.shape[-1]
    gB = info.block_size
    C = info.n_colors
    grad = torch.zeros(W, dtype=torch.float32, device=v_ev.device)
    v_both = None
    records, rec_mech = [], None
    for t, (ts, ti) in enumerate(zip(dg.tiers, info.tiers)):
        Bl, D, A = tier_geom(ts, ti, C)
        route, mech = gradient_route(ti, info, modes, W, row_chunk, n_graph)
        if route == "pair":
            kernel = grad_pair_tile if mech == "cuda" else grad_pair_tile_plain
            coef = ts.gd_cown if learn_non_evidence else ts.gd_ctch
            for c in range(C):
                parts = kernel(v_ev, v_free, ts.bd_nbr, ts.bd_start[c],
                               ts.gd_wid, coef, ts.gd_ao, ts.gd_an,
                               ts.gd_ax, c, c * gB + ti.off, ti.band_w,
                               ti.band_tb, D, W)
                grad = grad + (parts.sum(dim=0, dtype=torch.float64)
                               / NC).to(torch.float32)
            continue
        present = ti.present_funcs or info.present_funcs
        gsrc = ts.cs_gowner if learn_non_evidence else ts.cs_gtouch
        if route == "records":
            records.append(t)
            rec_mech = mech
            if info.has_sparse_cw:
                sparse = _sparse_owners(ts, gsrc)[1]
                if sparse.numel():
                    grad = grad + _sparse_grad_records(
                        dg, ts, ti, C, gB, v_ev, v_free, sparse,
                        ti.off + g * (ti.block // n_graph), W)
            continue
        if v_both is None:
            # one gather a chunk serves both worlds
            v_both = torch.cat([v_ev, v_free], dim=-1)
        band = tier_modes(ti, modes)[0]
        rc = min(row_chunk or _row_chunk(ti, Bl, D, A, 2 * NC), Bl)
        if Bl % rc or (ti.band_w and band != "off" and rc % ti.band_tb):
            raise ValueError(f"row_chunk {rc} must divide tier block {Bl}"
                             " (and be a multiple of its band tile)")
        for c in range(C):
            for r0 in range(0, Bl, rc):
                if ti.hub:
                    # stream rows are chunks: a chunk's own value is its
                    # row's (a pad chunk's, row ti.block, is masked by gsrc)
                    hrow = ts.hb_row[c, r0:r0 + rc].clamp(max=ti.block - 1)
                    own = v_both.index_select(
                        0, c * gB + ti.off + hrow.to(torch.int64))
                else:
                    start = c * gB + ti.off + g * (ti.block // n_graph) + r0
                    own = v_both[start:start + rc]
                phi, nbrv = _phi_streams(v_both, own, ts, ti, c, r0, rc,
                                         present, modes, info.all_boolean)
                sl = slice((c * Bl + r0) * D, (c * Bl + r0 + rc) * D)
                feat = ts.cs_feat[sl].view(rc, D)
                gm = gsrc[sl].view(rc, D)
                if info.has_sparse_cw:
                    issp = ts.cs_issparse[sl].view(rc, D)
                    diff = records_diff(phi, feat, gm & ~issp)
                else:
                    diff = records_diff(phi, feat, gm)
                grad = grad + segment_reduce(diff, ts.cs_wid[sl], W)
                if info.has_sparse_cw:
                    grad = grad + _sparse_grad_rows(
                        dg, ts, C, c, r0, rc, D, A, own, nbrv,
                        torch.where(gm & issp, feat, 0.0) / NC, W)
    if records:
        plan = _record_plan(dg, info, records, learn_non_evidence, n_graph,
                            g)
        grad = grad + (grad_records_sum(v_ev, v_free, plan)
                       if rec_mech == "cuda" else grad_records_sum_plain(
                           v_ev, v_free, plan, row_chunk=row_chunk))
    if info.has_sparse_cw:
        grad[W - 1] = 0.0               # keep the reserved slot inert
    return grad


def _record_plan(dg, info, tiers, learn_non_evidence: bool, n_graph: int,
                 g: int):
    """The records route's plan (ops.grad.record_plan) of ``tiers`` under
    one owner mask: each tier's owner records (on a graph with sparse
    per-combination weights its dense ones), their own rows (rank ``g``'s
    of ``n_graph``) and weight ids.  Built once a graph and kept with the
    streams it was built from; rebuilt when a tier's stream is another
    tensor."""
    C, gB = info.n_colors, info.block_size
    refs = tuple(x for t in tiers for x in (
        dg.tiers[t].cs_wid, dg.tiers[t].cs_gowner, dg.tiers[t].cs_gtouch))
    cache = _derived(dg.var_card, dict)
    key = ("records", bool(learn_non_evidence), tuple(tiers), n_graph, g)
    got = cache.get(key)
    if got is None or any(a is not b for a, b in zip(got[0], refs)):
        rts = []
        for t in tiers:
            ts, ti = dg.tiers[t], info.tiers[t]
            gsel = ts.cs_gowner if learn_non_evidence else ts.cs_gtouch
            if info.has_sparse_cw:
                gsel = _sparse_owners(ts, gsel)[0]
            Bl, D, _ = tier_geom(ts, ti, C)
            rts.append(RecordTier(
                *_record_streams(ts, ti, C, gB, gsel, n_graph, g,
                                 info.all_boolean),
                ti.present_funcs or info.present_funcs,
                ts.cs_wid.view(C, Bl, D)))
        got = cache[key] = (refs, record_plan(rts, dg.w_init.shape[0],
                                              info.all_boolean))
    return got[1]


def _sparse_owners(ts, gsrc) -> tuple:
    """(the dense owner records ``gsrc & ~cs_issparse``, bool like gsrc;
    the sparse owner records' flat indices into the tier's [C, B, D]
    records, int64 [K]) of an owner mask, built once a graph."""
    def make():
        issp = ts.cs_issparse.view(gsrc.shape)
        return gsrc & ~issp, (gsrc & issp).nonzero().flatten()
    return _derived(gsrc, make)


def _sparse_grad_records(dg, ts, ti, C, gB, v_ev, v_free, rec, own0: int,
                         W: int) -> torch.Tensor:
    """The sparse owner records' gradient on one tier (a dense tier; hub
    tiers do not combine with sparse weights): each record ``rec`` (flat
    [C, B, D] indices) adds feat/NC at the table weight of its evidence
    world's combination and -feat/NC at its free world's, the draw's
    table lookup with the row's own value as the candidate.  Its own row
    is c*gB + own0 + r."""
    Bl, D, A = tier_geom(ts, ti, C)
    NC = v_ev.shape[-1]
    c, r = rec // (Bl * D), (rec // D) % Bl
    own = c * gB + own0 + r
    stride = ts.cs_cwstride.view(-1, A).index_select(0, rec)
    ismine = ts.cs_ismine.view(-1, A).index_select(0, rec)
    s_own = torch.where(ismine, stride, 0).sum(dim=-1, dtype=torch.int32)
    base = ts.cs_cwbase.index_select(0, rec)
    nbr = (ts.cs_nbr.view(-1, A - 1).index_select(0, rec)
           if A > 1 else None)
    wids = []
    for v in (v_ev, v_free):
        nbrv = (None if nbr is None else v.index_select(
            0, nbr.reshape(-1)).reshape(nbr.shape + (NC,)))
        m = (base[:, None] + _stride_sum(stride[:, None], None if nbrv is
                                         None else nbrv[:, None], A - 1,
                                         NC)[:, 0]
             + s_own[:, None] * v.index_select(0, own).to(torch.int32))
        wids.append(_table_wid(dg, m))
    sel = (ts.cs_feat.index_select(0, rec) / NC)[:, None].expand(-1, NC)
    return segment_reduce(torch.cat([sel, -sel], dim=-1),
                          torch.cat(wids, dim=-1), W)


def _sparse_grad_rows(dg, ts, C, c, r0, rc, D, A, own, nbrv, sel, W):
    """The sparse factors' gradient of one row chunk, both worlds side by
    side on the chain axis of ``own`` [rc, 2NC] and ``nbrv``
    [rc, D, A-1, 2NC]: ``sel`` [rc, D] (feat / NC on sparse owner records,
    else 0) at the evidence world's table weights and -sel at the free
    world's."""
    NC2 = own.shape[-1]
    NC = NC2 // 2
    stride = _rows(ts.cs_cwstride, C, c, r0, rc, D, A)
    ismine = _rows(ts.cs_ismine, C, c, r0, rc, D, A)
    s_own = torch.where(ismine, stride, 0).sum(dim=-1, dtype=torch.int32)
    m = (_rows(ts.cs_cwbase, C, c, r0, rc, D)[..., None]
         + _stride_sum(stride, nbrv, A - 1, NC2)
         + s_own[..., None] * own[:, None, :].to(torch.int32))
    sel = sel[..., None].expand(rc, D, NC)
    return segment_reduce(torch.cat([sel, -sel], dim=-1), _table_wid(dg, m),
                          W)


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
