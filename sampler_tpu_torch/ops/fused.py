"""Fused color steps (counterpart of sampler_tpu/ops/fused.py).

For an all-boolean tier whose factors have arity <= 2, the conditional
log-odds of variable b is affine in its neighbours' values:

    delta[b] = logit(v_b=1) - logit(v_b=0)
             = base[b] + sum_d beta[b,d] * v[nbr[b,d]]

with compile-time coefficients (affine_pairwise, copied from the JAX
package) folded with the weights once per weights value (fold_affine).
fused_color_draw then computes delta and draws ``u < sigmoid(delta)`` for a
whole color in one CUDA kernel (csrc/fused_color_draw.cu), or in its plain
PyTorch version on the CPU.

For the banded boolean tiers that form cannot take (arity 3, whose cross
term makes delta multilinear, and multi-window tiers, band_k >= 2) the
log-odds is

    delta[b] = base[b] + sum_d (b1·n1 + b2·n2 + bx·n1·n2)

over the one or two neighbour values n1, n2 of each incident factor, with
coefficients folded by fold_deltam_tiles; fused_dm_draw computes it and
draws in one CUDA kernel (csrc/fused_dm_draw.cu) or its plain version.
The boolean tiers with multilinear coefficients but no banding plan (the
KBC class's dense tiers, and the hub tier's chunks) take the same
log-odds with fold_deltam's coefficients and the global neighbour
positions of cs_nbr: dm_gather_draw gathers, sums and draws in one CUDA
kernel (csrc/dm_gather_draw.cu) or its plain version, and in its delta
mode writes the hub chunks' log-odds instead of drawing.  The JAX package
has no Pallas kernel there: XLA fuses its color_delta_multilin and the
Bernoulli draw into the jitted sweep.

For a categorical or mixed tier of arity <= 2 in which every factor has
one own slot (affinek), the log-potential of candidate k is

    l_k[b] = sum_d [eqo[b,d] == k] * (av[b,d] + bv[b,d] * e[b,d]) + kmask[b,k]

with e = [v[nbr[b,d]] == eqn[b,d]] and (av, bv) the candidate coefficients
of affine_cat folded with the weights by fold_affine_cat; fused_cat_draw
computes every l_k and draws by Gumbel-argmax in one CUDA kernel
(csrc/fused_cat_draw.cu) or its plain version.

The uniforms of all four draws come from the same counter hash
(portable_bits) that the JAX kernels use in interpret mode, so a kernel,
its plain version and the JAX kernel (where there is one) draw the same
bits for the same seed words.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import format_spec as fs
from ..observe import spanned
from ._build import check_tensor, launch
from .banded import _multi_rows


# --------------------------------------------------------------------------
# compile-time affine analysis (numpy, copied from the JAX package)
# --------------------------------------------------------------------------

def _phi_np(nlit, head, n, ftype, present=None):
    """Vectorized numpy twin of engine._phi_from_counts (float32).

    ``present``: iterable of factor-function ids actually in the graph —
    only those variants are evaluated (compile-time cost is proportional to
    the functions used, not all ten)."""
    if present is None:
        present = fs.ALL_FACTOR_FUNCS
    present = set(int(t) for t in present)
    f32 = np.float32

    def lin_stat():
        nbody = nlit - head.astype(np.int32)
        n_body = np.maximum(n - 1, 0)
        lin = np.where(head, n_body, n_body - nbody).astype(f32)
        return np.where(n == 1, head.astype(f32), lin)

    def variant(t):
        if t in (fs.FUNC_AND, fs.FUNC_AND_CATEGORICAL,
                 fs.FUNC_IMPLY_NATURAL):
            return nlit == n
        if t == fs.FUNC_OR:
            return nlit > 0
        if t == fs.FUNC_EQUAL:
            return (nlit == 0) | (nlit == n)
        if t == fs.FUNC_ISTRUE:
            return head
        if t == fs.FUNC_IMPLY_MLN:
            nbody = nlit - head.astype(np.int32)
            return np.where(nbody < np.maximum(n - 1, 0), f32(1.0),
                            head.astype(f32))
        if t == fs.FUNC_LINEAR:
            return lin_stat()
        if t == fs.FUNC_RATIO:
            return np.log1p(lin_stat())
        if t == fs.FUNC_LOGICAL:
            return lin_stat() > 0
        raise ValueError(f"unknown factor function type {t}")

    present = sorted(present)
    if len(present) == 1:
        return np.asarray(variant(present[0]), f32)
    out = np.zeros(np.shape(nlit), f32)
    for t in present:
        np.copyto(out, variant(t), where=(ftype == t))
    return out


def affine_pairwise(cs_pos, cs_mask, cs_ismine, cs_hmask, cs_type,
                    present=None):
    """Per-incidence affine coefficients (a, b) of delta-phi in the single
    neighbor value v:  phi(own=1, v) - phi(own=0, v) = a + b*v.

    All inputs [..., D, A] with A <= 2 (own-last slot permutation).
    Returns float32 (a, b) of shape [..., D].  Handles n_own == arity
    (repeated-variable / unary factors: b == 0) and padded records
    (mask all-False: a == b == 0 since every phi is constant there).
    """

    def phi(k, v):
        val = np.where(cs_ismine, k, v)
        lits = ((val == 1) == cs_pos) & cs_mask
        nlit = lits.sum(-1, dtype=np.int32)
        n = cs_mask.sum(-1, dtype=np.int32)
        head = (lits & cs_hmask).any(-1)
        return _phi_np(nlit, head, n, cs_type, present)

    d0 = phi(1, 0) - phi(0, 0)
    d1 = phi(1, 1) - phi(0, 1)
    return d0.astype(np.float32), (d1 - d0).astype(np.float32)



def affine_cat(cs_pos, cs_mask, cs_ismine, cs_hmask, cs_type, present=None):
    """K-candidate (categorical) affine analysis for arity<=2 tiers where
    every real incident factor has exactly ONE own slot (own-last slot A-1;
    neighbor slot 0).

    Literals are binary even for categorical variables — lit = (value ==
    eqpred) == ispos — so phi is a 4-point table T[olit, nlit] of
    compile-time constants, and the candidate-k log-potential of one
    incidence reduces (dropping k-independent terms, which cancel in the
    softmax) to

        wf * (a + b * e) * [k == eq_own],   e = [v_nbr == eq_nbr],

    with a = sgn_o*((T10-T00) + D*(1-pos_n)),  b = sgn_o*D*(2*pos_n-1),
    D = T11-T10-T01+T00, sgn_o = 2*pos_own-1.  Arity-1 incidences fall out
    automatically (neighbor slot masked -> T01==T00, T11==T10 -> b == 0).

    Returns float32 (a, b) of shape [..., D] (pre-weight coefficients;
    fold_affine_cat multiplies by wf at weights-change time).
    TPU-native replacement for the categorical branch of the reference's
    sample_single_variable inner loop (SURVEY.md §3.2, §2b).
    """

    def phi(o, ln):
        lits = np.where(cs_ismine, o, ln) & cs_mask
        nlit = lits.sum(-1, dtype=np.int32)
        n = cs_mask.sum(-1, dtype=np.int32)
        head = (lits & cs_hmask).any(-1)
        return _phi_np(nlit, head, n, cs_type, present)

    t00 = phi(False, False)
    t01 = phi(False, True)
    t10 = phi(True, False)
    t11 = phi(True, True)
    pos_o = cs_pos[..., -1]
    pos_n = cs_pos[..., 0]
    dd = t11 - t10 - t01 + t00
    sgn_o = np.where(pos_o, np.float32(1.0), np.float32(-1.0))
    a = sgn_o * ((t10 - t00) + dd * (~pos_n))
    b = sgn_o * dd * np.where(pos_n, np.float32(1.0), np.float32(-1.0))
    return a.astype(np.float32), b.astype(np.float32)



# --------------------------------------------------------------------------
# weight folds (once per weights value, outside the sweep loop)
# --------------------------------------------------------------------------

def _row_sum(x: torch.Tensor, D: int) -> torch.Tensor:
    """Per-row sum of a flat d-minor stream: below D = 64 added in the
    order d = 0..D-1, from D = 64 one reduction (the JAX fold's rule,
    _fold_base; a loop there is a launch a record, most of a KBC fold's
    host time)."""
    x = x.reshape(-1, D)
    if D >= 64:
        return x.sum(dim=1)
    acc = x[:, 0]
    for d in range(1, D):
        acc = acc + x[:, d]
    return acc


def _tile_rows(x: torch.Tensor, C: int, nt: int, TB: int,
               D: int) -> torch.Tensor:
    """[C, nt, D*TB] kernel rows, d-major within a tile, from a flat
    d-minor record stream."""
    return x.reshape(C, nt, TB, D).transpose(2, 3).reshape(C, nt, D * TB)


def fold_affine(ts, ti, C: int, weights: torch.Tensor) -> tuple:
    """(beta [C, ntiles, D*TB] d-major within a tile, base [C, ntiles, TB])
    for one affine2 tier: beta = wf * ab_b, base = sum_d wf * ab_a, with
    wf = weights[cs_wid] * cs_feat."""
    from ..compile import tier_geom
    from .weights import expand_wf

    B, D, _ = tier_geom(ts, ti, C)
    TB = ti.band_tb
    nt = B // TB
    wf = expand_wf(weights, ts.cs_wid, ts.cs_feat)
    beta = _tile_rows(wf * ts.ab_b, C, nt, TB, D)
    base = _row_sum(wf * ts.ab_a, D).reshape(C, nt, TB)
    return beta, base


def fold_affine_cat(ts, ti, C: int, weights: torch.Tensor) -> tuple:
    """(av, bv [C, ntiles, D*TB] d-major within a tile, kmask
    [C, ntiles, TB, K]) for one affinek tier: av = wf * cs_cka,
    bv = wf * cs_ckb with wf = weights[cs_wid] * cs_feat, and cm_kmask
    (0, or -1e30 for k >= card) in the kernel's tile layout."""
    from ..compile import tier_geom
    from .weights import expand_wf

    B, D, _ = tier_geom(ts, ti, C)
    TB = ti.band_tb
    nt = B // TB
    wf = expand_wf(weights, ts.cs_wid, ts.cs_feat)
    av = _tile_rows(wf * ts.cs_cka, C, nt, TB, D)
    bv = _tile_rows(wf * ts.cs_ckb, C, nt, TB, D)
    return av, bv, ts.cm_kmask.reshape(C, nt, TB, -1)


def fold_deltam(ts, ti, C: int, weights: torch.Tensor) -> tuple:
    """Weight-folded multilinear delta coefficients for one deltam tier:
    (base [C*B], b1 [C*B*D], b2, bx), flat; b2 and bx are None on pairwise
    tiers, whose coefficients are the affine streams ab_a / ab_b."""
    from ..compile import tier_geom
    from .weights import expand_wf

    B, D, _ = tier_geom(ts, ti, C)
    wf = expand_wf(weights, ts.cs_wid, ts.cs_feat)
    pairwise = ts.dm_b2.numel() == C
    a_src = ts.ab_a if ts.dm_a.numel() == C else ts.dm_a
    b1_src = ts.ab_b if ts.dm_b1.numel() == C else ts.dm_b1
    base = _row_sum(wf * a_src, D)
    b1 = wf * b1_src
    if pairwise:
        return base, b1, None, None
    return base, b1, wf * ts.dm_b2, wf * ts.dm_x


def fold_deltam_tiles(ts, ti, C: int, weights: torch.Tensor) -> tuple:
    """fold_deltam's coefficients in fused_dm_draw's tile layout, for one
    fusedm tier: (base [C, nt, TB], b1 [C, nt, D*TB] d-major within a
    tile, b2, bx like b1 — or None on pairwise tiers)."""
    from ..compile import tier_geom
    from .weights import expand_wf

    B, D, _ = tier_geom(ts, ti, C)
    TB = ti.band_tb
    nt = B // TB
    wf = expand_wf(weights, ts.cs_wid, ts.cs_feat)
    a_src = ts.ab_a if ts.dm_a.numel() == C else ts.dm_a
    b1_src = ts.ab_b if ts.dm_b1.numel() == C else ts.dm_b1
    base = _row_sum(wf * a_src, D).reshape(C, nt, TB)
    b1 = _tile_rows(wf * b1_src, C, nt, TB, D)
    if ts.dm_b2.numel() == C:            # pairwise: no cross terms
        return base, b1, None, None
    return (base, b1, _tile_rows(wf * ts.dm_b2, C, nt, TB, D),
            _tile_rows(wf * ts.dm_x, C, nt, TB, D))


# --------------------------------------------------------------------------
# the counter hash (bit for bit the JAX package's _portable_bits)
# --------------------------------------------------------------------------

M32 = 0xFFFFFFFF
KNUTH = 0x9E3779B1
PLAIN_CHUNK_TILES = 256


def _mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on uint32 values held in int64 (masked after every
    multiply: the wrapped int64 product keeps the right low 32 bits)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def u32(x, device=None) -> torch.Tensor:
    """An int or int32 tensor as its uint32 value, held in int64."""
    return torch.as_tensor(x, device=device).to(torch.int64) & M32


def hash_bits(cnt: torch.Tensor, s0: torch.Tensor,
              s1: torch.Tensor) -> torch.Tensor:
    """Two lowbias32 rounds with a seed word injected before each; all
    arguments uint32 values in int64, broadcast together."""
    return _mix(_mix(cnt ^ s0) ^ s1)


def portable_bits(shape, s0, s1, device=None) -> torch.Tensor:
    """Counter hash over ``shape = (rows, cols)`` with counter
    ``row*cols + col``: uint32 values held in int64.  ``s0`` / ``s1`` are
    ints or int32 tensors (a tensor ``s1`` of shape [n, 1, 1] gives n
    planes)."""
    rows, cols = shape
    cnt = (torch.arange(rows, dtype=torch.int64, device=device)[:, None]
           * cols + torch.arange(cols, dtype=torch.int64, device=device))
    return hash_bits(cnt, u32(s0, device), u32(s1, device))


def tile_seed(s1, t) -> torch.Tensor:
    """Second seed word of tile t: s1 ^ (t * 0x9E3779B1), wrapping."""
    return u32(s1) ^ ((u32(t) * KNUTH) & M32)


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """24-bit uniform in (0, 1) from hash bits: the JAX kernel's u."""
    return (((bits >> 8) & 0xFFFFFF).to(torch.float32) * (2.0 ** -24)
            + (2.0 ** -25))


# --------------------------------------------------------------------------
# where a draw goes: an output buffer, or straight into the world
# --------------------------------------------------------------------------

def _put(values, out, write, r0: int, r1: int, drawn) -> None:
    """Rows r0 .. r1 of a draw into ``out``, or in world-write mode
    (``write = (row0, mask)``) into the world's rows row0 + r0 .. of the
    block where its row mask selects them (none past the mask's length)."""
    if write is None:
        out[r0:r1] = drawn
        return
    row0, mask = write
    r1 = min(r1, mask.shape[0])
    if r1 > r0:
        blk = values[row0 + r0:row0 + r1]
        blk.copy_(torch.where(mask[r0:r1, None], drawn[:r1 - r0], blk))


def _write_target(name: str, values, write, n_rows: int, extra) -> tuple:
    """(result, out pointer, mask pointer, mask length) of a kernel launch:
    a new int8 [n_rows, NC] output, or in world-write mode the world, a
    pointer at its row of the block's first row, and the block's row mask
    (bool [n_block], n_block at most n_rows, the block inside the world)."""
    P, NC = values.shape
    if write is None:
        out = torch.empty((n_rows, NC), dtype=torch.int8,
                          device=values.device)
        return out, out.data_ptr(), None, 0
    row0, mask = write
    if extra:
        raise ValueError(f"{name}: no delta or logits output in world-write "
                         "mode")
    check_tensor(mask, "mask", torch.bool, values.device, 1)
    n = mask.shape[0]
    if not (0 <= row0 and 0 < n <= n_rows and row0 + n <= P):
        raise ValueError(f"{name}: block at row {row0} of {n} rows, {n_rows} "
                         f"rows drawn, world of {P}")
    return (values, values.data_ptr() + row0 * NC * values.element_size(),
            mask.data_ptr(), n)


# --------------------------------------------------------------------------
# the fused color step
# --------------------------------------------------------------------------

def fused_color_draw_plain(values, nbr_dmaj, starts, beta, base, c: int,
                           seed, W: int, TB: int, D: int,
                           return_delta: bool = False, write=None):
    """Plain PyTorch version of :func:`fused_color_draw`, over chunks of
    PLAIN_CHUNK_TILES tiles so its temporaries stay bounded (~0.3 GB at
    D=5, TB=128, 512 chains)."""
    nt = starts.shape[0]
    NC = values.shape[1]
    dev = values.device
    out = (torch.empty((nt * TB, NC), dtype=values.dtype, device=dev)
           if write is None else values)
    delta_all = (torch.empty((nt * TB, NC), dtype=torch.float32, device=dev)
                 if return_delta else None)
    s0, s1 = u32(seed[0]), u32(seed[1])
    cnt = (torch.arange(TB, dtype=torch.int64, device=dev)[:, None] * NC
           + torch.arange(NC, dtype=torch.int64, device=dev))
    for t0 in range(0, nt, PLAIN_CHUNK_TILES):
        t1 = min(nt, t0 + PLAIN_CHUNK_TILES)
        n = t1 - t0
        idx = nbr_dmaj[c, t0:t1].reshape(n, D, TB)
        local = idx - starts[t0:t1].reshape(n, 1, 1)
        inside = ((local >= 0) & (local < W))[..., None]
        v = values.index_select(0, idx.reshape(-1)).reshape(n, D, TB, NC)
        terms = torch.where(inside, beta[c, t0:t1].reshape(n, D, TB, 1)
                            * v.to(torch.float32), 0.0)
        acc = terms[:, 0]
        for d in range(1, D):
            acc = acc + terms[:, d]
        delta = acc + base[c, t0:t1].reshape(n, TB, 1)
        tt = torch.arange(t0, t1, dtype=torch.int64, device=dev)
        u = uniform24(hash_bits(cnt, s0, tile_seed(s1, tt).reshape(n, 1, 1)))
        rows = slice(t0 * TB, t1 * TB)
        _put(values, out, write, t0 * TB, t1 * TB,
             (u < torch.sigmoid(delta)).to(values.dtype).reshape(n * TB, NC))
        if return_delta:
            delta_all[rows] = delta.reshape(n * TB, NC)
    return (out, delta_all) if return_delta else out


@spanned("op.fused_color_draw", card=True)
def fused_color_draw(values, nbr_dmaj, starts, beta, base, c: int, seed,
                     W: int, TB: int, D: int, return_delta: bool = False,
                     write=None):
    """Draw color ``c`` of an affine2 tier.

    values int8 [P, NC]; nbr_dmaj int32 [C, >= ntiles, D*TB] (all colors,
    global positions, d-major within a tile); starts int32 [ntiles] (this
    color's window starts); beta f32 like nbr_dmaj; base f32
    [C, >= ntiles, TB]; seed int32 [2] (a tensor on values' device).
    Returns int8 [ntiles*TB, NC], and with ``return_delta`` also the f32
    log-odds delta of the same shape.

    World-write mode, ``write = (row0, mask)`` with ``mask`` bool [n]
    (n <= ntiles*TB; a tier's cm_resample or cm_resample_ev row): row g is
    drawn only where g < n and mask[g], straight into values[row0 + g]; the
    other rows of the world stay as they were.  The same seed gives the
    same draws as the output mode.  Returns ``values``.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``fused_color_draw.launches``)."""
    if values.device.type == "cpu":
        return fused_color_draw_plain(values, nbr_dmaj, starts, beta, base,
                                      c, seed, W, TB, D, return_delta, write)
    if values.device.type != "cuda":
        raise ValueError(f"fused_color_draw: no kernel for {values.device}")
    dev = values.device
    check_tensor(values, "values", torch.int8, dev, 2)
    check_tensor(nbr_dmaj, "nbr_dmaj", torch.int32, dev, 3)
    check_tensor(beta, "beta", torch.float32, dev, 3)
    check_tensor(base, "base", torch.float32, dev, 3)
    check_tensor(starts, "starts", torch.int32, dev, 1)
    check_tensor(seed, "seed", torch.int32, dev, 1)
    nt = starts.shape[0]
    P, NC = values.shape
    C = nbr_dmaj.shape[0]
    if (nbr_dmaj.shape[2] != D * TB or nbr_dmaj.shape[1] < nt
            or beta.shape != nbr_dmaj.shape or base.shape[0] != C
            or base.shape[1] < nt or base.shape[2] != TB
            or not 0 <= c < C or seed.shape[0] != 2 or not 0 < W <= P):
        raise ValueError(
            f"fused_color_draw: nbr {tuple(nbr_dmaj.shape)}, beta "
            f"{tuple(beta.shape)}, base {tuple(base.shape)}, starts "
            f"{tuple(starts.shape)}, c={c}, D={D}, TB={TB}, W={W}, P={P}")
    out, out_ptr, mask_ptr, n_write = _write_target(
        "fused_color_draw", values, write, nt * TB, return_delta)
    delta = (torch.empty((nt * TB, NC), dtype=torch.float32, device=dev)
             if return_delta else None)
    with torch.cuda.device(dev):
        launch("fused_color_draw_launch", values.data_ptr(), NC,
               nbr_dmaj[c].data_ptr(), beta[c].data_ptr(),
               base[c].data_ptr(), starts.data_ptr(), seed.data_ptr(),
               nt, TB, D, W, out_ptr,
               None if delta is None else delta.data_ptr(), mask_ptr,
               n_write, torch.cuda.current_stream(dev).cuda_stream)
    fused_color_draw.launches += 1
    return (out, delta) if return_delta else out


fused_color_draw.launches = 0


# --------------------------------------------------------------------------
# the fused multilinear color step
# --------------------------------------------------------------------------

PLAIN_CHUNK_ELEMS = 1 << 24     # (row, chain) pairs a plain chunk computes


def _dm_rows(dm_nbr, starts, c: int, t0: int, t1: int, W: int, TB: int,
             D: int, A1: int, Kw: int, P: int) -> tuple:
    """(row int64, valid bool), each [n, A1, D, TB], of tiles t0..t1 of
    color c: the values row each neighbour slot reads, and whether it reads
    one (else 0)."""
    n = t1 - t0
    idx = dm_nbr[c, t0:t1]
    if Kw >= 2:
        row, valid = _multi_rows(idx, starts[t0:t1], W, P)
        return row.reshape(n, A1, D, TB), valid.reshape(n, A1, D, TB)
    idx = idx.reshape(n, A1, D, TB).to(torch.int64)
    local = idx - starts[t0:t1].reshape(n, 1, 1, 1)
    valid = (local >= 0) & (local < W) & (idx >= 0) & (idx < P)
    return torch.where(valid, idx, 0), valid


def fused_dm_draw_plain(values, dm_nbr, starts, base, b1, b2, bx, c: int,
                        seed, W: int, TB: int, D: int, A1: int, Kw: int,
                        return_delta: bool = False, write=None):
    """Plain PyTorch version of :func:`fused_dm_draw`, over chunks of tiles
    whose [tiles, TB, NC] planes hold about PLAIN_CHUNK_ELEMS values, so
    its temporaries stay bounded (~0.4 GB) whatever the chain count."""
    nt = starts.shape[0]
    P, NC = values.shape
    dev = values.device
    f32 = torch.float32
    out = (torch.empty((nt * TB, NC), dtype=values.dtype, device=dev)
           if write is None else values)
    delta_all = (torch.empty((nt * TB, NC), dtype=f32, device=dev)
                 if return_delta else None)
    s0, s1 = u32(seed[0]), u32(seed[1])
    cnt = (torch.arange(TB, dtype=torch.int64, device=dev)[:, None] * NC
           + torch.arange(NC, dtype=torch.int64, device=dev))
    chunk = max(1, PLAIN_CHUNK_ELEMS // (TB * NC))
    for t0 in range(0, nt, chunk):
        t1 = min(nt, t0 + chunk)
        n = t1 - t0
        row, valid = _dm_rows(dm_nbr, starts, c, t0, t1, W, TB, D, A1, Kw,
                              P)

        def nval(a, d):
            v = values.index_select(0, row[:, a, d].reshape(-1))
            v = v.reshape(n, TB, NC).to(f32)
            return v.masked_fill_(~valid[:, a, d, :, None], 0.0)

        def coef(x, d):
            return x[c, t0:t1].reshape(n, D, TB)[:, d, :, None]

        delta = None
        for d in range(D):
            n1 = nval(0, d)
            contrib = coef(b1, d) * n1
            if A1 == 2:
                n2 = nval(1, d)
                contrib = (contrib + coef(b2, d) * n2
                           + coef(bx, d) * (n1 * n2))
            delta = contrib if delta is None else delta + contrib
        delta = delta + base[c, t0:t1].reshape(n, TB, 1)
        tt = torch.arange(t0, t1, dtype=torch.int64, device=dev)
        u = uniform24(hash_bits(cnt, s0, tile_seed(s1, tt).reshape(n, 1, 1)))
        rows = slice(t0 * TB, t1 * TB)
        _put(values, out, write, t0 * TB, t1 * TB,
             (u < torch.sigmoid(delta)).to(values.dtype).reshape(n * TB, NC))
        if return_delta:
            delta_all[rows] = delta.reshape(n * TB, NC)
    return (out, delta_all) if return_delta else out


@spanned("op.fused_dm_draw", card=True)
def fused_dm_draw(values, dm_nbr, starts, base, b1, b2, bx, c: int, seed,
                  W: int, TB: int, D: int, A1: int, Kw: int,
                  return_delta: bool = False, write=None):
    """Draw color ``c`` of a fusedm tier (boolean, arity <= 3, banded).

    values int8 [P, NC]; dm_nbr int32 [C, >= ntiles, A1*D*TB] (all colors,
    compile's bd_dmnbr: slot-major, then d-major, then the TB rows of a
    tile); starts int32 [ntiles] (Kw == 1: global window starts, dm_nbr
    holds global positions and a position outside [start, start + W)
    reads 0) or [ntiles, Kw] (Kw >= 2: dm_nbr holds indices remapped into
    the Kw windows laid end to end, the sentinel Kw*W reads 0); base f32
    [C, >= ntiles, TB]; b1, b2, bx f32 [C, >= ntiles, D*TB] from
    fold_deltam_tiles (b2, bx only when A1 == 2); seed int32 [2] (a tensor
    on values' device).  Slot 0 of a record is n1, slot 1 is n2, and

        delta = base + sum_d (b1*n1 + b2*n2 + bx*n1*n2),

    summed in that order; the draw is ``u < sigmoid(delta)`` with u from
    the counter hash of fused_color_draw.  Returns int8 [ntiles*TB, NC],
    and with ``return_delta`` also the f32 delta of the same shape; in
    world-write mode (``write``, as in fused_color_draw) ``values``.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``fused_dm_draw.launches``)."""
    if values.device.type == "cpu":
        return fused_dm_draw_plain(values, dm_nbr, starts, base, b1, b2, bx,
                                   c, seed, W, TB, D, A1, Kw, return_delta,
                                   write)
    if values.device.type != "cuda":
        raise ValueError(f"fused_dm_draw: no kernel for {values.device}")
    dev = values.device
    check_tensor(values, "values", torch.int8, dev, 2)
    check_tensor(dm_nbr, "dm_nbr", torch.int32, dev, 3)
    check_tensor(starts, "starts", torch.int32, dev, 1 if Kw == 1 else 2)
    check_tensor(base, "base", torch.float32, dev, 3)
    coefs = (b1, b2, bx) if A1 == 2 else (b1,)
    for name, x in zip(("b1", "b2", "bx"), coefs):
        check_tensor(x, name, torch.float32, dev, 3)
    check_tensor(seed, "seed", torch.int32, dev, 1)
    nt = starts.shape[0]
    P, NC = values.shape
    C = dm_nbr.shape[0]
    R = D * TB
    if (A1 not in (1, 2) or Kw < 1 or dm_nbr.shape[1] < nt
            or dm_nbr.shape[2] != A1 * R
            or any(x.shape[0] != C or x.shape[1] < nt or x.shape[2] != R
                   for x in coefs)
            or base.shape[0] != C or base.shape[1] < nt
            or base.shape[2] != TB or (Kw >= 2 and starts.shape[1] != Kw)
            or not 0 <= c < C or seed.shape[0] != 2 or not 0 < W <= P):
        raise ValueError(
            f"fused_dm_draw: dm_nbr {tuple(dm_nbr.shape)}, coefficients "
            f"{[tuple(x.shape) for x in coefs]}, base {tuple(base.shape)}, "
            f"starts {tuple(starts.shape)}, c={c}, W={W}, TB={TB}, D={D}, "
            f"A1={A1}, Kw={Kw}, P={P}")
    out, out_ptr, mask_ptr, n_write = _write_target(
        "fused_dm_draw", values, write, nt * TB, return_delta)
    delta = (torch.empty((nt * TB, NC), dtype=torch.float32, device=dev)
             if return_delta else None)
    b2c, bxc = (b2[c].data_ptr(), bx[c].data_ptr()) if A1 == 2 else (None,
                                                                     None)
    with torch.cuda.device(dev):
        launch("fused_dm_draw_launch", values.data_ptr(), NC, P,
               dm_nbr[c].data_ptr(), b1[c].data_ptr(), b2c, bxc,
               base[c].data_ptr(), starts.data_ptr(), seed.data_ptr(), nt,
               TB, D, A1, W, Kw, out_ptr,
               None if delta is None else delta.data_ptr(), mask_ptr,
               n_write, torch.cuda.current_stream(dev).cuda_stream)
    fused_dm_draw.launches += 1
    return (out, delta) if return_delta else out


fused_dm_draw.launches = 0


# --------------------------------------------------------------------------
# the multilinear gather-draw of the unbanded deltam tiers
# --------------------------------------------------------------------------

DM_TILE_ROWS = 128      # rows a tile of dm_gather_draw's counter hash
DM_SEGMENT = 16         # records a segment of dm_gather_draw's sum
DM_MAX_TIERS = 8        # tiers one dm_gather_draw launch takes
DM_HUB_LANES = 64       # segments of a hub row that a block sums at once
_DM_FIELDS = 16         # int64 fields a tier in the launch table


class DmTier(NamedTuple):
    """One tier's streams of one color for :func:`dm_gather_draw_tiers`.

    nbr int32 [B, D, A1] (global positions, A1 = arity - 1 = 1 or 2; a
    position outside [0, P) reads 0), base f32 [B], b1, b2, bx f32 [B, D]
    (this color's rows of fold_deltam; b2, bx None when A1 == 1).  A hub
    tier's streams are its [M, G, A1] chunks and [M] chunk bases, and
    ``rows`` int32 [Bh + 1] its rows' chunk offsets: row g is chunks
    rows[g] .. rows[g+1]-1 (consecutive) and has Bh rows; rows None for a
    dense tier.  ``write`` None draws into a new int8 [B, NC] output;
    (row0, mask) draws into the world (world-write mode, as in
    fused_color_draw)."""
    nbr: torch.Tensor
    base: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor | None
    bx: torch.Tensor | None
    rows: torch.Tensor | None = None
    write: tuple | None = None

    def n_rows(self) -> int:
        return (self.nbr.shape[0] if self.rows is None
                else self.rows.shape[0] - 1)

    def lanes(self) -> int:
        """The kernel's lanes a row: 1 (a thread a row's chains) for a row
        of one segment, else the segments a block sums at once."""
        if self.rows is not None:
            return DM_HUB_LANES
        nseg = -(-self.nbr.shape[1] // DM_SEGMENT)
        return 1 if nseg <= 1 else 16 if nseg <= 16 else (
            32 if nseg <= 32 else 64)


def _dm_check(values, tier: DmTier, draw: bool) -> None:
    """Raise unless the shapes of one tier of a dm_gather_draw call agree."""
    nbr, base, b1, b2, bx, rows, write = tier
    M, D, A1 = nbr.shape
    P, NC = values.shape
    cross = (b2, bx) if A1 == 2 else ()
    ok = (A1 in (1, 2) and tuple(base.shape) == (M,)
          and all(x is not None and tuple(x.shape) == (M, D)
                  for x in (b1, *cross))
          and (A1 == 2 or (b2 is None and bx is None))
          and (draw or write is None) and DM_TILE_ROWS * NC <= 1 << 32
          and (rows is None or (rows.dim() == 1 and rows.shape[0] >= 1
                                and rows.dtype == torch.int32)))
    if ok and write is not None:
        row0, mask = write
        n = mask.shape[0]
        ok = (mask.dtype == torch.bool and mask.dim() == 1 and row0 >= 0
              and 0 < n <= tier.n_rows() and row0 + n <= P)
    if not ok:
        where = None if write is None else (write[0], tuple(write[1].shape))
        raise ValueError(
            f"dm_gather_draw: nbr {tuple(nbr.shape)}, base "
            f"{tuple(base.shape)}, coefficients "
            f"{[None if x is None else tuple(x.shape) for x in (b1, b2, bx)]}"
            f", rows {None if rows is None else tuple(rows.shape)}, NC={NC}, "
            f"seed {'given' if draw else 'absent'}, write {where}, world of "
            f"{P} rows")


def _dm_check_rows(rows, M: int) -> None:
    """Raise unless a hub tier's chunk offsets ``rows`` lie in [0, M] and
    do not decrease (the kernel reads a row's chunks unchecked)."""
    r = rows.to("cpu", torch.int64)
    if (r.numel() == 0 or int(r[0]) < 0 or int(r[-1]) > M
            or bool((r[1:] < r[:-1]).any())):
        raise ValueError(f"dm_gather_draw: hub chunk offsets outside "
                         f"[0, {M}] or decreasing")


def _dm_terms(values, nbr, b1, b2, bx) -> torch.Tensor:
    """Each record's term b1*n1 + b2*n2 + bx*(n1*n2), f32 [n, D, NC], with
    n1, n2 the world's values at its positions (0 outside [0, P))."""
    n, D, A1 = nbr.shape
    P, NC = values.shape
    idx = nbr.to(torch.int64)
    valid = (idx >= 0) & (idx < P)
    v = values.index_select(0, torch.where(valid, idx, 0).reshape(-1))
    v = v.reshape(n, D, A1, NC).to(torch.float32).masked_fill_(
        ~valid[..., None], 0.0)
    n1 = v[:, :, 0]
    terms = b1[:, :, None] * n1
    if A1 == 2:
        n2 = v[:, :, 1]
        terms = terms + b2[:, :, None] * n2 + bx[:, :, None] * (n1 * n2)
    return terms


def ordered_sum(terms: torch.Tensor) -> torch.Tensor:
    """Σ over axis 1 of ``terms`` [n, R, NC] (R >= 1) in dm_gather_draw's
    fixed order: segments of DM_SEGMENT records, each summed in the order
    of the records, then the segments added in order,
    ((seg0 + seg1) + seg2) + ...; R <= DM_SEGMENT is one segment, summed
    in the order of the records."""
    n, R, NC = terms.shape
    S = DM_SEGMENT
    full = R // S if R > S else 0
    tot = None
    if full:
        x = terms[:, :full * S].reshape(n, full, S, NC)
        seg = x[:, :, 0]
        for s in range(1, S):
            seg = seg + x[:, :, s]
        tot = seg[:, 0]
        for k in range(1, full):
            tot = tot + seg[:, k]
    if R > full * S:
        tail = terms[:, full * S]
        for d in range(full * S + 1, R):
            tail = tail + terms[:, d]
        tot = tail if tot is None else tot + tail
    return tot


def _hash_draw(values, delta, rows: torch.Tensor, seed) -> torch.Tensor:
    """The draws u < sigmoid(delta) of rows ``rows`` (int64 [n]) of a tier,
    u from the counter hash over tiles of DM_TILE_ROWS rows."""
    NC = values.shape[1]
    lanes = torch.arange(NC, dtype=torch.int64, device=values.device)
    cnt = (rows % DM_TILE_ROWS)[:, None] * NC + lanes
    u = uniform24(hash_bits(cnt, u32(seed[0]), tile_seed(
        seed[1], rows // DM_TILE_ROWS)[:, None]))
    return (u < torch.sigmoid(delta)).to(values.dtype)


def _dm_dense_plain(values, tier: DmTier, seed, return_delta: bool):
    """One dense tier of dm_gather_draw_tiers_plain, over chunks of rows
    whose gathered [rows, D, A1, NC] values hold about PLAIN_CHUNK_ELEMS
    elements."""
    nbr, base, b1, b2, bx, _, write = tier
    B, D, A1 = nbr.shape
    NC = values.shape[1]
    dev = values.device
    draw = seed is not None
    out = (torch.empty((B, NC), dtype=values.dtype, device=dev)
           if draw and write is None else values)
    delta_all = (torch.empty((B, NC), dtype=torch.float32, device=dev)
                 if return_delta or not draw else None)
    chunk = max(1, PLAIN_CHUNK_ELEMS // max(1, D * A1 * NC))
    for r0 in range(0, B, chunk):
        r1 = min(B, r0 + chunk)
        cross = (None, None) if A1 == 1 else (b2[r0:r1], bx[r0:r1])
        delta = ordered_sum(_dm_terms(values, nbr[r0:r1], b1[r0:r1],
                                      *cross)) + base[r0:r1, None]
        if delta_all is not None:
            delta_all[r0:r1] = delta
        if draw:
            rows = torch.arange(r0, r1, dtype=torch.int64, device=dev)
            _put(values, out, write, r0, r1,
                 _hash_draw(values, delta, rows, seed))
    return out, delta_all


def _dm_hub_plain(values, tier: DmTier, seed, return_delta: bool):
    """One hub tier of dm_gather_draw_tiers_plain: each row's chunks as one
    deep row, the rows padded to the most chunks a row has, over chunks of
    rows.  A pad chunk's records and base are +0: adding them leaves every
    sum unchanged (a -0 may become +0), so the order is the kernel's."""
    nbr, base, b1, b2, bx, rows, write = tier
    M, G, A1 = nbr.shape
    NC = values.shape[1]
    dev = values.device
    offs = rows.to(torch.int64)
    n_ck = offs[1:] - offs[:-1]
    Bh = n_ck.shape[0]
    _dm_check_rows(rows, M)
    kmax = int(n_ck.max()) if Bh else 0
    draw = seed is not None
    out = (torch.empty((Bh, NC), dtype=values.dtype, device=dev)
           if draw and write is None else values)
    delta_all = (torch.empty((Bh, NC), dtype=torch.float32, device=dev)
                 if return_delta or not draw else None)
    step = max(1, PLAIN_CHUNK_ELEMS // max(1, kmax * G * A1 * NC))
    ks = torch.arange(kmax, device=dev)
    for r0 in range(0, Bh, step):
        r1 = min(Bh, r0 + step)
        n = r1 - r0
        if kmax == 0:
            delta = torch.zeros((n, NC), dtype=torch.float32, device=dev)
        else:
            valid = ks < n_ck[r0:r1, None]                  # [n, kmax]
            ck = torch.where(valid, offs[r0:r1, None] + ks, 0).reshape(-1)

            def deep(x):            # [n*kmax, G] -> [n, kmax*G], pads +0
                if x is None:
                    return None
                y = x.index_select(0, ck).reshape(n, kmax, G)
                return torch.where(valid[..., None], y, 0.0).reshape(
                    n, kmax * G)

            tot = ordered_sum(_dm_terms(
                values, nbr.index_select(0, ck).reshape(n, kmax * G, A1),
                deep(b1), deep(b2), deep(bx)))
            bb = torch.where(valid, base.index_select(0, ck).reshape(
                n, kmax), 0.0)
            bs = bb[:, 0]
            for j in range(1, kmax):    # the chunks' bases in chunk order
                bs = bs + bb[:, j]
            delta = tot + bs[:, None]
        if delta_all is not None:
            delta_all[r0:r1] = delta
        if draw:
            g = torch.arange(r0, r1, dtype=torch.int64, device=dev)
            _put(values, out, write, r0, r1,
                 _hash_draw(values, delta, g, seed))
    return out, delta_all


def dm_gather_draw_tiers_plain(values, tiers, seeds,
                               return_delta: bool = False) -> list:
    """Plain PyTorch version of :func:`dm_gather_draw_tiers`: the tiers one
    after another (in world-write mode each reads the world the earlier
    ones wrote, which no row of another tier of the color reads)."""
    draw = seeds is not None
    if draw and tuple(seeds.shape) != (len(tiers), 2):
        raise ValueError(f"dm_gather_draw: seeds {tuple(seeds.shape)} for "
                         f"{len(tiers)} tiers")
    results = []
    for t, tier in enumerate(tiers):
        tier = DmTier(*tier)
        _dm_check(values, tier, draw)
        if tier.write is not None and return_delta:
            raise ValueError("dm_gather_draw: no delta output in "
                             "world-write mode")
        seed = seeds[t] if draw else None
        plain = _dm_dense_plain if tier.rows is None else _dm_hub_plain
        out, delta = plain(values, tier, seed, return_delta)
        results.append(delta if not draw else
                       (out, delta) if return_delta else out)
    return results


def dm_tier_table(tiers, outs=None, deltas=None) -> np.ndarray:
    """The kernel's launch table, int64 [T, 16] (csrc/dm_gather_draw.cu,
    dm_gather_draw_launch), of up to DM_MAX_TIERS tiers on one device:
    their streams checked once (type, device, contiguity), their rows and
    their targets: ``outs[t]`` int8 [B, NC] or None, ``deltas[t]`` f32
    [B, NC] or None, a tier's ``write`` the world-write mode.  Built once
    a graph for the engine's plan, so a color step checks nothing again
    (a hub tier's chunk offsets are read back to the host here)."""
    T = len(tiers)
    if not 1 <= T <= DM_MAX_TIERS:
        raise ValueError(f"dm_gather_draw: {T} tiers, 1 to {DM_MAX_TIERS} "
                         "a launch")
    table = np.zeros((T, _DM_FIELDS), np.int64)
    for i, tier in enumerate(tiers):
        tier = DmTier(*tier)
        nbr, base, b1, b2, bx, rows, write = tier
        dev = nbr.device
        check_tensor(nbr, "nbr", torch.int32, dev, 3)
        check_tensor(base, "base", torch.float32, dev, 1)
        B, D, A1 = nbr.shape
        coefs = (b1, b2, bx) if A1 == 2 else (b1,)
        for name, x in zip(("b1", "b2", "bx"), coefs):
            check_tensor(x, name, torch.float32, dev, 2)
        if rows is not None:
            check_tensor(rows, "rows", torch.int32, dev, 1)
            _dm_check_rows(rows, B)
        row0, mask, n_write = -1, None, 0
        if write is not None:
            row0, mask = write
            check_tensor(mask, "mask", torch.bool, dev, 1)
            n_write = mask.shape[0]
        out = None if outs is None else outs[i]
        delta = None if deltas is None else deltas[i]

        def ptr(x):
            return 0 if x is None else x.data_ptr()

        table[i] = (ptr(nbr), ptr(b1), ptr(b2 if A1 == 2 else None),
                    ptr(bx if A1 == 2 else None), ptr(base), ptr(rows),
                    ptr(out), ptr(delta), ptr(mask), row0, tier.n_rows(),
                    D, A1, n_write, tier.lanes(), B * D)
    return table


@spanned("op.dm_gather_draw", card=True)
def dm_gather_draw_table(values, table: np.ndarray, seeds) -> None:
    """Launch the kernel on a table of dm_tier_table (its tiers' streams on
    ``values``' card): one launch for all its tiers.  ``seeds`` int32
    [T, 2] on the card, or None in the delta mode."""
    dev = values.device
    check_tensor(values, "values", torch.int8, dev, 2)
    T = table.shape[0]
    if seeds is not None:
        check_tensor(seeds, "seeds", torch.int32, dev, 2)
        if tuple(seeds.shape) != (T, 2):
            raise ValueError(f"dm_gather_draw: seeds {tuple(seeds.shape)} "
                             f"for {T} tiers")
    P, NC = values.shape
    if NC == 0 or not (table[:, 10] > 0).any():
        return
    with torch.cuda.device(dev):
        launch("dm_gather_draw_launch", values.data_ptr(), NC, P,
               table.ctypes.data, T,
               None if seeds is None else seeds.data_ptr(), DM_TILE_ROWS,
               torch.cuda.current_stream(dev).cuda_stream)
    dm_gather_draw.launches += 1


def dm_gather_draw_tiers(values, tiers, seeds,
                         return_delta: bool = False) -> list:
    """Draw every tier of ``tiers`` (DmTier, at most DM_MAX_TIERS: the
    deltam tiers of one color without a banded plan, whose rows share no
    factor) in one launch, or (``seeds`` None, the delta mode) return
    their log-odds.

    values int8 [P, NC]; seeds int32 [T, 2] (a tensor on values' device),
    a row of seed words a tier, or None.  For each tier, row g and chain n

        delta = base + sum_d (b1*n1 + b2*n2 + bx*n1*n2),

    each record's term rounded one operation at a time, the records cut
    into segments of DM_SEGMENT summed in their order, the segments added
    in order (((seg0 + seg1) + seg2) + ...), then base.  A hub row's
    records are its chunks' (chunk order, then slot order) and its base
    the sum of its chunks' bases in chunk order.  The draw is
    ``u < sigmoid(delta)`` with u the counter hash's uniform over tiles
    of DM_TILE_ROWS rows with the tier's seed words: row g is row
    g % DM_TILE_ROWS of tile g // DM_TILE_ROWS, as in fused_dm_draw.
    Returns a list, a tier each: int8 [B, NC] (``values`` in world-write
    mode), with ``return_delta`` (out, delta f32 [B, NC]), in the delta
    mode delta.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``dm_gather_draw.launches``)."""
    if values.device.type == "cpu":
        return dm_gather_draw_tiers_plain(values, tiers, seeds, return_delta)
    if values.device.type != "cuda":
        raise ValueError(f"dm_gather_draw: no kernel for {values.device}")
    dev = values.device
    check_tensor(values, "values", torch.int8, dev, 2)
    draw = seeds is not None
    P, NC = values.shape
    outs, deltas, results = [], [], []
    for tier in tiers:
        tier = DmTier(*tier)
        _dm_check(values, tier, draw)
        if tier.write is not None and return_delta:
            raise ValueError("dm_gather_draw: no delta output in "
                             "world-write mode")
        B = tier.n_rows()
        out = (torch.empty((B, NC), dtype=torch.int8, device=dev)
               if draw and tier.write is None else None)
        delta = (torch.empty((B, NC), dtype=torch.float32, device=dev)
                 if return_delta or not draw else None)
        outs.append(out)
        deltas.append(delta)
        res = values if draw and out is None else out
        results.append(delta if not draw else
                       (res, delta) if return_delta else res)
    dm_gather_draw_table(values, dm_tier_table(tiers, outs, deltas), seeds)
    return results


def _one_tier(values, nbr, base, b1, b2, bx, seed, write, rows) -> tuple:
    if seed is not None and tuple(seed.shape) != (2,):
        raise ValueError(f"dm_gather_draw: seed {tuple(seed.shape)}")
    return ([DmTier(nbr, base, b1, b2, bx, rows, write)],
            None if seed is None else seed.reshape(1, 2))


def dm_gather_draw_plain(values, nbr, base, b1, b2, bx, seed,
                         return_delta: bool = False, write=None, rows=None):
    """Plain PyTorch version of :func:`dm_gather_draw` (one tier of
    dm_gather_draw_tiers_plain)."""
    tiers, seeds = _one_tier(values, nbr, base, b1, b2, bx, seed, write,
                             rows)
    return dm_gather_draw_tiers_plain(values, tiers, seeds, return_delta)[0]


def dm_gather_draw(values, nbr, base, b1, b2, bx, seed,
                   return_delta: bool = False, write=None, rows=None):
    """Draw one color of one deltam tier (:func:`dm_gather_draw_tiers` with
    one tier and ``seed`` int32 [2] its seed words), or (``seed`` None,
    the delta mode) return its log-odds.  ``rows`` makes it a hub tier
    (DmTier).  Returns int8 [B, NC], with ``return_delta`` also the f32
    delta [B, NC]; in world-write mode ``values``; in the delta mode the
    delta alone.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``dm_gather_draw.launches``)."""
    if values.device.type == "cpu":
        return dm_gather_draw_plain(values, nbr, base, b1, b2, bx, seed,
                                    return_delta, write, rows)
    if values.device.type != "cuda":
        raise ValueError(f"dm_gather_draw: no kernel for {values.device}")
    tiers, seeds = _one_tier(values, nbr, base, b1, b2, bx, seed, write,
                             rows)
    return dm_gather_draw_tiers(values, tiers, seeds, return_delta)[0]


dm_gather_draw.launches = 0


# --------------------------------------------------------------------------
# the K-candidate (categorical) color step
# --------------------------------------------------------------------------

def fused_cat_draw_plain(values, nbr_dmaj, starts, eqo, eqn, av, bv, kmask,
                         c: int, seed, W: int, TB: int, D: int, K: int,
                         return_logits: bool = False, write=None):
    """Plain PyTorch version of :func:`fused_cat_draw`, over chunks of
    tiles whose D [tiles, TB, NC] contribution planes hold about
    PLAIN_CHUNK_ELEMS values, so its temporaries stay bounded (~0.4 GB)
    whatever the chain count."""
    nt = starts.shape[0]
    P, NC = values.shape
    dev = values.device
    f32 = torch.float32
    out = (torch.empty((nt * TB, NC), dtype=values.dtype, device=dev)
           if write is None else values)
    logits_all = (torch.empty((nt * TB, K, NC), dtype=f32, device=dev)
                  if return_logits else None)
    s0, s1 = u32(seed[0]), u32(seed[1])
    cnt = (torch.arange(TB, dtype=torch.int64, device=dev)[:, None] * NC
           + torch.arange(NC, dtype=torch.int64, device=dev))
    chunk = max(1, PLAIN_CHUNK_ELEMS // (TB * NC * D))
    for t0 in range(0, nt, chunk):
        t1 = min(nt, t0 + chunk)
        n = t1 - t0

        def tile(x):
            return x[c, t0:t1].reshape(n, D, TB)

        idx = tile(nbr_dmaj).to(torch.int64)
        local = idx - starts[t0:t1].reshape(n, 1, 1)
        valid = (local >= 0) & (local < W) & (idx >= 0) & (idx < P)
        row = torch.where(valid, idx, 0)
        eqo_t, eqn_t, av_t, bv_t = (tile(x) for x in (eqo, eqn, av, bv))
        contrib = []                     # av + bv * e, one [n, TB, NC] a d
        for d in range(D):
            v = values.index_select(0, row[:, d].reshape(-1))
            v = v.reshape(n, TB, NC).masked_fill_(~valid[:, d, :, None], 0)
            e = (v.to(torch.int32) == eqn_t[:, d, :, None]).to(f32)
            contrib.append(av_t[:, d, :, None] + bv_t[:, d, :, None] * e)
        tseed = tile_seed(s1, torch.arange(t0, t1, dtype=torch.int64,
                                           device=dev))
        best = best_k = None
        for k in range(K):
            lk = None
            for d in range(D):
                term = torch.where(eqo_t[:, d, :, None] == k, contrib[d],
                                   0.0)
                lk = term if lk is None else lk + term
            lk = lk + kmask[c, t0:t1, :, k, None]
            kseed = tseed ^ ((KNUTH * (k + 1)) & M32)
            u = uniform24(hash_bits(cnt, s0, kseed.reshape(n, 1, 1)))
            score = lk - torch.log(-torch.log(u))
            if best is None:
                best = score
                best_k = torch.zeros(score.shape, dtype=torch.int64,
                                     device=dev)
            else:
                take = score > best
                best = torch.where(take, score, best)
                best_k = torch.where(take, k, best_k)
            if return_logits:
                logits_all[t0 * TB:t1 * TB, k] = lk.reshape(n * TB, NC)
        _put(values, out, write, t0 * TB, t1 * TB,
             best_k.reshape(n * TB, NC).to(values.dtype))
    return (out, logits_all) if return_logits else out


@spanned("op.fused_cat_draw", card=True)
def fused_cat_draw(values, nbr_dmaj, starts, eqo, eqn, av, bv, kmask,
                   c: int, seed, W: int, TB: int, D: int, K: int,
                   return_logits: bool = False, write=None):
    """Draw color ``c`` of an affinek tier among K candidates.

    values int8 [P, NC]; nbr_dmaj int32 [C, >= ntiles, D*TB] (all colors,
    compile's bd_nbr: global positions, d-major within a tile; a position
    outside [start, start + W), or at or past P, reads 0); starts int32
    [ntiles] (this color's window starts); eqo, eqn int32 like nbr_dmaj
    (bd_eqo, bd_eqn: the own slot's and the neighbour slot's equality
    predicates); av, bv f32 like nbr_dmaj and kmask f32 [C, >= ntiles, TB,
    K] from fold_affine_cat; seed int32 [2] (a tensor on values' device).
    With e = [gathered == eqn],

        l_k = sum_d [eqo == k] * (av + bv * e) + kmask[:, k],

    summed in the order d = 0 .. D-1 (a zero term where eqo != k), then
    kmask.  The draw is the Gumbel-argmax of l_k - log(-log u_k), u_k from
    the counter hash with second seed word
    seed[1] ^ t*0x9E3779B1 ^ (k+1)*0x9E3779B1; a later candidate wins only
    with a strictly larger score.  Returns int8 [ntiles*TB, NC], and with
    ``return_logits`` also the f32 l_k as [ntiles*TB, K, NC]; in
    world-write mode (``write``, as in fused_color_draw) ``values``.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``fused_cat_draw.launches``)."""
    if values.device.type == "cpu":
        return fused_cat_draw_plain(values, nbr_dmaj, starts, eqo, eqn, av,
                                    bv, kmask, c, seed, W, TB, D, K,
                                    return_logits, write)
    if values.device.type != "cuda":
        raise ValueError(f"fused_cat_draw: no kernel for {values.device}")
    dev = values.device
    check_tensor(values, "values", torch.int8, dev, 2)
    check_tensor(starts, "starts", torch.int32, dev, 1)
    for name, x in (("nbr_dmaj", nbr_dmaj), ("eqo", eqo), ("eqn", eqn)):
        check_tensor(x, name, torch.int32, dev, 3)
    for name, x in (("av", av), ("bv", bv)):
        check_tensor(x, name, torch.float32, dev, 3)
    check_tensor(kmask, "kmask", torch.float32, dev, 4)
    check_tensor(seed, "seed", torch.int32, dev, 1)
    nt = starts.shape[0]
    P, NC = values.shape
    C = nbr_dmaj.shape[0]
    R = D * TB
    if (any(x.shape[0] != C or x.shape[1] < nt or x.shape[2] != R
            for x in (nbr_dmaj, eqo, eqn, av, bv))
            or kmask.shape[0] != C or kmask.shape[1] < nt
            or tuple(kmask.shape[2:]) != (TB, K) or not 2 <= K <= 127
            or not 0 <= c < C or seed.shape[0] != 2 or not 0 < W <= P):
        raise ValueError(
            f"fused_cat_draw: nbr {tuple(nbr_dmaj.shape)}, eqo "
            f"{tuple(eqo.shape)}, eqn {tuple(eqn.shape)}, av "
            f"{tuple(av.shape)}, bv {tuple(bv.shape)}, kmask "
            f"{tuple(kmask.shape)}, starts {tuple(starts.shape)}, c={c}, "
            f"W={W}, TB={TB}, D={D}, K={K}, P={P}")
    out, out_ptr, mask_ptr, n_write = _write_target(
        "fused_cat_draw", values, write, nt * TB, return_logits)
    logits = (torch.empty((nt * TB, K, NC), dtype=torch.float32, device=dev)
              if return_logits else None)
    with torch.cuda.device(dev):
        launch("fused_cat_draw_launch", values.data_ptr(), NC, P,
               nbr_dmaj[c].data_ptr(), eqo[c].data_ptr(), eqn[c].data_ptr(),
               av[c].data_ptr(), bv[c].data_ptr(), kmask[c].data_ptr(),
               starts.data_ptr(), seed.data_ptr(), nt, TB, D, K, W,
               out_ptr, None if logits is None else logits.data_ptr(),
               mask_ptr, n_write, torch.cuda.current_stream(dev).cuda_stream)
    fused_cat_draw.launches += 1
    return (out, logits) if return_logits else out


fused_cat_draw.launches = 0
