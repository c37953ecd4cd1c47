"""The weight gradient's kernels: ``grad_pair_tile``, the moment-factored
contrastive gradient of one color of an affine2 tier (counterpart of
sampler_tpu/ops/grad.py, ``grad_pair_tile``), and ``grad_records_sum``,
the records route's gradient of every other tier: the owner records'
contributions on the cs streams, summed by weight on the card (the
row-chunk body of the JAX package's mc_weight_gradient_cs, which XLA
fuses; csrc/grad_records.cu).  ``grad_records``, a tier's per-record
contributions (zero off the owner mask), is the route before
``grad_records_sum``; its plain version is the per-record math that
``grad_records_sum_plain`` runs a tier at a time.

``grad_pair_tile``:

For an affine2 tier (pairwise boolean) φ of one incidence record is
bilinear in the binary own value o and the neighbour value n:

    φ(o, n) = p00 + ao·o + an·n + ax·o·n        (compile-time ao, an, ax)

so the signed sum over the chains that the gradient needs factors into
three integer moments per record (sgn = +1 in the evidence world, −1 in
the free world; p00 cancels):

    Σ_chains sgn·φ = ao·So + an·Sn + ax·Sx
    So = Σ sgn·own,  Sn = Σ sgn·v[nbr],  Sx = Σ sgn·own·v[nbr]

A neighbour outside its tile's window ``[starts[t], starts[t] + W)``, or
outside ``[0, P)``, contributes 0 to Sn and Sx (the TPU kernel's one-hot
window).  The partial of tile t for weight w is
Σ_r [wid[r] == w]·coef[r]·(ao·So + an·Sn + ax·Sx) over the tile's D·TB
records; the caller sums the partials over the tiles and divides by the
chain count.

The CUDA kernel (csrc/grad_pair_tile.cu) reads the two worlds through two
pointers, so no [P, 2NC] concatenation of them is made; its plain version
here repeats its arithmetic in bounded tile batches: integer moments, then
the coefficient arithmetic (``coef*((ao*So + an*Sn) + ax*Sx)``) and the
per-tile sums in float64, rounded to float32 once per partial.  The two
add a tile's records in different orders, so they may differ only in
float64 rounding before that one float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import format_spec as fs
from ..observe import spanned
from ._build import check_tensor, launch
from .weights import segment_reduce

GRAD_W_MAX = 64                 # weights a kernel launch accumulates
PLAIN_CHUNK_TILES = 64
RECORD_CHUNK_ELEMS = 1 << 26    # (row, record, slot, chain) a plain chunk


def _check_shapes(v_ev, v_free, nbr_dmaj, starts, streams, c, own0, W, TB,
                  D, n_weights) -> None:
    nt = starts.shape[0]
    P, NC = v_ev.shape
    C = nbr_dmaj.shape[0]
    if (v_free.shape != v_ev.shape or nbr_dmaj.dim() != 3
            or nbr_dmaj.shape[2] != D * TB or nbr_dmaj.shape[1] < nt
            or any(s.shape != nbr_dmaj.shape for s in streams)
            or not 0 <= c < C or not 0 < W <= P or own0 < 0
            or own0 + nt * TB > P or not 0 < n_weights <= GRAD_W_MAX):
        raise ValueError(
            f"grad_pair_tile: worlds {tuple(v_ev.shape)} and "
            f"{tuple(v_free.shape)}, nbr {tuple(nbr_dmaj.shape)}, streams "
            f"{[tuple(s.shape) for s in streams]}, starts "
            f"{tuple(starts.shape)}, c={c}, own0={own0}, W={W}, TB={TB}, "
            f"D={D}, n_weights={n_weights} (at most {GRAD_W_MAX})")


def grad_pair_tile_plain(v_ev, v_free, nbr_dmaj, starts, wid, coef, ao, an,
                         ax, c: int, own0: int, W: int, TB: int, D: int,
                         n_weights: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`grad_pair_tile`, over batches of
    PLAIN_CHUNK_TILES tiles so its temporaries stay bounded (~0.2 GB at
    D=5, TB=128, 256 chains a world)."""
    _check_shapes(v_ev, v_free, nbr_dmaj, starts, (wid, coef, ao, an, ax),
                  c, own0, W, TB, D, n_weights)
    nt = starts.shape[0]
    dev = v_ev.device
    i32, f64 = torch.int32, torch.float64
    out = torch.empty((nt, n_weights), dtype=torch.float32, device=dev)
    for t0 in range(0, nt, PLAIN_CHUNK_TILES):
        t1 = min(nt, t0 + PLAIN_CHUNK_TILES)
        n = t1 - t0
        rows = slice(own0 + t0 * TB, own0 + t1 * TB)
        idx = nbr_dmaj[c, t0:t1].reshape(n, D, TB)
        local = idx - starts[t0:t1].reshape(n, 1, 1)
        inside = ((local >= 0) & (local < W) & (idx >= 0)
                  & (idx < v_ev.shape[0]))
        row = torch.where(inside, idx, 0).reshape(-1)
        So = torch.zeros((n, 1, TB), dtype=i32, device=dev)
        Sn = torch.zeros((n, D, TB), dtype=i32, device=dev)
        Sx = torch.zeros((n, D, TB), dtype=i32, device=dev)
        for world, sgn in ((v_ev, 1), (v_free, -1)):
            own = world[rows].to(i32).reshape(n, 1, TB, -1)
            nbr = world.index_select(0, row).to(i32) \
                .reshape(n, D, TB, -1)
            nbr = torch.where(inside[..., None], nbr, 0)
            So += sgn * own.sum(-1, dtype=i32)
            Sn += sgn * nbr.sum(-1, dtype=i32)
            Sx += sgn * (own * nbr).sum(-1, dtype=i32)

        def rec(s):
            return s[c, t0:t1].reshape(n, D, TB).to(f64)

        val = rec(coef) * (rec(ao) * So + rec(an) * Sn + rec(ax) * Sx)
        part = torch.zeros((n, n_weights), dtype=f64, device=dev)
        w = wid[c, t0:t1].reshape(n, D * TB).to(torch.int64)
        keep = (w >= 0) & (w < n_weights)
        part.scatter_add_(1, torch.where(keep, w, 0),
                          torch.where(keep, val.reshape(n, D * TB), 0.0))
        out[t0:t1] = part.to(torch.float32)
    return out


@spanned("op.grad_pair_tile", card=True)
def grad_pair_tile(v_ev, v_free, nbr_dmaj, starts, wid, coef, ao, an, ax,
                   c: int, own0: int, W: int, TB: int, D: int,
                   n_weights: int) -> torch.Tensor:
    """Per-tile gradient partials of color ``c`` of one affine2 tier.

    v_ev, v_free int8 [P, NC] (the evidence and the free worlds);
    nbr_dmaj int32 [C, >= ntiles, D*TB] global positions (all colors,
    d-major within a tile); starts int32 [ntiles] (this color's window
    starts); wid int32 and coef, ao, an, ax f32, each like nbr_dmaj (the
    compile streams gd_wid, gd_ctch or gd_cown, gd_ao, gd_an, gd_ax);
    own0 the first own row of the color's tier segment.  Returns f32
    [ntiles, n_weights]: the caller sums over the tiles and divides by NC.
    A weight id outside [0, n_weights) contributes nothing.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``grad_pair_tile.launches``)."""
    if v_ev.device.type == "cpu":
        return grad_pair_tile_plain(v_ev, v_free, nbr_dmaj, starts, wid,
                                    coef, ao, an, ax, c, own0, W, TB, D,
                                    n_weights)
    if v_ev.device.type != "cuda":
        raise ValueError(f"grad_pair_tile: no kernel for {v_ev.device}")
    dev = v_ev.device
    check_tensor(v_ev, "v_ev", torch.int8, dev, 2)
    check_tensor(v_free, "v_free", torch.int8, dev, 2)
    check_tensor(starts, "starts", torch.int32, dev, 1)
    for name, t, dt in (("nbr_dmaj", nbr_dmaj, torch.int32),
                        ("wid", wid, torch.int32),
                        ("coef", coef, torch.float32),
                        ("ao", ao, torch.float32), ("an", an, torch.float32),
                        ("ax", ax, torch.float32)):
        check_tensor(t, name, dt, dev, 3)
    _check_shapes(v_ev, v_free, nbr_dmaj, starts, (wid, coef, ao, an, ax),
                  c, own0, W, TB, D, n_weights)
    nt = starts.shape[0]
    P, NC = v_ev.shape
    out = torch.empty((nt, n_weights), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch("grad_pair_tile_launch", v_ev.data_ptr(), v_free.data_ptr(),
               NC, P, nbr_dmaj[c].data_ptr(), wid[c].data_ptr(),
               coef[c].data_ptr(), ao[c].data_ptr(), an[c].data_ptr(),
               ax[c].data_ptr(), starts.data_ptr(), nt, own0, TB, D, W,
               n_weights, out.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    grad_pair_tile.launches += 1
    return out


grad_pair_tile.launches = 0


# ---------------------------------------------------------------------------
# grad_records: each record's contribution on the cs streams of a tier
# ---------------------------------------------------------------------------

def inv_chains(NC: int) -> float:
    """1/NC rounded to float32, the factor of the chain mean."""
    return float(np.float32(1.0) / np.float32(NC))


def record_phi(own, nbrv, pos, ismine, msk, hmask, eq, arity, typ, present,
               all_boolean: bool) -> torch.Tensor:
    """φ float32 [rc, D, NC] of rows of cs-stream records, with ``own``
    [rc, NC] the rows' own values and ``nbrv`` [rc, D, A-1, NC] (None on a
    unary tier) the values at their neighbour slots; pos, ismine, msk,
    hmask [rc, D, A], eq [rc, D, A] (None on all-boolean graphs), arity
    and typ [rc, D].  On all-boolean graphs φ is counts-based: the slot
    axis is reduced at once, so no [rc, D, A, NC] literal tensor is made;
    elsewhere a literal is ``value == eq`` and that tensor is made (the
    caller's row chunk bounds it)."""
    # engine/__init__ imports the engine, which imports this module
    from ..engine.potentials import _eval_phi_ax2, _need_head, \
        _phi_from_counts

    D, A = pos.shape[1], pos.shape[2]
    A1 = A - 1
    n = arity.to(torch.int32)[..., None]
    typ = typ[..., None]
    if not all_boolean:
        eq = eq.to(own.dtype)
        own_lit = (own[:, None, None, :] == eq[..., None]) == pos[..., None]
        if A1 > 0:
            nbr_lit = (nbrv == eq[..., :A1, None]) == pos[..., :A1, None]
            lit_head = torch.where(ismine[..., :A1, None],
                                   own_lit[..., :A1, :], nbr_lit)
            lit = torch.cat([lit_head, own_lit[..., A1:, :]], dim=-2)
        else:
            lit = own_lit
        return _eval_phi_ax2(lit, msk[..., None], typ, n, present,
                             hmask=hmask[..., None])
    rc, NC = own.shape
    if A1 > 0:
        nbr_lit = (nbrv == 1) == pos[..., :A1, None]
        nbrm = (msk & ~ismine)[..., :A1, None]
        nl = (nbr_lit & nbrm).sum(dim=-2, dtype=torch.int32)
    else:
        nbr_lit = None
        nl = torch.zeros((rc, D, NC), dtype=torch.int32, device=own.device)
    ownm = ismine & msk
    o1 = (ownm & pos).sum(dim=-1, dtype=torch.int32)            # [rc, D]
    o0 = ownm.sum(dim=-1, dtype=torch.int32) - o1
    v1 = (own == 1)[:, None, :]                                 # [rc, 1, NC]
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


def records_diff(phi, feat, gsel) -> torch.Tensor:
    """A record's gradient contribution [rc, D] from φ [rc, D, 2NC] of both
    worlds side by side (the evidence world's NC chains first):
    ((Σ_n φ_ev − φ_free) · (1/NC)) · feat where ``gsel``, else 0."""
    NC = phi.shape[-1] // 2
    s = (phi[..., :NC] - phi[..., NC:]).sum(dim=-1)
    return torch.where(gsel, s * inv_chains(NC) * feat, 0.0)


def _present_bits(present) -> tuple:
    present = tuple(int(t) for t in present)
    if not present or any(t not in fs.ALL_FACTOR_FUNCS for t in present):
        raise ValueError(f"grad_records: present types {present}")
    bits = 0
    for t in present:
        bits |= 1 << t
    return bits, (present[0] if len(present) == 1 else -1)


def _check_records(v_ev, v_free, nbr, pos, ismine, mask, hmask, eq, typ,
                   arity, feat, gsel, own_base, color_stride, own_idx,
                   present, all_boolean) -> None:
    P = v_ev.shape[0] if v_ev.dim() == 2 else 0
    ok = (v_ev.dim() == 2 and v_free.shape == v_ev.shape
          and v_free.dtype == v_ev.dtype
          and v_ev.dtype in (torch.int8, torch.int32) and pos.dim() == 4
          and v_ev.shape[1] > 0)
    if ok:
        C, B, D, A = pos.shape
        ok = (A >= 1 and D >= 1
              and all(t.shape == pos.shape for t in (ismine, mask, hmask))
              and tuple(nbr.shape) == (C, B, D, A - 1)
              and all(t.shape == (C, B, D) for t in (typ, arity, feat, gsel))
              and (eq is None) == bool(all_boolean)
              and (eq is None or eq.shape == pos.shape)
              and (not all_boolean or v_ev.dtype == torch.int8)
              and own_base >= 0 and color_stride >= 0
              and (own_idx is None or tuple(own_idx.shape) == (C, B))
              and (own_idx is not None or C == 0
                   or own_base + (C - 1) * color_stride + B <= P))
    if not ok:
        def shapes(*ts):
            return [None if t is None else tuple(t.shape) for t in ts]

        raise ValueError(
            f"grad_records: worlds {tuple(v_ev.shape)} {v_ev.dtype} and "
            f"{tuple(v_free.shape)} {v_free.dtype}, nbr {tuple(nbr.shape)}, "
            f"slot streams {shapes(pos, ismine, mask, hmask, eq)}, record "
            f"streams {shapes(typ, arity, feat, gsel)}, own_base={own_base}"
            f", color_stride={color_stride}, own_idx {shapes(own_idx)}, "
            f"all_boolean={all_boolean}")
    _present_bits(present)


def _rows_or_zero(world, idx) -> torch.Tensor:
    """world[idx] with a row outside [0, P) read as 0, as the kernel reads
    it."""
    P = world.shape[0]
    valid = (idx >= 0) & (idx < P)
    rows = world.index_select(0, torch.where(valid, idx, 0).reshape(-1))
    rows = rows.reshape(idx.shape + (world.shape[1],))
    return torch.where(valid[..., None], rows, 0)


def _out(out, shape: tuple, dev) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    check_tensor(out, "out", torch.float32, dev, len(shape))
    if tuple(out.shape) != shape:
        raise ValueError(f"grad_records: out {tuple(out.shape)}, expected "
                         f"{shape}")
    return out


def grad_records_plain(v_ev, v_free, nbr, pos, ismine, mask, hmask, eq, typ,
                       arity, feat, gsel, own_base: int, color_stride: int,
                       own_idx, present, all_boolean: bool,
                       row_chunk: int | None = None,
                       out=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`grad_records`: the per-record
    math (``record_phi``, then ``records_diff``) a
    color at a time, over chunks of ``row_chunk`` rows (default:
    ~RECORD_CHUNK_ELEMS elements of the [rows, D, A, 2NC] temporaries),
    the neighbour and own values gathered from each world by position."""
    _check_records(v_ev, v_free, nbr, pos, ismine, mask, hmask, eq, typ,
                   arity, feat, gsel, own_base, color_stride, own_idx,
                   present, all_boolean)
    C, B, D, A = pos.shape
    NC = v_ev.shape[1]
    dev = v_ev.device
    rc = row_chunk or max(1, RECORD_CHUNK_ELEMS // (D * A * 2 * NC))
    out = _out(out, (C, B, D), dev)
    for c in range(C):
        base = own_base + c * color_stride
        for r0 in range(0, B, rc):
            r1 = min(B, r0 + rc)
            rows = (own_idx[c, r0:r1].to(torch.int64) if own_idx is not None
                    else torch.arange(r0, r1, device=dev)) + base
            own = torch.cat([_rows_or_zero(v_ev, rows),
                             _rows_or_zero(v_free, rows)], dim=-1)
            nbrv = None
            if A > 1:
                idx = nbr[c, r0:r1].to(torch.int64)
                nbrv = torch.cat([_rows_or_zero(v_ev, idx),
                                  _rows_or_zero(v_free, idx)], dim=-1)
            phi = record_phi(own, nbrv, pos[c, r0:r1], ismine[c, r0:r1],
                             mask[c, r0:r1], hmask[c, r0:r1],
                             None if eq is None else eq[c, r0:r1],
                             arity[c, r0:r1], typ[c, r0:r1], present,
                             all_boolean)
            out[c, r0:r1] = records_diff(phi, feat[c, r0:r1],
                                         gsel[c, r0:r1])
    return out


@spanned("op.grad_records", card=True)
def grad_records(v_ev, v_free, nbr, pos, ismine, mask, hmask, eq, typ,
                 arity, feat, gsel, own_base: int, color_stride: int,
                 own_idx, present, all_boolean: bool,
                 out=None) -> torch.Tensor:
    """Each record's gradient contribution, f32 [C, B, D], of a tier's
    colors: ((Σ_n φ_ev − φ_free) · (1/NC)) · feat where the owner mask
    ``gsel`` is set, else 0; the caller sums it per weight id.  Written
    into ``out`` (contiguous f32 [C, B, D]) when given.

    v_ev, v_free [P, NC] int8 or int32 (the evidence and the free worlds);
    the tier's streams, color-major: nbr int32 [C, B, D, A-1] (global
    positions), pos, ismine, mask, hmask bool [C, B, D, A], eq int16 or
    int32 [C, B, D, A] (None on all-boolean graphs, whose worlds are
    int8), typ int8, arity int16, feat f32, gsel bool [C, B, D]; row r of
    color c has its own value at position ``own_base + c*color_stride +
    r``, or ``own_base + c*color_stride + own_idx[c, r]`` with ``own_idx``
    int32 [C, B] (a hub tier's chunks); ``present`` the tier's factor
    types.  A position outside [0, P) reads 0.

    The route before :func:`grad_records_sum` (which takes the owner
    records alone and sums them on the card); kept as its yardstick and
    per-record check.  A CPU tensor goes to the plain version; a CUDA
    tensor to the kernel, one launch for all colors (it adds one to
    ``grad_records.launches``)."""
    if v_ev.device.type == "cpu":
        return grad_records_plain(v_ev, v_free, nbr, pos, ismine, mask,
                                  hmask, eq, typ, arity, feat, gsel,
                                  own_base, color_stride, own_idx, present,
                                  all_boolean, out=out)
    if v_ev.device.type != "cuda":
        raise ValueError(f"grad_records: no kernel for {v_ev.device}")
    dev = v_ev.device
    _check_records(v_ev, v_free, nbr, pos, ismine, mask, hmask, eq, typ,
                   arity, feat, gsel, own_base, color_stride, own_idx,
                   present, all_boolean)
    check_tensor(v_ev, "v_ev", v_ev.dtype, dev, 2)
    check_tensor(v_free, "v_free", v_ev.dtype, dev, 2)
    check_tensor(nbr, "nbr", torch.int32, dev, 4)
    for name, t in (("pos", pos), ("ismine", ismine), ("mask", mask),
                    ("hmask", hmask)):
        check_tensor(t, name, torch.bool, dev, 4)
    if eq is not None:
        if eq.dtype not in (torch.int16, torch.int32):
            raise TypeError(f"eq has dtype {eq.dtype}, expected int16 or "
                            "int32")
        check_tensor(eq, "eq", eq.dtype, dev, 4)
    for name, t, dt in (("typ", typ, torch.int8), ("arity", arity,
                                                   torch.int16),
                        ("feat", feat, torch.float32),
                        ("gsel", gsel, torch.bool)):
        check_tensor(t, name, dt, dev, 3)
    if own_idx is not None:
        check_tensor(own_idx, "own_idx", torch.int32, dev, 2)
    bits, single = _present_bits(present)
    C, B, D, A = pos.shape
    P, NC = v_ev.shape
    out = _out(out, (C, B, D), dev)
    with torch.cuda.device(dev):
        launch("grad_records_launch", v_ev.data_ptr(), v_free.data_ptr(),
               v_ev.element_size(), NC, P, nbr.data_ptr() if A > 1 else None,
               pos.data_ptr(), ismine.data_ptr(), mask.data_ptr(),
               hmask.data_ptr(), None if eq is None else eq.data_ptr(),
               0 if eq is None else eq.element_size(), typ.data_ptr(),
               arity.data_ptr(), feat.data_ptr(), gsel.data_ptr(), own_base,
               color_stride, None if own_idx is None else own_idx.data_ptr(),
               C, B, D, A, bits, single, out.data_ptr(),
               torch.cuda.current_stream(dev).cuda_stream)
    grad_records.launches += 1
    return out


grad_records.launches = 0


# ---------------------------------------------------------------------------
# grad_records_sum: the records route's gradient [W], owner records only
# ---------------------------------------------------------------------------

RECORD_PIECE = 2048             # terms a piece of the reduction (a warp's)
RECORD_MAX_TIERS = 8            # tiers a launch of the terms kernel
_REC_FIELDS = 7                 # int64 fields a tier in the launch table
# a slot's flags in the plan, one byte a slot
FLAG_POS, FLAG_OWN, FLAG_CNT, FLAG_HEAD = 1, 2, 4, 8


class RecordTier(NamedTuple):
    """One tier's arguments of :func:`grad_records` after the two worlds and
    before ``all_boolean`` (its streams, color-major; ``gsel`` its owner
    mask; its own rows; its present types), and its weight ids ``wid``
    [C, B, D] (cs_wid)."""
    nbr: torch.Tensor
    pos: torch.Tensor
    ismine: torch.Tensor
    mask: torch.Tensor
    hmask: torch.Tensor
    eq: torch.Tensor | None
    typ: torch.Tensor
    arity: torch.Tensor
    feat: torch.Tensor
    gsel: torch.Tensor
    own_base: int
    color_stride: int
    own_idx: torch.Tensor | None
    present: tuple
    wid: torch.Tensor


class RecordPlan(NamedTuple):
    """The owner records of a gradient's records-route tiers, built once a
    graph and owner mask by :func:`record_plan`.

    ``tiers`` the RecordTier of each tier (the plain version's inputs);
    per tier in ``packed`` (head, flags, nbr, eq) of its n owner records
    in record order: head int32 [n, 4] (own position; type | arity << 8,
    the type -1 where the tier's present types lack it; feat's bits; the
    flags of slots 0..3), flags uint8 [n, A] (FLAG_* a slot: the literal's
    sign, own value, counted, head), nbr int32 [n, A-1], eq int32 [n, A]
    (None on all-boolean graphs); ``terms`` f32 [N] the kernel's scratch of
    the N owner terms, tier after tier; ``perm`` int32 [N] the terms'
    indices sorted by weight id, each weight's run in record order, cut
    into pieces of at most RECORD_PIECE (``piece_start`` int32
    [pieces + 1]: offsets into perm), a weight's pieces consecutive
    (``weight_piece`` int32 [W + 1]: offsets into the pieces); ``partial``
    f64 [pieces] scratch; ``table`` the launch table (int64 [T, 7]: head,
    flags, nbr, eq, terms pointers, n, A)."""
    tiers: tuple
    all_boolean: bool
    W: int
    packed: tuple
    terms: torch.Tensor
    perm: torch.Tensor
    piece_start: torch.Tensor
    weight_piece: torch.Tensor
    partial: torch.Tensor
    table: np.ndarray


def _slot_flags(pos, ismine, mask, hmask, all_boolean: bool):
    """FLAG_* uint8 [..., A] of each slot, as the per-record kernel reads
    a slot: own on ``ismine`` slots and the last; counted where masked (on
    all-boolean graphs only own or leading slots, the plain version's own
    and neighbour counts); the head where ``hmask`` (and counted, or own
    or leading on all-boolean graphs)."""
    A = pos.shape[-1]
    last = torch.arange(A, device=pos.device) >= A - 1
    seen = (ismine | ~last) if all_boolean else mask
    return (pos.to(torch.uint8) * FLAG_POS
            + (ismine | last).to(torch.uint8) * FLAG_OWN
            + (mask & seen).to(torch.uint8) * FLAG_CNT
            + (hmask & seen).to(torch.uint8) * FLAG_HEAD)


def _pack_tier(t: RecordTier, all_boolean: bool) -> tuple:
    """(packed arrays, weight ids int64 [n]) of one tier's owner records,
    in record order."""
    C, B, D, A = t.pos.shape
    dev = t.pos.device
    rec = t.gsel.reshape(-1).nonzero().flatten()            # int64 [n]
    row = rec // D
    c = row // B
    r = row - c * B
    own = t.own_base + c * t.color_stride + (
        t.own_idx.reshape(-1).to(torch.int64).index_select(0, row)
        if t.own_idx is not None else r)
    bits, single = _present_bits(t.present)
    ty = t.typ.reshape(-1).index_select(0, rec).to(torch.int64)
    if single >= 0:
        ty = torch.full_like(ty, single)
    else:
        inside = (ty >= 0) & (ty < 32)
        ty = torch.where(inside & ((bits >> ty.clamp(0, 31)) & 1 == 1), ty,
                         -1)
    n = t.arity.reshape(-1).index_select(0, rec).to(torch.int64)
    flags = _slot_flags(t.pos, t.ismine, t.mask, t.hmask, all_boolean) \
        .reshape(-1, A).index_select(0, rec)
    low = torch.zeros((rec.numel(), 4), dtype=torch.int64, device=dev)
    low[:, :min(A, 4)] = flags[:, :4].to(torch.int64)
    word = low[:, 0] | low[:, 1] << 8 | low[:, 2] << 16 | low[:, 3] << 24
    head = torch.stack([
        own, (ty & 0xFF) | n << 8,
        t.feat.reshape(-1).index_select(0, rec).view(torch.int32)
        .to(torch.int64), word], dim=1)
    if rec.numel() and int(own.max()) >= 1 << 31:
        raise ValueError("record_plan: own positions past 2^31")
    nbr = t.nbr.reshape(-1, A - 1).index_select(0, rec) if A > 1 else None
    eq = (None if t.eq is None else
          t.eq.reshape(-1, A).index_select(0, rec).to(torch.int32))
    wid = t.wid.reshape(-1).index_select(0, rec).to(torch.int64)
    return (head.to(torch.int32).contiguous(), flags.contiguous(),
            None if nbr is None else nbr.contiguous(),
            None if eq is None else eq.contiguous()), wid


def record_plan(tiers, W: int, all_boolean: bool) -> RecordPlan:
    """The plan of :func:`grad_records_sum` for ``tiers`` (RecordTier, on one
    device): each tier's owner records (``gsel``) packed in record order,
    the permutation that sorts their terms by weight id, and the pieces of
    the reduction.  Build it once a graph and owner mask."""
    tiers = tuple(RecordTier(*t) for t in tiers)
    if not tiers:
        raise ValueError("record_plan: no tiers")
    dev = tiers[0].pos.device
    # the shapes alone: worlds of no storage, as long as a position can be
    world = torch.empty((1 << 62, 1), dtype=torch.int8, device="meta")
    packed, wids = [], []
    for t in tiers:
        _check_records(world, world, *t[:14], all_boolean)
        if tuple(t.wid.shape) != tuple(t.typ.shape):
            raise ValueError(f"record_plan: wid {tuple(t.wid.shape)}, "
                             f"records {tuple(t.typ.shape)}")
        p, w = _pack_tier(t, all_boolean)
        packed.append(p)
        wids.append(w)
    wid = torch.cat(wids)
    N = wid.numel()
    if N and (int(wid.min()) < 0 or int(wid.max()) >= W):
        raise ValueError(f"record_plan: an owner record's weight id is "
                         f"outside [0, {W})")
    perm = torch.sort(wid, stable=True)[1]
    per_w = torch.bincount(wid, minlength=W)
    n_pieces = (per_w + RECORD_PIECE - 1) // RECORD_PIECE
    weight_piece = torch.zeros(W + 1, dtype=torch.int64, device=dev)
    weight_piece[1:] = n_pieces.cumsum(0)
    P = int(weight_piece[-1])
    run = per_w.cumsum(0) - per_w
    of = torch.repeat_interleave(torch.arange(W, device=dev), n_pieces)
    piece_start = torch.full((P + 1,), N, dtype=torch.int64, device=dev)
    piece_start[:P] = run.index_select(0, of) + RECORD_PIECE * (
        torch.arange(P, device=dev) - weight_piece.index_select(0, of))
    terms = torch.empty(N, dtype=torch.float32, device=dev)
    table = np.zeros((len(tiers), _REC_FIELDS), np.int64)
    off = 0

    def ptr(x):
        return 0 if x is None or x.numel() == 0 else x.data_ptr()

    for i, (t, (head, flags, nbr, eq)) in enumerate(zip(tiers, packed)):
        n = head.shape[0]
        # tier i's terms at the buffer's element ``off``
        table[i] = (ptr(head), ptr(flags), ptr(nbr), ptr(eq),
                    ptr(terms) + 4 * off, n, t.pos.shape[3])
        off += n
    return RecordPlan(tiers, bool(all_boolean), W, tuple(packed), terms,
                      perm.to(torch.int32), piece_start.to(torch.int32),
                      weight_piece.to(torch.int32),
                      torch.empty(P, dtype=torch.float64, device=dev), table)


def record_launches(plan: RecordPlan) -> int:
    """Kernel launches of one :func:`grad_records_sum` call: the terms a
    RECORD_MAX_TIERS tiers, the pieces, the weights."""
    return -(-len(plan.tiers) // RECORD_MAX_TIERS) + 2


def grad_records_sum_plain(v_ev, v_free, plan: RecordPlan) -> torch.Tensor:
    """Plain PyTorch version of :func:`grad_records_sum`: each tier's
    per-record terms (``grad_records_plain``, zero off the owner mask) and
    one float64 sum of all of them by weight id (``segment_reduce``),
    rounded to float32 once."""
    vals, wids = [], []
    for t in plan.tiers:
        out = grad_records_plain(v_ev, v_free, *t[:14], plan.all_boolean)
        vals.append(out.reshape(-1))
        wids.append(t.wid.reshape(-1))
    return segment_reduce(torch.cat(vals), torch.cat(wids), plan.W)


@spanned("op.grad_records_sum", card=True)
def grad_records_sum(v_ev, v_free, plan: RecordPlan) -> torch.Tensor:
    """The records route's gradient f32 [W] of the plan's tiers: for each
    owner record its term ((Σ_n φ_ev − φ_free) · (1/NC)) · feat, as
    :func:`grad_records` computes it, summed by weight id in float64 and
    rounded to float32 once.

    v_ev, v_free [P, NC] int8 or int32 (int8 on all-boolean graphs); the
    plan from :func:`record_plan` on the worlds' device.  A CPU tensor goes
    to the plain version; a CUDA tensor to the kernels: one launch of the
    terms kernel for every RECORD_MAX_TIERS tiers (their owner records only,
    into ``plan.terms`` in record order), then one of the pieces (each
    piece's float64 sum over the weight-sorted permutation) and one of the
    weights (each weight's pieces in order): a fixed order, so equal
    inputs give equal bytes.  The launches add ``record_launches(plan)`` to
    ``grad_records_sum.launches``."""
    if v_ev.device.type == "cpu":
        return grad_records_sum_plain(v_ev, v_free, plan)
    if v_ev.device.type != "cuda":
        raise ValueError(f"grad_records_sum: no kernel for {v_ev.device}")
    dev = v_ev.device
    if v_ev.dtype not in (torch.int8, torch.int32) or (
            plan.all_boolean and v_ev.dtype != torch.int8):
        raise TypeError(f"grad_records_sum: worlds of {v_ev.dtype}")
    check_tensor(v_ev, "v_ev", v_ev.dtype, dev, 2)
    check_tensor(v_free, "v_free", v_ev.dtype, dev, 2)
    if v_free.shape != v_ev.shape or v_ev.shape[1] < 1:
        raise ValueError(f"grad_records_sum: worlds {tuple(v_ev.shape)} and "
                         f"{tuple(v_free.shape)}")
    if plan.terms.device != dev:
        raise ValueError(f"grad_records_sum: the plan is on "
                         f"{plan.terms.device}, the worlds on {dev}")
    P, NC = v_ev.shape
    out = torch.empty(plan.W, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch("grad_records_sum_launch", v_ev.data_ptr(), v_free.data_ptr(),
               v_ev.element_size(), NC, P, plan.table.ctypes.data,
               plan.table.shape[0], int(plan.all_boolean),
               plan.perm.data_ptr() if plan.perm.numel() else None,
               plan.piece_start.data_ptr(), plan.partial.shape[0],
               plan.weight_piece.data_ptr(), plan.W,
               plan.partial.data_ptr() if plan.partial.numel() else None,
               out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    grad_records_sum.launches += record_launches(plan)
    return out


grad_records_sum.launches = 0
