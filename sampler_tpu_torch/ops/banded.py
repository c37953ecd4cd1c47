"""Banded gather (counterpart of sampler_tpu/ops/banded.py).

Two layers:
  * plan_banding / plan_banding_multi — compile-time (numpy) window
    analysis per color tile, copied from the JAX package: the neighbour
    positions read by a tile of TB variables fall inside one window of W
    consecutive positions, starting at ``starts[t]`` (or, multi-window,
    inside K such windows starting at ``starts[t, k]``);
  * banded_gather / banded_gather_multi — the gather of one color's
    neighbour rows, each with a CUDA kernel (csrc/banded_gather.cu,
    csrc/banded_gather_multi.cu) and its plain PyTorch version.

An index outside its tile's window reads 0: that is how padded slots (the
dummy position P-1, or the multi-window sentinel K*W) read 0 without a
mask.  The planner clips the last windows to P - W, so starts are not
always START_ALIGN-aligned and no version assumes they are.
"""
from __future__ import annotations

import numpy as np
import torch

from ._build import check_tensor, launch

LANE = 128          # TPU lane width: W is padded to a multiple of this
START_ALIGN = 256   # window starts rounded down for clean DMA alignment


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_banding(cs_nbr: np.ndarray, P: int, tb: int, w_max: int = 8192):
    """Window analysis.  cs_nbr: int32 [C, B, D, A1] neighbor positions with
    out-of-graph slots pointing at the dummy position P-1.

    Returns (starts [C, ntiles] int32, W int, lo [C, ntiles], hi [C, ntiles]).
    When banding is not applicable because the per-tile spread exceeds
    ``w_max``, returns (None, 0, lo, hi): the TRUE read bounds are still
    valid for the plain row gather, so the halo-exchange plan
    (parallel/graph_shard.py) keeps working even with the banded MXU gather
    off (the 10^8-var run previously lost BOTH — VERDICT.md r2 weak #1).
    Unary graphs / tile misalignment return (None, 0, None, None).
    lo/hi are per-tile bounds [lo, hi) excluding the dummy slot (empty
    tile -> lo=P, hi=0).

    Processes one color at a time so peak temporaries stay O(B*D*A1), not
    O(C*B*D*A1) — required for KBC-scale graphs.
    """
    C, B, D, A1 = cs_nbr.shape
    if A1 == 0 or B % tb != 0 or P < LANE:
        return None, 0, None, None
    ntiles = B // tb
    lo = np.empty((C, ntiles), np.int32)
    hi = np.empty((C, ntiles), np.int32)
    for c in range(C):
        idx = cs_nbr[c].reshape(ntiles, tb * D * A1)
        real = idx != (P - 1)                  # dummy slot = P-1
        lo[c] = np.where(real, idx, np.int32(P)).min(axis=-1)
        hi[c] = np.where(real, idx, np.int32(-1)).max(axis=-1)
    lo_c = np.minimum(lo, np.maximum(hi, 0))   # empty tile -> start from 0
    starts = (lo_c // START_ALIGN) * START_ALIGN
    spread = int(np.maximum(hi - starts + 1, 1).max())
    W = _round_up(spread, LANE)
    if W > min(w_max, P):
        return None, 0, lo.astype(np.int32), (hi + 1).astype(np.int32)
    starts = np.minimum(starts, P - W)         # keep window inside [0, P)
    starts = np.maximum(starts, 0)
    assert int((hi - starts).max()) < W
    return (starts.astype(np.int32), W,
            lo.astype(np.int32), (hi + 1).astype(np.int32))


def _greedy_starts(idx_sorted: np.ndarray, nreal: np.ndarray, W: int,
                   P: int, k_cap: int):
    """Greedy interval partition per tile: the minimum set of aligned
    width-W windows covering each tile's sorted read positions (classic
    greedy is optimal for fixed W).  idx_sorted [T, R] ascending with
    sentinels (>= P) sorted last; nreal [T] real entries per tile.

    Returns (starts int64 [T, k_cap] ascending — unused slots repeat the
    last real start so the (p >= starts) remap rule stays monotone,
    nwin int64 [T]) or (None, None) when some tile needs > k_cap windows.
    """
    T = idx_sorted.shape[0]
    starts = np.zeros((T, k_cap), np.int64)
    nwin = np.zeros(T, np.int64)
    thr = np.full(T, -1, np.int64)          # covered positions <= thr
    rows = np.arange(T)
    for j in range(k_cap + 1):
        cnt = (idx_sorted <= thr[:, None]).sum(axis=-1)
        need = cnt < nreal
        if not need.any():
            break
        if j == k_cap:
            return None, None               # over budget at this W
        p = idx_sorted[rows, np.minimum(cnt, idx_sorted.shape[1] - 1)]
        start = (p // START_ALIGN) * START_ALIGN
        start = np.clip(start, 0, max(P - W, 0))
        starts[need, j:] = start[need, None]   # fill tail (ascending pad)
        nwin[need] = j + 1
        thr = np.where(need, start + W - 1, thr)
    return starts, nwin


def plan_banding_multi(cs_nbr: np.ndarray, P: int, tb: int, w_max: int,
                       k_max: int = 8, kw_max: int = 8192):
    """MULTI-WINDOW window analysis for multi-color / irregular graphs.

    A single contiguous window cannot cover a tile's reads when its
    neighbors live in several color blocks (any graph with >2 colors).
    Windows are planned by GREEDY INTERVAL CLUSTERING of each tile's
    sorted read positions — segment-structure-agnostic, so reads into
    adjacent color blocks share one window and a ~20-color KBC graph
    stays within the K <= k_max budget (the round-4 per-source-block
    scheme needed K == #blocks-read and gave up beyond 8, turning the MXU
    gather off on exactly the reference's home workload).  The gather is
    ONE one-hot matmul against the K windows concatenated in VMEM;
    neighbor indices are REMAPPED at compile time into the concatenated
    window space (rnbr = j*W + idx - start_j), which makes
    double-counting impossible by construction and keeps the kernel a
    single equality-iota + dot.  W is chosen over power-of-two candidates
    to minimize the per-tile gather volume K*W.

    Returns (starts [C, ntiles, K] int32 DMA starts, W int, K int,
             rnbr [C, ntiles, R] int32 remapped indices,
             lo [C, ntiles], hi [C, ntiles] true GLOBAL read bounds)
    or (None, 0, 0, None, lo, hi) when not applicable.  ``kw_max`` bounds
    the per-tile gather volume K*W: the one-hot matmul spends K*W*NC*2
    FLOPs per gathered row, which crosses the plain gather's ~11-19 ns
    issue cost around K*W ~ 8k at NC = 128 — wider coverage (e.g. a
    scrambled-id graph whose greedy windows degenerate to the whole
    position space) must fall back to the row gather.
    """
    C, B, D, A1 = cs_nbr.shape
    if A1 == 0 or B % tb != 0 or P < LANE:
        return None, 0, 0, None, None, None
    kw_max = min(kw_max, P + LANE)
    ntiles = B // tb
    R = tb * D * A1
    dummy = P - 1
    lo_g = np.empty((C, ntiles), np.int32)
    hi_g = np.empty((C, ntiles), np.int32)
    # pass 1: per-color sorted read positions (sentinel P+1 sorts last)
    srt = []
    nreal = np.empty((C, ntiles), np.int64)
    for c in range(C):
        idx = cs_nbr[c].reshape(ntiles, R).astype(np.int64)
        real = idx != dummy
        lo_g[c] = np.where(real, idx, P).min(axis=-1)
        hi_g[c] = np.where(real, idx, -1).max(axis=-1)
        nreal[c] = real.sum(axis=-1)
        srt.append(np.sort(np.where(real, idx, np.int64(P + 1)), axis=-1))

    # pass 2: pick W — smallest per-tile gather volume K(W)*W that fits.
    # Candidates are capped at P ROUNDED DOWN to the lane width: a window
    # wider than the values array cannot be DMA'd (the single-window plan
    # enforces W <= P the same way)
    wcands, w = [], LANE * 4
    w_hi = min(w_max, (P // LANE) * LANE)
    while w <= w_hi:
        wcands.append(w)
        w *= 2
    if w_hi not in wcands and w_hi >= LANE:
        wcands.append(w_hi)
    best = None                         # (cost, W, starts per color, K)
    for Wc in wcands:
        per_c, kmax_c, ok = [], 0, True
        for c in range(C):
            st, nw = _greedy_starts(srt[c], nreal[c], Wc, P, k_max)
            if st is None:
                ok = False
                break
            per_c.append(st)
            kmax_c = max(kmax_c, int(nw.max()))
        if not ok or kmax_c == 0 or kmax_c * Wc > kw_max:
            continue
        cost = kmax_c * Wc
        if best is None or cost < best[0]:
            best = (cost, Wc, per_c, kmax_c)
    if best is None:
        return None, 0, 0, None, lo_g, hi_g + 1
    _, W, per_c, K = best

    # pass 3: remap neighbor indices into the concatenated window space
    starts = np.zeros((C, ntiles, K), np.int32)
    rnbr = np.empty((C, ntiles, R), np.int32)
    for c in range(C):
        st = per_c[c][:, :K]                          # [ntiles, K] asc
        starts[c] = st.astype(np.int32)
        idx = cs_nbr[c].reshape(ntiles, R).astype(np.int64)
        real = idx != dummy
        # last window with start <= idx; covered by construction (greedy
        # coverage proof: idx <= thr_j of the window that admitted it, and
        # any LATER window with start <= idx also spans it since starts
        # ascend and windows are W wide)
        j = (idx[:, :, None] >= st[:, None, :]).sum(axis=-1) - 1
        j = np.maximum(j, 0)
        s = np.take_along_axis(st, j, axis=1)
        rnbr[c] = np.where(real, j * np.int64(W) + idx - s,
                           np.int64(K * W)).astype(np.int32)
        r = real.nonzero()
        assert (rnbr[c][r] < K * W).all() and (rnbr[c] >= 0).all()
        assert ((idx - s)[r] < W).all() and ((idx - s)[r] >= 0).all()
    return starts, W, K, rnbr, lo_g, hi_g + 1



# --------------------------------------------------------------------------
# the gather
# --------------------------------------------------------------------------

def banded_gather_plain(values: torch.Tensor, nbr: torch.Tensor,
                        starts: torch.Tensor, W: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`banded_gather`."""
    local = nbr - starts[:, None]
    inside = ((local >= 0) & (local < W)).reshape(-1, 1)
    rows = values.index_select(0, nbr.reshape(-1))
    return torch.where(inside, rows, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))


def banded_gather(values: torch.Tensor, nbr: torch.Tensor,
                  starts: torch.Tensor, W: int) -> torch.Tensor:
    """values int8 [P, NC]; nbr int32 [ntiles, R] global positions;
    starts int32 [ntiles] window starts.  Returns int8 [ntiles*R, NC] with
    ``out[t*R + r] = values[nbr[t, r]]`` where ``nbr[t, r]`` lies in
    ``[starts[t], starts[t] + W)`` and 0 elsewhere.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``banded_gather.launches``)."""
    if values.device.type == "cpu":
        return banded_gather_plain(values, nbr, starts, W)
    if values.device.type != "cuda":
        raise ValueError(f"banded_gather: no kernel for {values.device}")
    dev = values.device
    check_tensor(values, "values", torch.int8, dev, 2)
    check_tensor(nbr, "nbr", torch.int32, dev, 2)
    check_tensor(starts, "starts", torch.int32, dev, 1)
    ntiles, R = nbr.shape
    P, NC = values.shape
    if starts.shape[0] != ntiles or not 0 < W <= P:
        raise ValueError(f"banded_gather: starts {tuple(starts.shape)} for "
                         f"{ntiles} tiles, W={W}, P={P}")
    out = torch.empty((ntiles * R, NC), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        launch("banded_gather_launch", values.data_ptr(), NC,
               nbr.data_ptr(), starts.data_ptr(), ntiles, R, W,
               out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    banded_gather.launches += 1
    return out


banded_gather.launches = 0


def _multi_rows(rnbr: torch.Tensor, starts: torch.Tensor, W: int,
                P: int) -> tuple:
    """(global row int64 [ntiles*R], valid bool [ntiles*R]) of remapped
    multi-window indices: ``i = rnbr[t, r]`` reads row
    ``starts[t, i // W] + i % W`` when ``0 <= i < K*W`` and that row lies
    in [0, P); anything else (the sentinel K*W) reads 0."""
    K = starts.shape[1]
    i = rnbr.to(torch.int64)
    valid = (i >= 0) & (i < K * W)
    k = torch.where(valid, i // W, 0)
    row = starts.to(torch.int64).gather(1, k) + i % W
    valid &= (row >= 0) & (row < P)
    return torch.where(valid, row, 0).reshape(-1), valid.reshape(-1)


def banded_gather_multi_plain(values: torch.Tensor, rnbr: torch.Tensor,
                              starts: torch.Tensor, W: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`banded_gather_multi`."""
    row, valid = _multi_rows(rnbr, starts, W, values.shape[0])
    out = values.index_select(0, row)
    return out.masked_fill_(~valid[:, None], 0)


def banded_gather_multi(values: torch.Tensor, rnbr: torch.Tensor,
                        starts: torch.Tensor, W: int) -> torch.Tensor:
    """Multi-window banded gather.  values int8 [P, NC]; rnbr int32
    [ntiles, R] indices remapped into the concatenated window space
    [0, K*W) (compile's bd_rnbr, the sentinel K*W for a padded slot);
    starts int32 [ntiles, K] window starts.  Returns int8 [ntiles*R, NC]
    with ``out[t*R + r] = values[starts[t, i // W] + i % W]`` for
    ``i = rnbr[t, r] < K*W`` and 0 for the sentinel or a row at or past P.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``banded_gather_multi.launches``)."""
    if values.device.type == "cpu":
        return banded_gather_multi_plain(values, rnbr, starts, W)
    if values.device.type != "cuda":
        raise ValueError(f"banded_gather_multi: no kernel for "
                         f"{values.device}")
    dev = values.device
    check_tensor(values, "values", torch.int8, dev, 2)
    check_tensor(rnbr, "rnbr", torch.int32, dev, 2)
    check_tensor(starts, "starts", torch.int32, dev, 2)
    ntiles, R = rnbr.shape
    P, NC = values.shape
    K = starts.shape[1]
    if starts.shape[0] != ntiles or K < 1 or not 0 < W <= P:
        raise ValueError(f"banded_gather_multi: starts "
                         f"{tuple(starts.shape)} for {ntiles} tiles, W={W}, "
                         f"P={P}")
    out = torch.empty((ntiles * R, NC), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        launch("banded_gather_multi_launch", values.data_ptr(), NC, P,
               rnbr.data_ptr(), starts.data_ptr(), ntiles, R, K, W,
               out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    banded_gather_multi.launches += 1
    return out


banded_gather_multi.launches = 0
