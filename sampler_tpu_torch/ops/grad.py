"""Moment-factored contrastive gradient of one color of an affine2 tier
(counterpart of sampler_tpu/ops/grad.py, ``grad_pair_tile``).

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

import torch

from ._build import check_tensor, launch

GRAD_W_MAX = 64                 # weights a kernel launch accumulates
PLAIN_CHUNK_TILES = 64


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
