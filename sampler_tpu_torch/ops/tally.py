"""Per-position value counts over the chains (the tallies of
sampler_tpu/engine/multichain.py's _run_inference_mc).

``counts[k, p] += #{n : values[p, n] == k}`` for every value k < K, in
place; a value outside [0, K) counts nowhere.  The JAX package sums
``vals == k`` inside its jitted sweep loop, where XLA fuses each compare
into its sum; no Pallas kernel stands behind it.  On the card the port
runs one CUDA kernel (csrc/tally_counts.cu) that reads each world row once
and adds all K counts; on the CPU the plain version below.
"""
from __future__ import annotations

import ctypes

import torch

from ..observe import spanned
from ._build import check_tensor, launch

TALLY_CHUNK_ELEMS = 1 << 22     # (position, chain) pairs a bincount block
# the way the launcher reports for its tiles of consecutive positions (rows
# under 16 bytes at K <= 16; kTile in csrc/tally_counts.cu)
TILE_WAY = 3


def tally_plain(counts: torch.Tensor, values: torch.Tensor,
                chunk_elems: int = TALLY_CHUNK_ELEMS) -> None:
    """Plain PyTorch version of :func:`tally_counts`.  Up to 16 values, one
    comparison a value in the worlds' dtype; above, one bincount a block of
    rows (the JAX package switches to a one-hot there too), whose int64
    temporaries stay near ``chunk_elems`` entries."""
    K = counts.shape[0]
    if K <= 16:
        for k in range(K):
            counts[k] += (values == k).sum(dim=1, dtype=torch.int32)
        return
    P, NC = values.shape
    step = max(1, chunk_elems // max(NC, K))
    for r0 in range(0, P, step):
        blk = values[r0:r0 + step]
        n = blk.shape[0]
        idx = blk.to(torch.int64) * n + torch.arange(
            n, device=values.device)[:, None]
        inside = (blk >= 0) & (blk < K)
        counts[:, r0:r0 + n] += torch.bincount(
            idx[inside], minlength=K * n).view(K, n).to(torch.int32)


@spanned("op.tally_counts", card=True)
def tally_counts(counts: torch.Tensor, values: torch.Tensor) -> None:
    """Add each position's count of every value k over the chains to
    ``counts`` [K, P] int32, in place; ``values`` [P, NC] int8 or int32.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel
    (the launch adds one to ``tally_counts.launches``, and one to
    ``tally_counts.narrow_launches`` where the launcher reports that it
    took its tiles)."""
    if values.device.type == "cpu":
        tally_plain(counts, values)
        return
    if values.device.type != "cuda":
        raise ValueError(f"tally_counts: no kernel for {values.device}")
    dev = values.device
    if values.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"values has dtype {values.dtype}, expected int8 or "
                        "int32")
    check_tensor(values, "values", values.dtype, dev, 2)
    check_tensor(counts, "counts", torch.int32, dev, 2)
    P, NC = values.shape
    K = counts.shape[0]
    if counts.shape[1] != P or K < 1:
        raise ValueError(f"tally_counts: counts {tuple(counts.shape)}, "
                         f"values {tuple(values.shape)}")
    way = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        launch("tally_counts_launch", values.data_ptr(), P, NC,
               values.element_size(), counts.data_ptr(), K,
               torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(way))
    tally_counts.launches += 1
    if way.value == TILE_WAY:
        tally_counts.narrow_launches += 1


tally_counts.launches = 0
tally_counts.narrow_launches = 0
