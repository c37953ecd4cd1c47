"""Weight-stream expansion and reduction (counterpart of
sampler_tpu/ops/weights.py).

The JAX package avoids a row gather and a scatter for small weight tables
(a masked sum over a one-hot of the weight ids instead) because the TPU's
gather and scatter are issue-rate bound; on a GPU ``index_select`` and
``index_add_`` are the plain and fast forms, so the port uses them for
every table size.
"""
from __future__ import annotations

import torch


def expand_wf(weights: torch.Tensor, wid: torch.Tensor,
              feat: torch.Tensor | None = None) -> torch.Tensor:
    """``weights[wid] (* feat)`` as float32, in ``wid``'s shape."""
    wf = weights.to(torch.float32).index_select(
        0, wid.reshape(-1).to(torch.int64)).reshape(wid.shape)
    return wf if feat is None else wf * feat


def segment_reduce(vals: torch.Tensor, wid: torch.Tensor,
                   W: int) -> torch.Tensor:
    """Sum of ``vals`` grouped by ``wid`` -> [W] float32.  ``vals`` and
    ``wid`` have the same shape (any rank).  The sums are taken in float64
    and rounded to float32 once: on a CUDA device the order of the
    additions is not fixed, and a float32 sum over millions of terms into a
    few weights would carry that order's rounding into the gradient."""
    return torch.zeros(W, dtype=torch.float64, device=vals.device).index_add_(
        0, wid.reshape(-1).to(torch.int64),
        vals.reshape(-1).to(torch.float64)).to(torch.float32)
