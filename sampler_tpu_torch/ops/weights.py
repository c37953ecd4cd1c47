"""Weight-stream expansion (counterpart of sampler_tpu/ops/weights.py).

The JAX package avoids a row gather for small weight tables because the
TPU's gather is issue-rate bound; on a GPU ``index_select`` is the plain
and fast form, so the port uses it for every table size.
"""
from __future__ import annotations

import torch


def expand_wf(weights: torch.Tensor, wid: torch.Tensor,
              feat: torch.Tensor | None = None) -> torch.Tensor:
    """``weights[wid] (* feat)`` as float32, in ``wid``'s shape."""
    wf = weights.to(torch.float32).index_select(
        0, wid.reshape(-1).to(torch.int64)).reshape(wid.shape)
    return wf if feat is None else wf * feat
