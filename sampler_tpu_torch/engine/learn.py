"""SGD weight learning by contrastive divergence over two coupled worlds
(counterpart of sampler_tpu/engine/learn.py: its configuration and update
rule).

Per epoch an *evidence world* (labels clamped) and a *free world* (nothing
clamped) are resampled; the gradient of each weight is the difference of
sufficient statistics

    grad(w) = sum_f feat_f * (phi_f(evidence) - phi_f(free))

applied with a diminishing step size and optional l1/l2 regularization.
The multi-chain loop that drives it is ``engine.multichain.learn_mc``;
``learn`` is the single-chain loop, over one evidence and one free world
(``engine.sweep.sweep``), with the per-factor ``weight_gradient``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..observe import spanned


@dataclasses.dataclass(frozen=True)
class LearnConfig:
    n_epochs: int = 100
    n_sweeps_per_epoch: int = 1     # reference -s n_samples_per_learning_epoch
    stepsize: float = 0.1           # reference -a/--alpha
    diminish: float = 0.99          # reference -d/--diminish
    regularization: str = "l2"      # 'l1' | 'l2' | 'none'
    reg_param: float = 0.0          # reference --reg_param
    learn_non_evidence: bool = False


@spanned("engine.update")
def apply_update(weights: torch.Tensor, grad: torch.Tensor,
                 w_fixed: torch.Tensor, stepsize: float,
                 regularization: str, reg_param: float) -> torch.Tensor:
    """One SGD step ``weights + stepsize * (grad - reg)``; fixed weights
    keep their value."""
    if regularization == "l2":
        grad = grad - reg_param * weights
    elif regularization == "l1":
        grad = grad - reg_param * torch.sign(weights)
    new = weights + stepsize * grad
    return torch.where(w_fixed, weights, new)


def weight_gradient(dg, values_ev, values_free, learn_non_evidence: bool,
                    present=None, has_sparse_cw: bool = False):
    """grad [W] float32 of one evidence and one free world [P], factor by
    factor: a segment sum of the per-factor differences of sufficient
    statistics, sparse per-combination weights included (the reserved
    zero slot's gradient is 0)."""
    from .multichain import factor_gradient

    return factor_gradient(dg, values_ev[:, None], values_free[:, None],
                           learn_non_evidence, present, has_sparse_cw)


def learn(dg, weights, generator, cfg: LearnConfig, info, modes=None,
          device="cuda") -> tuple:
    """``cfg.n_epochs`` single-chain learning epochs; returns (weights [W]
    float32, v_ev [P], v_free [P]).

    Both worlds start from ``generator`` (evidence world first), which
    then drives their sweeps in turn.  With the default ``device="cuda"``
    and no card present this raises; pass ``device="cpu"`` for the plain
    versions."""
    from .gibbs import init_values
    from .multichain import _setup
    from .sweep import sweep

    modes, w = _setup(dg, None, weights, device, info, modes)
    v_ev = init_values(dg, generator, info)       # evidence clamped
    v_free = init_values(dg, generator, info)
    alpha = np.float32(cfg.stepsize)
    diminish = np.float32(cfg.diminish)
    for _ in range(cfg.n_epochs):
        for _ in range(cfg.n_sweeps_per_epoch):
            sweep(dg, v_ev, w, generator, False, info, modes)
            sweep(dg, v_free, w, generator, True, info, modes)
        grad = weight_gradient(dg, v_ev, v_free, cfg.learn_non_evidence,
                               info.present_funcs, info.has_sparse_cw)
        w = apply_update(w, grad, dg.w_fixed, float(alpha),
                         cfg.regularization, cfg.reg_param)
        alpha = alpha * diminish
    return w, v_ev, v_free
