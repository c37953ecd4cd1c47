"""SGD weight learning by contrastive divergence over two coupled worlds
(counterpart of sampler_tpu/engine/learn.py: its configuration and update
rule).

Per epoch an *evidence world* (labels clamped) and a *free world* (nothing
clamped) are resampled; the gradient of each weight is the difference of
sufficient statistics

    grad(w) = sum_f feat_f * (phi_f(evidence) - phi_f(free))

applied with a diminishing step size and optional l1/l2 regularization.
The multi-chain loop that drives it is ``engine.multichain.learn_mc``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LearnConfig:
    n_epochs: int = 100
    n_sweeps_per_epoch: int = 1     # reference -s n_samples_per_learning_epoch
    stepsize: float = 0.1           # reference -a/--alpha
    diminish: float = 0.99          # reference -d/--diminish
    regularization: str = "l2"      # 'l1' | 'l2' | 'none'
    reg_param: float = 0.0          # reference --reg_param
    learn_non_evidence: bool = False


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
