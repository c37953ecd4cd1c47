"""The colored Gibbs sweep of one chain (counterpart of
sampler_tpu/engine/sweep.py).

One sweep visits the colors in order; within a color every variable is
resampled at once (they share no factor, so the block update is exact
Gibbs).  These are the one-chain wrappers over the chains-last engine
(``engine.multichain.color_step_mc`` at NC = 1), as in the JAX package:
the world is a [P] tensor, viewed as [P, 1].  As there, no weight fold is
passed, so every tier takes its unfused draw.
"""
from __future__ import annotations

import torch

from .multichain import color_logits_mc, color_step_mc, resolve_modes


def _modes(info, values, modes) -> tuple:
    return resolve_modes(info, values.device) if modes is None else modes


def color_logits(dg, values, weights, c, info, modes=None) -> torch.Tensor:
    """Conditional log-potentials [B, K] for color ``c`` of world
    ``values`` [P], concatenated over the degree tiers (a hub tier's rows
    are its chunks)."""
    modes = _modes(info, values, modes)
    parts = [color_logits_mc(dg, ts, ti, values[:, None], weights, c, info,
                             modes)[..., 0]
             for ts, ti in zip(dg.tiers, info.tiers)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def color_step(dg, values, weights, generator, c, sample_evidence: bool,
               info, modes=None) -> torch.Tensor:
    """Resample color ``c`` of world ``values`` [P] in place; returns it."""
    color_step_mc(dg, values[:, None], weights, generator, c,
                  sample_evidence, info, None, _modes(info, values, modes))
    return values


def sweep(dg, values, weights, generator, sample_evidence: bool, info,
          modes=None) -> torch.Tensor:
    """One sweep over all colors of world ``values`` [P], in place; returns
    it."""
    modes = _modes(info, values, modes)
    for c in range(info.n_colors):
        color_step(dg, values, weights, generator, c, sample_evidence, info,
                   modes)
    return values
