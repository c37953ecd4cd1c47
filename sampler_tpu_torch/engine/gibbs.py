"""Inference of one chain: burn-in, counted sweeps, marginal tallies
(counterpart of sampler_tpu/engine/gibbs.py).

Mirrors the reference's gibbs() phase structure: every epoch is one full
colored sweep (``engine.sweep.sweep``), and the tallies count each
(position, value) over the counted sweeps.  ``infer`` with ``n_chains > 1``
hands over to the chains-last ``engine.multichain.infer_mc``.
"""
from __future__ import annotations

import numpy as np
import torch

from .multichain import _setup, infer_mc, init_values_mc, tally
from .sweep import sweep


def init_values(dg, generator, info, random_init: bool = True
                ) -> torch.Tensor:
    """Initial world [P] of ``values_dtype(info)``: evidence at its
    labels, query variables uniform over their cardinality (or at their
    initial values)."""
    return init_values_mc(dg, generator, 1, info, random_init)[:, 0]


def run_sweeps(dg, values, weights, generator, n_sweeps: int,
               sample_evidence: bool, info, device="cuda") -> torch.Tensor:
    """``n_sweeps`` sweeps from ``values`` [P] (not modified), no tallies
    (burn-in); returns the new world."""
    w = _setup(dg, values, weights, device)
    values = values.clone()
    for _ in range(n_sweeps):
        sweep(dg, values, w, generator, sample_evidence, info)
    return values


def run_inference(dg, values, weights, generator, n_sweeps: int,
                  sample_evidence: bool, info, device="cuda") -> tuple:
    """``n_sweeps`` sweeps with a tally after each; returns (values [P],
    counts [P, K] int32).  ``values`` is not modified."""
    w = _setup(dg, values, weights, device)
    values = values.clone()
    counts = torch.zeros((info.max_card, values.shape[0]), dtype=torch.int32,
                         device=values.device)
    for _ in range(n_sweeps):
        sweep(dg, values, w, generator, sample_evidence, info)
        tally(counts, values[:, None])
    return values, counts.T


def marginals_from_counts(counts, n_sweeps: int):
    """Estimated P(v = k), float32 [.., K]."""
    return counts.to(torch.float32) / np.float32(n_sweeps)


def infer(dg, weights, generator, n_burn: int, n_sweeps: int, info,
          sample_evidence: bool = False, random_init: bool = True,
          n_chains: int = 1, device="cuda") -> tuple:
    """Burn-in, then counted sweeps; returns (marginals [V, K] float32
    numpy, final values).

    One chain runs here (values [P]); ``n_chains > 1`` runs
    ``infer_mc`` (values [P, NC]), the chains' tallies pooled.  With the
    default ``device="cuda"`` and no card present this raises; pass
    ``device="cpu"`` for the plain versions."""
    if n_chains > 1:
        return infer_mc(dg, weights, generator, n_burn, n_sweeps, info,
                        n_chains, sample_evidence, random_init, device)
    w = _setup(dg, None, weights, device)
    values = init_values(dg, generator, info, random_init)
    if n_burn:
        values = run_sweeps(dg, values, w, generator, n_burn,
                            sample_evidence, info, device)
    values, counts = run_inference(dg, values, w, generator, n_sweeps,
                                   sample_evidence, info, device)
    marg = marginals_from_counts(
        counts.index_select(0, dg.pos_of_vid.to(torch.int64)), n_sweeps)
    return marg.cpu().numpy(), values
