"""Learning jobs (``dw gibbs -l <epochs> -s <sweeps> -a <step> -d <dim>``).

A job draws two ``init_values_mc`` worlds (evidence world first), runs
``learn_mc`` for the first epoch and once more, continuing from its worlds
and step size, for the others, and reads the weights with ``.cpu()``.  The
chunk boundary keeps the first epoch's worlds and weights for the judge.

Numbers (lower is better, each held to its cell's limit):

  draw_z         both worlds' draws in the kept jobs' first epochs
                 against the reference (``judge.ZBins``);
  clamped_moved  evidence values that moved in the evidence worlds;
  update_gap     the first epoch's weight change against the reference's
                 step times its gradient of the same worlds: the largest
                 |change - reference| over max(|reference|, median nonzero
                 |reference|), the worst kept job;
  nonfinite      weights of the finished jobs that are not finite.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench import faults, judge, reference as ref
from gpubench.jobs import Done

WORLDS = ("ev0", "free0", "ev1", "free1")
COUNTS = ()
FAULTS = [("unchanged", "sweep_mc", faults.unchanged),
          ("half_batch", "sweep_mc", faults.half_batch),
          ("altered_draws", "sweep_mc", faults.altered_draws),
          ("half_gradient", "mc_weight_gradient", faults.half_gradient),
          ("altered_gradient", "mc_weight_gradient",
           faults.altered_gradient)]


class Job:
    kind = "learn"

    def __init__(self, traffic: dict, n_epochs: int | None = None):
        from sampler_tpu_torch.engine.learn import LearnConfig

        self.cfg = LearnConfig(
            n_epochs=int(n_epochs or traffic["n_epochs"]),
            n_sweeps_per_epoch=int(traffic["n_sweeps_per_epoch"]),
            stepsize=float(traffic["stepsize"]),
            diminish=float(traffic["diminish"]),
            regularization=traffic["regularization"],
            reg_param=float(traffic["reg_param"]),
            learn_non_evidence=bool(traffic.get("learn_non_evidence", False)))
        if self.cfg.n_epochs < 2:
            raise ValueError("a learning job runs at least 2 epochs")

    def sweeps(self) -> int:
        return self.cfg.n_epochs * self.cfg.n_sweeps_per_epoch

    def updates(self, n_vars: int, n_chains: int) -> int:
        return n_vars * n_chains * 2 * self.sweeps()

    def run(self, s, gen) -> Done:
        from sampler_tpu_torch.engine.multichain import init_values_mc, learn_mc

        d, info, NC, dev, cfg = s.dg, s.info, s.n_chains, s.device, self.cfg
        w0 = d.w_init
        ev0 = init_values_mc(d, gen, NC, info)
        free0 = init_values_mc(d, gen, NC, info)
        w1, ev1, free1 = learn_mc(d, w0, gen,
                                  dataclasses.replace(cfg, n_epochs=1), info,
                                  NC, v_ev=ev0, v_free=free0,
                                  alpha=cfg.stepsize, device=dev)
        w, _, _ = learn_mc(d, w1, gen,
                           dataclasses.replace(cfg, n_epochs=cfg.n_epochs - 1),
                           info, NC, v_ev=ev1, v_free=free1,
                           alpha=cfg.stepsize * cfg.diminish, device=dev)
        w = w.cpu().numpy()
        return Done(int((~np.isfinite(w)).sum()),
                    dict(ev0=ev0, free0=free0, ev1=ev1, free1=free1, w0=w0,
                         w1=w1))


def numbers(fa, g, colors, kept, briefs, traffic, control=False,
            gen=None) -> tuple:
    """(numbers, notes) of the kept jobs (worlds in vid space before and
    after the first epoch, weights w0 and w1 as the program holds them);
    ``briefs``: every finished job's count of non-finite weights."""
    W = fa.W
    query = fa.role != ref.ROLE_EVIDENCE
    everyone = torch.ones_like(query)
    step = float(np.float32(traffic["stepsize"]))
    zb = judge.ZBins(fa.device)
    moved, gap = 0, 0.0
    for keep in kept:
        w0 = torch.as_tensor(keep["w0"], device=fa.device).to(torch.float64)
        zb.add(fa, w0[:W], keep["ev0"], keep["ev1"], colors, query, control,
               gen)
        zb.add(fa, w0[:W], keep["free0"], keep["free1"], colors, everyone,
               control, gen)
        moved += judge.clamped_moved(fa, keep["ev1"])
        dr = torch.zeros_like(w0)
        dr[:W] = step * ref.gradient(fa, keep["ev1"], keep["free1"])
        if control:
            gc = ref.gradient(fa, keep["ev1"], keep["free1"], judge.CONTROL)
            w1 = w0.to(judge.CONTROL).clone()
            w1[:W] = w1[:W] + step * gc
            dp = w1.to(torch.float64) - w0
        else:
            dp = torch.as_tensor(keep["w1"], device=fa.device).to(
                torch.float64) - w0
        nz = dr.abs()[dr != 0]
        scale = dr.abs().clamp(min=float(nz.median()) if len(nz) else 1.0)
        gap = max(gap, float(((dp - dr).abs() / scale).max()))
    return (dict(draw_z=zb.max(), clamped_moved=moved, update_gap=gap,
                 nonfinite=int(sum(briefs))),
            [dict(draw_z_bins=zb.table(), judged_jobs=len(kept))])
