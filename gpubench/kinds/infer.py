"""Inference jobs (``dw gibbs -i <n> -b <burn>``).

A job runs ``init_values_mc``, ``run_sweeps_mc`` for the burn-in, then
``run_inference_mc`` for all counted sweeps but the last and once more
for the last (two chunks of ``--checkpoint_every``), sums the counts on
the host and reindexes them to marginals by ``pos_of_vid``, as the
command does.  The chunk boundary keeps the worlds around the last sweep
and its counts for the judge.

Numbers (lower is better, each held to its cell's limit):

  draw_z         the kept jobs' last sweeps' draws against the reference
                 (``judge.ZBins``);
  clamped_moved  evidence values that moved in those worlds;
  tally_diff     entries of their last sweep's counts unlike the
                 reference's tally of the world it left.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench import faults, judge, reference as ref
from gpubench.jobs import Done

WORLDS = ("old", "new")          # kept worlds, position space [P, NC]
COUNTS = ("last",)               # kept counts, position space [K * P]
FAULTS = [("unchanged", "sweep_mc", faults.unchanged),
          ("half_batch", "sweep_mc", faults.half_batch),
          ("altered_draws", "sweep_mc", faults.altered_draws),
          ("half_tally", "tally", faults.half_tally),
          ("altered_tally", "tally", faults.altered_tally)]


class Job:
    kind = "infer"

    def __init__(self, traffic: dict, n_sweeps: int | None = None):
        self.n_burn = int(traffic.get("n_burn", 0))
        self.n_sweeps = int(n_sweeps or traffic["n_sweeps"])
        if self.n_sweeps < 2:
            raise ValueError("an inference job counts at least 2 sweeps")

    def sweeps(self) -> int:
        return self.n_burn + self.n_sweeps

    def updates(self, n_vars: int, n_chains: int) -> int:
        return n_vars * n_chains * self.sweeps()

    def run(self, s, gen) -> Done:
        """``s``: the set-up (``harness.Setup``)."""
        from sampler_tpu_torch.engine.multichain import (init_values_mc,
                                                         run_inference_mc,
                                                         run_sweeps_mc)

        d, info, NC, dev = s.dg, s.info, s.n_chains, s.device
        w = d.w_init
        v = init_values_mc(d, gen, NC, info)
        if self.n_burn:
            v = run_sweeps_mc(d, v, w, gen, self.n_burn, False, info,
                              device=dev)
        old, c_a = run_inference_mc(d, v, w, gen, self.n_sweeps - 1, False,
                                    info, device=dev)
        new, c_b = run_inference_mc(d, old, w, gen, 1, False, info,
                                    device=dev)
        K = info.max_card
        last = c_b.cpu().numpy()
        counts = (c_a.cpu().numpy().astype(np.int64) + last).reshape(K, -1).T
        marg = (counts[s.pos_of_vid] / float(self.n_sweeps * NC)).astype(
            np.float32)
        del marg     # the job's product, read as the command reads it
        return Done(None, dict(old=old, new=new, last=last))


def numbers(fa, g, colors, kept, briefs, traffic, control=False,
            gen=None) -> tuple:
    """(numbers, notes) of the kept jobs (vid space: worlds [V, NC],
    counts [K, V])."""
    w = torch.as_tensor(g["w_init"], device=fa.device)
    query = fa.role != ref.ROLE_EVIDENCE
    zb = judge.ZBins(fa.device)
    moved = diff = 0
    for keep in kept:
        old, new = keep["old"], keep["new"]
        zb.add(fa, w, old, new, colors, query, control, gen)
        moved += judge.clamped_moved(fa, new)
        # the control, put in the program's place, tallies as the
        # reference does: a tally has no lower precision to fall to
        if not control:
            counts = torch.as_tensor(keep["last"], device=fa.device)
            diff += int((counts != ref.tally(new).to(counts.dtype)).sum())
    return (dict(draw_z=zb.max(), clamped_moved=moved, tally_diff=diff),
            [dict(draw_z_bins=zb.table(), judged_jobs=len(kept))])
