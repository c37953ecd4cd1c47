"""Chains over a mesh of ranks (counterpart of
sampler_tpu/parallel/chains.py).

  * Inference: independent chains are embarrassingly parallel.  Each rank
    sweeps its own ``chains_per_device`` chains from its own generator
    (``init_values_mc``, burn-in, ``run_inference_mc``), and the tallies
    are summed over the ``chains`` group once at the end.
  * Learning: data-parallel.  Each rank keeps its own evidence and free
    worlds, takes the weight gradient on its chains, and the gradients
    are averaged over the ``chains`` group every epoch
    (``learn_step_sharded``), so every rank applies the same update.

The rank bodies (``_infer_rank``, ``_learn_rank``) are plain functions of
the rank's ``comm.Comm``: ``launch`` runs them in ranks it starts, and
``multihost`` in a process group the caller started.  Graph sharding is
the mesh's second axis (``parallel.graph_shard``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..compile import to_device
from ..engine.learn import apply_update
from ..engine.multichain import (check_modes, init_values_mc,
                                 mc_weight_gradient_cs, prepare_fold,
                                 resolve_modes, run_inference_mc,
                                 run_sweeps_mc, sweep_mc)
from ..engine.rng import chunk_generator
from . import launch
from .comm import make_mesh

__all__ = ["make_mesh", "infer_sharded", "learn_sharded",
           "learn_step_sharded", "reduced_gradient"]


def host_graph(dg):
    """``dg`` (compile_graph's numpy graph, or a port DeviceGraph of
    tensors on any device) as flat CPU tensors, the form the ranks are
    handed."""
    if isinstance(dg.var_card, torch.Tensor):
        return dg._replace(
            tiers=tuple(ts._replace(**{f: getattr(ts, f).cpu()
                                       for f in ts._fields})
                        for ts in dg.tiers),
            **{f: getattr(dg, f).cpu() for f in dg._fields if f != "tiers"})
    return to_device(dg, "cpu")


def learn_alpha(cfg, epoch: int) -> float:
    """The step size of epoch ``epoch``: stepsize * diminish**epoch, from
    the absolute epoch, so a chunked or resumed run steps as one call."""
    return float(np.float32(cfg.stepsize * cfg.diminish ** epoch))


def _rank_setup(comm, host, weights, info, modes):
    d = to_device_graph(host, comm.device)
    modes = (resolve_modes(info, comm.device) if modes is None
             else check_modes(modes, comm.device))
    return d, weights.to(comm.device, torch.float32), modes


def to_device_graph(dg, device):
    """A host DeviceGraph of tensors moved to ``device``."""
    return dg._replace(
        tiers=tuple(ts._replace(**{f: getattr(ts, f).to(device)
                                   for f in ts._fields})
                    for ts in dg.tiers),
        **{f: getattr(dg, f).to(device) for f in dg._fields if f != "tiers"})


def _infer_rank(comm, host, weights, seed, n_burn, n_sweeps, info,
                n_chains, sample_evidence, modes):
    """One rank of infer_sharded: (marginals [V, K], this rank's world)."""
    d, w, modes = _rank_setup(comm, host, weights, info, modes)
    dev = comm.device
    gen = chunk_generator(seed, "infer", 0, dev, comm.row)
    values = init_values_mc(d, gen, n_chains, info)
    if n_burn:
        values = run_sweeps_mc(d, values, w, gen, n_burn, sample_evidence,
                               info, modes, dev)
    values, counts = run_inference_mc(d, values, w, gen, n_sweeps,
                                      sample_evidence, info, modes, dev)
    counts = comm.sum_(counts.to(torch.int64), "chains")
    K = info.max_card
    cnt = counts.cpu().numpy().reshape(K, -1).T
    marg = cnt[host.pos_of_vid.numpy()].astype(np.float32) / np.float32(
        n_sweeps * n_chains * comm.mesh.n_chains)
    return marg, values


def infer_sharded(dg, weights, seed: int, n_burn: int, n_sweeps: int, info,
                  mesh, chains_per_device: int,
                  sample_evidence: bool = False, modes=None) -> tuple:
    """Chain-parallel inference on a mesh (``comm.Mesh`` or open
    ``launch.Ranks``) of one graph column: every rank runs
    ``chains_per_device`` chains of the whole graph.  Returns (marginals
    [V, K] float32, rank 0's world [P, chains_per_device])."""
    _chains_mesh(mesh, modes)
    return launch.run(mesh, _infer_rank, host_graph(dg),
                      torch.as_tensor(weights).cpu(), seed, n_burn, n_sweeps,
                      info, chains_per_device, sample_evidence, modes)


def _chains_mesh(mesh, modes):
    """The mesh of ``mesh`` (a Mesh or Ranks), checked to be one graph
    column and to run ``modes``."""
    m = mesh.mesh if isinstance(mesh, launch.Ranks) else mesh
    if m.n_graph != 1:
        raise ValueError(f"a chains mesh has one graph column, not "
                         f"{m.n_graph}: shard the graph with "
                         "parallel.graph_shard")
    if modes is not None:
        check_modes(modes, m.devices[0])
    return m


def learn_step_sharded(comm, d, w, v_ev, v_free, generator, alpha: float,
                       cfg, info, modes, shard=None) -> torch.Tensor:
    """One data-parallel epoch on this rank: the weights folded, both
    worlds (in place) take ``cfg.n_sweeps_per_epoch`` sweeps from
    ``generator``, the gradient of the rank's chains (summed over the graph
    group under graph sharding) is averaged over the chains group, and
    the update applied.  Returns the new weights (the same on every
    rank)."""
    folded = prepare_fold(d, w, info, modes)
    for _ in range(cfg.n_sweeps_per_epoch):
        sweep_mc(d, v_ev, w, generator, False, info, folded, modes, shard)
        sweep_mc(d, v_free, w, generator, True, info, folded, modes, shard)
    grad = reduced_gradient(comm, d, v_ev, v_free, cfg.learn_non_evidence,
                            info, modes, shard)
    return apply_update(w, grad, d.w_fixed, alpha, cfg.regularization,
                        cfg.reg_param)


def reduced_gradient(comm, d, v_ev, v_free, learn_non_evidence: bool, info,
                     modes, shard=None) -> torch.Tensor:
    """The weight gradient of the whole mesh's chains: this rank's, on its
    local streams (its own records under graph sharding), summed over the
    graph group and averaged over the chains group; the gradient of the
    unsharded graph on the chains rows' worlds side by side."""
    n, g = (1, 0) if shard is None else (shard.n_graph, shard.g)
    grad = mc_weight_gradient_cs(d, v_ev, v_free, learn_non_evidence, info,
                                 modes, n_graph=n, g=g)
    if shard is not None:
        shard.psum(grad)
    return comm.mean_(grad, "chains")


def _learn_rank(comm, host, weights, seed, cfg, info, n_chains, modes):
    """One rank of learn_sharded; returns the weights (every rank)."""
    d, w, modes = _rank_setup(comm, host, weights, info, modes)
    dev = comm.device
    gen = chunk_generator(seed, "learn_init", 0, dev, comm.row)
    v_ev = init_values_mc(d, gen, n_chains, info)
    v_free = init_values_mc(d, gen, n_chains, info)
    for e in range(cfg.n_epochs):
        w = learn_step_sharded(
            comm, d, w, v_ev, v_free,
            chunk_generator(seed, "learn", e, dev, comm.row),
            learn_alpha(cfg, e), cfg, info, modes)
    return w.cpu()


def learn_sharded(dg, weights, seed: int, cfg, info, mesh,
                  chains_per_device: int = 1, modes=None) -> torch.Tensor:
    """Data-parallel learning on a mesh of one graph column; returns the
    weights [W] float32 (CPU)."""
    _chains_mesh(mesh, modes)
    return launch.run(mesh, _learn_rank, host_graph(dg),
                      torch.as_tensor(weights).cpu(), seed, cfg, info,
                      chains_per_device, modes)
