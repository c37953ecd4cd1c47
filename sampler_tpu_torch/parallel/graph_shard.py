"""Graph-sharded sweeps: the model-parallel axis for graphs whose streams
outgrow one device (counterpart of sampler_tpu/parallel/graph_shard.py).

On a mesh of ``n_chains x n_graph`` ranks (``comm``), the ranks of one
chains row split the graph: rank g holds the contiguous 1/n_graph run of
every tier segment of every color block of the streams, draws only those
rows, and brings the other ranks' slices in after each (color, tier)
step.  The worlds ``values [P, NC]`` stay whole on every rank; chains
rows are independent, as in ``parallel.chains``.

Two exchanges, as in the JAX package:
  * all-gather: every rank receives the whole tier segment (n_graph - 1
    slices a step);
  * halo: where every tier has compile-time read bounds (bd_lo/bd_hi),
    ``halo_plan`` says how many owner slices left (nl) and right (nr) of
    its own any rank ever reads, and the step shifts only those
    (nl + nr slices).  A rank's world is then fresh only where it reads.
Tallies count each rank's own rows in both modes (``own_runs``; in
halo mode the others may be stale), with ``ops.tally.tally_counts`` on
each run, and sum over both groups.

Randomness: each sweep (or learning epoch) of each rank draws from a
generator derived from (seed, phase, absolute index, chains row, graph
index) (``engine.rng.chunk_generator``): the graph index MUST enter, or the
ranks of a row would draw a block with the same noise.  A run in
checkpoint chunks, or resumed from one, draws what a single call does,
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compile import FLAT_TIER_FIELDS, TierStreams
from ..engine.multichain import (check_modes, init_values_mc, prepare_fold,
                                 resolve_modes, sweep_mc, tally)
from ..engine.rng import chunk_generator
from . import launch
from .chains import (host_graph, learn_alpha, learn_step_sharded,
                     to_device_graph)
from .comm import make_mesh

__all__ = ["make_mesh", "check_shardable", "halo_plan", "shard_device_graph",
           "own_runs", "infer_gs", "learn_gs", "Shard"]

# stream families split over the graph group (on their record, row, chunk
# or tile axis); gd_* (grad_pair_tile's streams, which sharded learning
# does not run) and [C, 1] placeholders are replicated, as in the JAX
# package
SPLIT_PREFIXES = ("cs_", "cm_", "ab_", "dm_", "hb_", "bd_")


def check_shardable(info, n_graph: int) -> None:
    """Every tier block must split evenly over the graph axis, and banded
    tiers must keep whole band tiles per shard.  Compile with
    ``compile_graph(g, align=8*n_graph, shards=n_graph)``."""
    for t, ti in enumerate(info.tiers):
        if ti.hub and ti.chunks % n_graph:
            raise ValueError(
                f"hub tier {t} chunk count {ti.chunks} not divisible by "
                f"graph axis {n_graph}; compile with shards={n_graph}")
        if ti.block % n_graph:
            raise ValueError(
                f"tier {t} block {ti.block} not divisible by graph axis "
                f"{n_graph}; compile with align=8*{n_graph}, "
                f"shards={n_graph}")
        if ti.band_w and (ti.block // n_graph) % ti.band_tb:
            raise ValueError(
                f"tier {t} local block {ti.block // n_graph} breaks band "
                f"tiles of {ti.band_tb}; compile with shards={n_graph}")


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def halo_plan(dg, info, n_graph: int):
    """How far (in owner slices) any rank's reads reach beyond its own
    slices: returns (nl, nr), or None when the halo exchange does not apply
    (no read-bounds plan, misaligned tiles, or no win over the full
    all-gather).

    Reads come from each tier's bd_lo/bd_hi (true per-tile read bounds
    over cs_nbr, valid whether the gather runs banded or plain) and
    target positions in any tier's segment of any color block; the owner
    of row r of tier t' is (r - off_t') // (block_t' / n_graph).
    """
    if not getattr(info, "bounds", False) or n_graph <= 1:
        return None
    B = info.block_size
    C = info.n_colors
    segs = [(ti.off, ti.block) for ti in info.tiers]
    nl = nr = 0
    for ti_r, ts in zip(info.tiers, dg.tiers):
        lo = _np(ts.bd_lo).astype(np.int64)
        hi = _np(ts.bd_hi).astype(np.int64)
        _, ntiles = lo.shape
        if ntiles % n_graph or ti_r.block % n_graph:
            return None
        tpd = ntiles // n_graph
        g = (np.arange(ntiles) // tpd)[None, :]       # reader rank per tile
        valid = lo < hi
        for c in range(C):
            lc = np.clip(lo - c * B, 0, B)
            hc = np.clip(hi - c * B, 0, B)
            v = valid & (lc < hc)
            if not v.any():
                continue
            for (o2, b2) in segs:
                Bl2 = b2 // n_graph
                l2 = np.maximum(lc, o2)
                h2 = np.minimum(hc, o2 + b2)
                v2 = v & (l2 < h2)
                if not v2.any():
                    continue
                jmin = (l2 - o2) // Bl2
                jmax = (h2 - 1 - o2) // Bl2
                nl = max(nl, int(np.where(v2, g - jmin, 0).max()))
                nr = max(nr, int(np.where(v2, jmax - g, 0).max()))
    nl, nr = max(nl, 0), max(nr, 0)
    if nl + nr >= n_graph - 1:
        return None
    return nl, nr


def _strip_factor_records(dg):
    """Replace the per-factor record arrays with 1-row placeholders before
    a graph-sharded run: the sweep and the cs-stream gradient never read
    them (they serve the per-factor gradient), and every rank would hold
    them whole.  Sparse-weight graphs keep cwt_wid (the combination
    table, read by the sweep and the gradient).  pos_of_vid stays: rank 0
    maps its tallies to variables with it."""
    A = dg.f_vids.numel() // dg.f_type.shape[0]
    z = torch.zeros
    return dg._replace(
        f_vids=z(A, dtype=torch.int32), f_ispos=z(A, dtype=torch.bool),
        f_eqpred=z(A, dtype=dg.f_eqpred.dtype),
        f_mask=z(A, dtype=torch.bool), f_type=z(1, dtype=torch.int8),
        f_wid=z(1, dtype=torch.int32), f_feat=z(1, dtype=torch.float32),
        f_arity=torch.ones(1, dtype=torch.int16),
        f_cwbase=torch.full((1,), -1, dtype=torch.int32),
        f_cwstride=z(A, dtype=torch.int32))


def _split(name: str, a: torch.Tensor, C: int, n_graph: int,
           g: int) -> torch.Tensor:
    """Rank g's part of one tier field: the contiguous 1/n_graph run of
    each color's records (flat streams, [C, N] per color), rows, chunks
    or tiles (axis 1 of [C, X, ...] fields), or the whole field."""
    if not name.startswith(SPLIT_PREFIXES) or a.numel() == 0:
        return a
    if name in FLAT_TIER_FIELDS:
        a = a.view(C, -1)
        flat = True
    else:
        flat = False
    if a.dim() < 2 or a.shape[1] <= 1:
        return a.reshape(-1) if flat else a
    if a.shape[1] % n_graph:
        raise ValueError(f"{name} {tuple(a.shape)} does not split over "
                         f"graph axis {n_graph}")
    k = a.shape[1] // n_graph
    part = a[:, g * k:(g + 1) * k].contiguous()
    return part.reshape(-1) if flat else part


def shard_device_graph(dg, info, n_graph: int, g: int, device="cuda"):
    """Rank g's local DeviceGraph on ``device`` (the card by default, as
    ``compile.to_device``; pass "cpu" for the CPU): for each tier and color,
    the contiguous 1/n_graph run of every record stream (cs_, cm_, ab_,
    dm_, hb_; re-flattened, so tier_geom and the engine read a local
    block of block / n_graph rows, or chunks / n_graph hub chunks), the
    bd_ plans cut on their tile axis, and the rest (the per-position and
    weight arrays, gd_ streams, [C, 1] placeholders) whole.  ``dg`` is
    compile_graph's host graph or a port DeviceGraph of tensors."""
    dg = host_graph(dg)
    C = info.n_colors
    tiers = tuple(
        TierStreams(**{f: _split(f, getattr(ts, f), C, n_graph, g)
                       for f in TierStreams._fields})
        for ts in dg.tiers)
    return to_device_graph(dg._replace(tiers=tiers), device)


def own_runs(info, n_graph: int, g: int) -> list:
    """[(start, stop)] position runs rank g owns: its slice of every tier
    segment of every color block, adjacent runs merged (one run [0, C*B)
    at n_graph 1)."""
    B = info.block_size
    runs = []
    for c in range(info.n_colors):
        for ti in info.tiers:
            Bl = ti.block // n_graph
            start = c * B + ti.off + g * Bl
            if runs and runs[-1][1] == start:
                runs[-1] = (runs[-1][0], start + Bl)
            else:
                runs.append((start, start + Bl))
    return runs


def _own_rowmask(info, n_graph: int, g: int, n_rows: int) -> torch.Tensor:
    """bool [n_rows, 1]: the positions rank g owns (dummy rows never)."""
    own = torch.zeros(n_rows, dtype=torch.bool)
    for r0, r1 in own_runs(info, n_graph, g):
        own[r0:r1] = True
    return own[:, None]


def exchange_bytes(info, n_graph: int, halo, n_chains: int,
                   itemsize: int = 1) -> int:
    """Bytes one interior rank receives in one color step (all tiers):
    n_graph - 1 slices a tier under all-gather, nl + nr under halo."""
    slices = n_graph - 1 if halo is None else sum(halo)
    return sum(slices * (ti.block // n_graph) * n_chains * itemsize
               for ti in info.tiers)


class Shard:
    """A rank's place on the graph axis for ``color_step_mc``: its index
    ``g`` of ``n_graph``, the partial-sum reduce of the hub tier
    (``psum``) and the exchange after each tier (``exchange``)."""

    def __init__(self, comm, info, halo=None):
        self.comm = comm
        self.info = info
        self.halo = halo
        self.n_graph = comm.mesh.n_graph
        self.g = comm.g

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.sum_(t, "graph")

    def exchange(self, values: torch.Tensor, c: int, t: int) -> None:
        """Bring the other ranks' slices of tier t, color c into
        ``values``: all of them, or (halo) the nl to the left and nr to the
        right of this rank's."""
        ti = self.info.tiers[t]
        seg = c * self.info.block_size + ti.off
        if self.halo is None:
            self.comm.all_gather_rows(values[seg:seg + ti.block], "graph")
            return
        n, g = self.n_graph, self.g
        Bl = ti.block // n
        own = values[seg + g * Bl:seg + (g + 1) * Bl]

        def slice_of(h):
            return (values[seg + h * Bl:seg + (h + 1) * Bl]
                    if 0 <= h < n else None)

        nl, nr = self.halo
        for j in range(1, nl + 1):      # owner g-j's slice travels right
            self.comm.shift(own, slice_of(g - j), j, "graph")
        for j in range(1, nr + 1):      # owner g+j's slice travels left
            self.comm.shift(own, slice_of(g + j), -j, "graph")


def _local(comm, host, info, modes):
    """(the rank's local graph on its device, the modes)."""
    n = comm.mesh.n_graph
    dl = shard_device_graph(_strip_factor_records(host), info, n, comm.g,
                            comm.device)
    modes = (resolve_modes(info, comm.device) if modes is None
             else check_modes(modes, comm.device))
    return dl, modes


def _canonical(comm, values, info, halo) -> torch.Tensor:
    """The rank's world with every row fresh: as it is under all-gather;
    under halo each rank's own rows, summed over the graph group (the
    others zero).  Then the chains rows side by side, [P, NC * n_chains]
    (a collective: every rank calls it)."""
    n = comm.mesh.n_graph
    if halo is not None and n > 1:
        mask = _own_rowmask(info, n, comm.g, values.shape[0]).to(
            values.device)
        values = comm.sum_(torch.where(mask, values, 0).to(values.dtype),
                           "graph")
    nc = comm.mesh.n_chains
    P, NC = values.shape
    buf = torch.empty((nc * P, NC), dtype=values.dtype, device=values.device)
    buf[comm.row * P:(comm.row + 1) * P] = values
    comm.all_gather_rows(buf, "chains")
    return buf.view(nc, P, NC).permute(1, 0, 2).reshape(P, nc * NC)


def _own_cols(world: np.ndarray, comm, n_chains: int, device):
    """This chains row's columns of a whole checkpointed world."""
    cols = world[:, comm.row * n_chains:(comm.row + 1) * n_chains]
    return torch.from_numpy(np.ascontiguousarray(cols)).to(device)


def _infer_gs_rank(comm, host, weights, seed, n_burn, n_sweeps, info,
                   n_chains, sample_evidence, modes, halo, every, resume,
                   gather, on_checkpoint=None):
    """One rank of infer_gs; returns the marginals [V, K] (every rank)."""
    dev = comm.device
    n = comm.mesh.n_graph
    dl, modes = _local(comm, host, info, modes)
    shard = Shard(comm, info, halo) if n > 1 else None
    w = weights.to(dev, torch.float32)
    P, K = host.var_card.shape[0], info.max_card
    if resume is not None:
        done, world, counts_acc = resume
        values = _own_cols(world, comm, n_chains, dev)
        counts_acc = np.asarray(counts_acc, np.int64).copy()
    else:
        done = 0
        values = init_values_mc(
            dl, chunk_generator(seed, "gs_init", 0, dev, comm.row), n_chains,
            info)
        counts_acc = np.zeros((P, K), np.int64)
    runs = own_runs(info, n, comm.g)
    folded = prepare_fold(dl, w, info, modes, plan=shard is None)
    n_total = n_burn + n_sweeps
    while done < n_total:
        stop = min(done + (every or n_total), n_total)
        segs = [torch.zeros((K, r1 - r0), dtype=torch.int32, device=dev)
                for r0, r1 in runs]
        for i in range(done, stop):
            gen = chunk_generator(seed, "gs_sweep", i, dev, comm.row, comm.g)
            sweep_mc(dl, values, w, gen, sample_evidence, info, folded,
                     modes, shard)
            if i >= n_burn:
                for (r0, r1), seg in zip(runs, segs):
                    tally(seg, values[r0:r1])
        done = stop
        counts = torch.zeros((K, P), dtype=torch.int64, device=dev)
        for (r0, r1), seg in zip(runs, segs):
            counts[:, r0:r1] = seg
        if n > 1:
            comm.sum_(counts, "graph")
        comm.sum_(counts, "chains")
        counts_acc += counts.cpu().numpy().T
        if gather:
            world = _canonical(comm, values, info, halo)
            if on_checkpoint is not None:
                on_checkpoint(done, world.cpu().numpy(), counts_acc.copy())
    total = n_sweeps * n_chains * comm.mesh.n_chains
    pos = host.pos_of_vid.numpy()
    return counts_acc[pos].astype(np.float32) / np.float32(total)


def _prepare(dg, info, mesh, modes, halo):
    """(host graph, halo plan) of a sharded call, its arguments checked."""
    m = mesh.mesh if isinstance(mesh, launch.Ranks) else mesh
    n_graph = m.n_graph
    check_shardable(info, n_graph)
    host = host_graph(dg)
    if modes is not None:
        check_modes(modes, m.devices[0])
    if halo == "auto":
        halo = halo_plan(host, info, n_graph)
    elif halo is not None and n_graph <= 1:
        halo = None
    return host, (None if halo is None else tuple(halo))


def infer_gs(dg, weights, seed: int, n_burn: int, n_sweeps: int, info,
             mesh, chains_per_device: int, sample_evidence: bool = False,
             modes=None, halo="auto", checkpoint_every: int = 0,
             on_checkpoint=None, resume_state=None) -> np.ndarray:
    """Marginal inference on a ``(chains, graph)`` mesh (a ``comm.Mesh``
    or open ``launch.Ranks``): streams split over the graph group, each
    rank sweeping ``chains_per_device`` chains of its chains row.
    Returns marginals [V, K] float32.

    halo: "auto" derives the exchange plan from the compile-time read
    bounds (all-gather where it does not apply); None forces the
    all-gather; an explicit (nl, nr) is used as it is.

    Checkpoints: with ``checkpoint_every=N`` the n_burn + n_sweeps sweeps
    run in N-sweep chunks, and after each ``on_checkpoint(sweeps_done,
    values, counts)`` receives the world [P, chains_per_device *
    n_chains] (every row fresh) and the int64 tally [P, K] so far.
    ``resume_state=(sweeps_done, values, counts)`` continues one."""
    host, halo = _prepare(dg, info, mesh, modes, halo)
    gather = on_checkpoint is not None
    return launch.run(
        mesh, _infer_gs_rank, host, torch.as_tensor(weights).cpu(), seed,
        n_burn, n_sweeps, info, chains_per_device, sample_evidence, modes,
        halo, checkpoint_every, resume_state, gather,
        rank0_kwargs={"on_checkpoint": on_checkpoint})


def _learn_gs_rank(comm, host, weights, seed, cfg, info, n_chains, modes,
                   halo, every, resume, gather, on_checkpoint=None):
    """One rank of learn_gs; returns the weights (every rank)."""
    dev = comm.device
    n = comm.mesh.n_graph
    dl, modes = _local(comm, host, info, modes)
    shard = Shard(comm, info, halo) if n > 1 else None
    if resume is not None:
        done, w, v_ev, v_free = resume
        w = torch.as_tensor(np.asarray(w, np.float32)).to(dev)
        v_ev = _own_cols(v_ev, comm, n_chains, dev)
        v_free = _own_cols(v_free, comm, n_chains, dev)
    else:
        done, w = 0, weights.to(dev, torch.float32)
        gen = chunk_generator(seed, "gs_learn_init", 0, dev, comm.row)
        v_ev = init_values_mc(dl, gen, n_chains, info)
        v_free = init_values_mc(dl, gen, n_chains, info)
    while done < cfg.n_epochs:
        stop = min(done + (every or cfg.n_epochs), cfg.n_epochs)
        for e in range(done, stop):
            gen = chunk_generator(seed, "gs_learn", e, dev, comm.row, comm.g)
            w = learn_step_sharded(comm, dl, w, v_ev, v_free, gen,
                                   learn_alpha(cfg, e), cfg, info, modes,
                                   shard)
        done = stop
        if gather:
            ev = _canonical(comm, v_ev, info, halo)
            free = _canonical(comm, v_free, info, halo)
            if on_checkpoint is not None:
                on_checkpoint(done, w.cpu().numpy(), ev.cpu().numpy(),
                              free.cpu().numpy())
    return w.cpu()


def learn_gs(dg, weights, seed: int, cfg, info, mesh,
             chains_per_device: int, modes=None, halo="auto",
             checkpoint_every: int = 0, on_checkpoint=None,
             resume_state=None) -> torch.Tensor:
    """Contrastive-SGD learning on a ``(chains, graph)`` mesh, for graphs
    whose streams outgrow one device.  Both worlds sweep with the graph
    split (the exchange included); the gradient is taken on each rank's
    local streams (``mc_weight_gradient_cs`` with its owner records,
    disjoint across the graph group), summed over the graph group and
    averaged over the chains group every epoch: the update rule and fixed
    points of ``engine.multichain.learn_mc``.  Returns the weights [W]
    float32 (CPU).

    Checkpoints: with ``checkpoint_every=N`` epochs run in N-epoch chunks,
    and after each ``on_checkpoint(epochs_done, w, v_ev, v_free)``
    receives host snapshots (worlds whole, every row fresh).
    ``resume_state=(epochs_done, w, v_ev, v_free)`` continues one.  Epoch
    e steps by stepsize * diminish**e, so chunks and resumes change
    nothing."""
    host, halo = _prepare(dg, info, mesh, modes, halo)
    gather = on_checkpoint is not None
    return launch.run(
        mesh, _learn_gs_rank, host, torch.as_tensor(weights).cpu(), seed,
        cfg, info, chains_per_device, modes, halo, checkpoint_every,
        resume_state, gather, rank0_kwargs={"on_checkpoint": on_checkpoint})
