"""Ranks in a process group that the caller starts itself: one process a
rank, on one host or many (counterpart of sampler_tpu/parallel/multihost.py).

``init_multihost`` joins this process to the group (from its arguments or
from the ``torchrun`` environment).  Every process then calls the same
entry point with the same inputs: ``infer_multihost`` and
``learn_multihost`` on the chains mesh of every rank, or
``chains.infer_sharded``, ``learn_sharded``, ``graph_shard.infer_gs`` and
``learn_gs`` on any mesh of the group's size.  Each process runs its own
rank of the same rank bodies that ``launch`` runs in ranks it starts, so
the results are those of the single-process call, bit for bit.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .chains import infer_sharded, learn_sharded
from .comm import Comm, Mesh
from .launch import TIMEOUT_S

_COMMS: dict = {}      # this process's Comm of each mesh (groups are made once)


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   backend: str | None = None) -> None:
    """Join this process to the process group: ``init_method`` (a
    ``file://`` or ``tcp://`` address), ``world_size`` and ``rank``, or,
    with none of them, the ``torchrun`` environment (``env://``).
    ``backend`` defaults to "nccl" with a card and "gloo" without."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def global_chains_mesh(device=None) -> Mesh:
    """The chains mesh of every rank of the group; each process names its
    own device (default: the card of its ``LOCAL_RANK``).  A collective:
    every process calls it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu'")
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, str(torch.device(device)))
    return Mesh(len(devices), 1, tuple(devices), dist.get_backend())


def group_comm(mesh: Mesh) -> Comm:
    """This process's rank of ``mesh`` in the running process group (made
    once a mesh; a collective the first time)."""
    if mesh.backend != dist.get_backend():
        raise ValueError(f"mesh backend {mesh.backend}, process group "
                         f"{dist.get_backend()}")
    if mesh not in _COMMS:
        rank = dist.get_rank()
        dev = torch.device(mesh.devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _COMMS[mesh] = Comm(mesh, rank)
    return _COMMS[mesh]


def infer_multihost(dg, weights, seed: int, n_burn: int, n_sweeps: int,
                    info, mesh: Mesh | None = None,
                    chains_per_device: int = 8,
                    sample_evidence: bool = False, modes=None):
    """Chain-parallel inference over every rank of the group; returns the
    marginals [V, K] float32 (the same on every process)."""
    if mesh is None:
        mesh = global_chains_mesh()
    return infer_sharded(dg, weights, seed, n_burn, n_sweeps, info, mesh,
                         chains_per_device, sample_evidence, modes)[0]


def learn_multihost(dg, weights, seed: int, cfg, info,
                    mesh: Mesh | None = None, chains_per_device: int = 1,
                    modes=None) -> torch.Tensor:
    """Data-parallel learning over every rank of the group, the gradient
    averaged every epoch; returns the weights [W] (the same on every
    process)."""
    if mesh is None:
        mesh = global_chains_mesh()
    return learn_sharded(dg, weights, seed, cfg, info, mesh,
                         chains_per_device, modes)
