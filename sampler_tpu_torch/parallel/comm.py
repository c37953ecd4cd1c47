"""A mesh of ranks and the collectives the sharded engine needs, on
torch.distributed (no counterpart in the JAX package, whose collectives
are XLA's).

A mesh is a grid of ``n_chains x n_graph`` ranks, one process each, rank
``row * n_graph + g``; each rank owns one device.  The JAX package's mesh
axes become two families of process groups: the ``chains`` group of a
graph index g (the ranks of column g, which pool tallies and average
gradients) and the ``graph`` group of a chains row (the ranks of that
row, which split a graph's streams and exchange the drawn slices).

The backend is named, never picked on failure: ``nccl`` for distinct
cards, ``gloo`` for the CPU and for a mesh that repeats a card (NCCL
refuses two ranks on one card).  Under Gloo with CUDA tensors, the
neighbour shift goes through pinned host buffers: Gloo's send and
receive abort on a CUDA tensor ("writev ... Bad address", PyTorch 2.11
on an H100), while its all-reduce and all-gather take CUDA tensors
themselves.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``n_chains x n_graph`` grid of ranks: ``devices[r]`` is rank r's
    device, rank r = row * n_graph + g."""
    n_chains: int
    n_graph: int
    devices: tuple
    backend: str

    @property
    def size(self) -> int:
        return self.n_chains * self.n_graph


def make_mesh(n_chains: int, n_graph: int, devices=None,
              backend: str | None = None) -> Mesh:
    """The grid of ``n_chains x n_graph`` ranks over ``devices`` (default:
    the first n_chains * n_graph cards; raises without enough of them).
    ``backend`` defaults to "nccl" on distinct cards and "gloo" on the CPU;
    a mesh that repeats a card must name "gloo"."""
    n = n_chains * n_graph
    if n_chains < 1 or n_graph < 1:
        raise ValueError(f"mesh {n_chains} x {n_graph}")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(
                f"a {n_chains} x {n_graph} mesh needs {n} CUDA devices, "
                f"{count} available; pass devices= (e.g. ['cpu'] * {n})")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) < n:
        raise ValueError(f"a {n_chains} x {n_graph} mesh needs {n} devices, "
                         f"{len(devs)} given")
    devs = tuple(d if d.type != "cuda" or d.index is not None
                 else torch.device("cuda", 0) for d in devs[:n])
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"mesh devices must be all 'cpu' or all 'cuda': "
                         f"{devs}")
    cuda = kinds == {"cuda"}
    if backend is None:
        if cuda and len(set(devs)) < n:
            raise ValueError(
                "the mesh repeats a card; NCCL refuses two ranks on one "
                "card: pass backend='gloo'")
        backend = "nccl" if cuda else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend}")
    if backend == "nccl" and (not cuda or len(set(devs)) < n):
        raise ValueError("backend 'nccl' needs a distinct card for every "
                         "rank")
    return Mesh(n_chains, n_graph, tuple(str(d) for d in devs), backend)


class Comm:
    """One rank's view of a mesh inside its process group: its
    coordinates (row, g), its device and the two groups it belongs to.

    Every rank constructs it at once (``dist.new_group`` is collective).
    A group's members are ordered by row ("chains") or by graph index
    ("graph")."""

    def __init__(self, mesh: Mesh, rank: int):
        if dist.get_world_size() != mesh.size:
            raise ValueError(f"process group of {dist.get_world_size()} "
                             f"ranks, mesh of {mesh.size}")
        self.mesh = mesh
        self.rank = rank
        self.row, self.g = divmod(rank, mesh.n_graph)
        self.device = torch.device(mesh.devices[rank])
        self.stage = mesh.backend == "gloo" and self.device.type == "cuda"
        nc, ng = mesh.n_chains, mesh.n_graph
        self._ranks = {"chains": [r * ng + self.g for r in range(nc)],
                       "graph": [self.row * ng + j for j in range(ng)]}
        self._groups = {}
        # every rank creates every group, in one order
        for kind, count, members in (
                ("chains", ng, lambda j: [r * ng + j for r in range(nc)]),
                ("graph", nc, lambda j: [j * ng + x for x in range(ng)])):
            for j in range(count):
                grp = dist.new_group(members(j))
                if rank in members(j):
                    self._groups[kind] = grp

    def sum_(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Sum ``t`` over the ``kind`` group, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._groups[kind])
        return t

    def mean_(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Average ``t`` over the ``kind`` group, in place (the sum, then a
        division by the group's size); returns ``t``."""
        self.sum_(t, kind)
        return t.div_(len(self._ranks[kind]))

    def all_gather_rows(self, out: torch.Tensor, kind: str) -> None:
        """``out`` [n * rows, ...], a contiguous run of rows: member j of the
        ``kind`` group contributes rows j*rows .. (j+1)*rows of its own
        ``out``, and every member receives everyone's (JAX's
        ``all_gather(..., tiled=True)``), in place."""
        n = len(self._ranks[kind])
        j = self._ranks[kind].index(self.rank)
        mine = out.chunk(n)[j].clone()
        dist.all_gather(list(out.chunk(n)), mine, group=self._groups[kind])

    def shift(self, send: torch.Tensor, recv: torch.Tensor, j: int,
              kind: str) -> bool:
        """Neighbour shift by ``j`` along the ``kind`` group (JAX's
        ``ppermute`` with pairs (h, h + j)): member h sends ``send`` to
        member h + j and receives into ``recv`` from member h - j, where
        those exist.  Returns whether ``recv`` was written."""
        ranks = self._ranks[kind]
        me = ranks.index(self.rank)
        # Gloo's send/recv abort on CUDA tensors (probed on the card):
        # under Gloo on a card both go through pinned host buffers
        ops, rbuf = [], None
        if 0 <= me + j < len(ranks):
            sbuf = _pinned(send.shape, send.dtype).copy_(send) \
                if self.stage else send
            ops.append(dist.P2POp(dist.isend, sbuf, ranks[me + j],
                                  self._groups[kind]))
        if 0 <= me - j < len(ranks):
            rbuf = _pinned(recv.shape, recv.dtype) if self.stage else recv
            ops.append(dist.P2POp(dist.irecv, rbuf, ranks[me - j],
                                  self._groups[kind]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if rbuf is not None and self.stage:
            recv.copy_(rbuf)
        return rbuf is not None


def _pinned(shape, dtype) -> torch.Tensor:
    """A page-locked host buffer (PyTorch's host allocator caches them)."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)
