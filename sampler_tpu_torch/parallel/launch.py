"""Start the ranks of a mesh and run one function in all of them.

Rank 0 is the calling process; ranks 1 .. n-1 are processes started with
``torch.multiprocessing``'s ``spawn`` (CUDA forbids ``fork``).  They join
one process group (rendezvous through a ``file://`` store in a temporary
directory, so concurrent runs cannot collide on a port) and build their
``comm.Comm``.  A call sends every rank the same function and arguments
(CPU tensors travel through shared memory, so a host graph is handed over,
never compiled again) and returns rank 0's result.  A rank that fails
makes the call raise with that rank's traceback; the ranks then exit,
since their collectives can no longer pair up.

``Ranks(mesh)`` keeps the processes for several calls (each start pays a
Python and CUDA start-up in every rank); the entry points take either a
``Ranks`` or a ``comm.Mesh``, which starts ranks for one call.  Inside a
process group that the caller started itself (``multihost``), every
process runs its own rank of the call instead.

Before it starts a rank on a card the parent builds the CUDA kernels
(``ops._build.build``), so the ranks load one library instead of each
running nvcc on the same files.
"""
from __future__ import annotations

import ctypes
import datetime
import os
import shutil
import signal
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import kernel_launches
from .comm import Comm, Mesh

TIMEOUT_S = 900        # a collective that waits longer than this fails
JOIN_TIMEOUT_S = 60    # how long a closing pool waits for its ranks
FAIL_WAIT_S = 2        # how long a failed call waits for the ranks' reports

# the Ranks whose process group this process is rank 0 of (a process holds
# one process group at a time)
_open: list = []


def _join(mesh: Mesh, rank: int, path: str) -> Comm:
    dev = torch.device(mesh.devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(mesh.backend, init_method=f"file://{path}",
                            rank=rank, world_size=mesh.size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Comm(mesh, rank)


def _die_with_parent() -> None:
    """Have the kernel kill this process when its parent dies (Linux), so
    a parent killed mid-run leaves no rank waiting in a collective."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:
        return
    libc.prctl(1, signal.SIGKILL)       # PR_SET_PDEATHSIG


def _rank_main(mesh: Mesh, rank: int, path: str, threads: int,
               conn) -> None:
    """A spawned rank: join the group, then run each job the parent sends
    until it sends None.  A failure is reported with its traceback and
    ends the process."""
    _die_with_parent()
    torch.set_num_threads(threads)
    try:
        comm = _join(mesh, rank, path)
        conn.send(("ready", None))
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, args = job
            before = kernel_launches()
            fn(comm, *args)
            after = kernel_launches()
            conn.send(("ok", {k: after[k] - before[k] for k in after}))
        dist.destroy_process_group()
    except BaseException:               # reported, then the rank exits
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)
    conn.close()


class Ranks:
    """The processes of a mesh, started once and used by every call made
    through them until ``close`` (or the end of a ``with`` block).

    ``launches`` holds, after each call, every rank's kernel launches in
    that call (rank 0's counted in this process)."""

    def __init__(self, mesh: Mesh):
        if dist.is_initialized():
            raise RuntimeError(
                "a process group is already running in this process (ranks "
                "of a mesh are open, or multihost): close them first, or "
                "call the entry points with them")
        self.mesh = mesh
        self.launches: list = []
        self.comm = None
        if torch.device(mesh.devices[0]).type == "cuda":
            from ..ops._build import build

            build()
        # the ranks share this process's CPU threads
        threads = max(1, torch.get_num_threads() // mesh.size)
        self._dir = tempfile.mkdtemp(prefix="sampler_ranks_")
        path = os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        try:
            for r in range(1, mesh.size):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_rank_main,
                                args=(mesh, r, path, threads, child),
                                daemon=True)
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            self.comm = _join(mesh, 0, path)
            _open.append(self)
            self._collect("start")
        except BaseException:
            self._kill()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _replies(self, wait: float | None = None) -> list:
        """(kind, body) of each spawned rank's reply to the last message,
        waiting at most ``wait`` seconds in all when given (a rank that
        failed has sent its report before its exit failed rank 0)."""
        out = []
        end = None if wait is None else time.monotonic() + wait
        for conn in self._conns:
            try:
                if end is not None and not conn.poll(
                        max(0.0, end - time.monotonic())):
                    out.append(("silent", None))
                    continue
                out.append(conn.recv())
            except (EOFError, OSError):
                out.append(("error", "the process ended without a reply"))
        return out

    def _collect(self, what: str) -> list:
        """Each spawned rank's reply to the last message; raises with the
        tracebacks of the ranks that failed."""
        replies = self._replies()
        errors = [f"rank {r}:\n{body}" for r, (kind, body) in
                  enumerate(replies, start=1) if kind == "error"]
        if errors:
            self._kill()
            raise RuntimeError(f"{what} failed in {len(errors)} rank(s):\n"
                               + "\n".join(errors))
        return [body for _, body in replies]

    def run(self, fn, *args, rank0_kwargs=None):
        """``fn(comm, *args)`` in every rank (``fn`` importable by name,
        ``args`` picklable), with ``rank0_kwargs`` (callbacks, say) passed
        to rank 0 alone; returns rank 0's result."""
        if self.comm is None:
            raise RuntimeError("the ranks are closed")
        for conn in self._conns:
            conn.send((fn, args))
        before = kernel_launches()
        try:
            result = fn(self.comm, *args, **(rank0_kwargs or {}))
        except BaseException:
            # a rank that failed first ends its process, which fails rank
            # 0's collective: report that rank's traceback; the others may
            # be waiting for rank 0 in a collective, so all of them end
            errors = [f"rank {r}:\n{body}" for r, (kind, body) in
                      enumerate(self._replies(FAIL_WAIT_S), start=1)
                      if kind == "error"]
            self._kill()
            if errors:
                raise RuntimeError(
                    f"{len(errors)} rank(s) failed:\n" + "\n".join(errors))
            raise
        after = kernel_launches()
        others = self._collect(getattr(fn, "__name__", "the call"))
        self.launches = [{k: after[k] - before[k] for k in after}] + others
        return result

    def close(self) -> None:
        if self.comm is None:
            return
        for conn in self._conns:
            conn.send(None)
        for p in self._procs:
            p.join(JOIN_TIMEOUT_S)
        dist.destroy_process_group()
        self._kill()

    def _kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(JOIN_TIMEOUT_S)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        if dist.is_initialized():
            dist.destroy_process_group()
        if self in _open:
            _open.remove(self)
        self.comm = None
        shutil.rmtree(self._dir, ignore_errors=True)


def run(target, fn, *args, rank0_kwargs=None):
    """``fn(comm, *args)`` on every rank of ``target``: a ``Ranks`` (its
    processes), a ``Mesh`` (ranks started for this call), or, inside a
    process group the caller started, this process's own rank of the
    mesh.  Returns this process's rank's result (rank 0's when started
    here)."""
    if isinstance(target, Ranks):
        return target.run(fn, *args, rank0_kwargs=rank0_kwargs)
    if _open:
        raise RuntimeError(f"ranks of {_open[0].mesh} are open in this "
                           "process: pass them, or close them first")
    if dist.is_initialized():
        from .multihost import group_comm

        comm = group_comm(target)
        kwargs = (rank0_kwargs or {}) if comm.rank == 0 else {}
        return fn(comm, *args, **kwargs)
    with Ranks(target) as ranks:
        return ranks.run(fn, *args, rank0_kwargs=rank0_kwargs)
