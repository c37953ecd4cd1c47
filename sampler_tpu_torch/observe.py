"""Observability: spans of the program's host time on the profiler's clock,
and throughput/convergence stats (counterpart of sampler_tpu/observe.py).

Spans.  ``span(name)`` marks a stretch of host time: an engine phase, a
kernel wrapper's call, a plan build, a compile step.  The profiler is its
only switch.  While no torch profiler records, a span reads the
profiler's enabled flag and returns a shared no-op: no clock read, no
record function, no allocation.  While one records (``dw gibbs
--profile``, the benchmark's traced stretch, a test's profiler), a span
enters a record function, so it lands in the trace as a host event
(``cpu_op``), and appends a ``Record`` to an in-memory list, stamped on
the clock the profiler writes (a chrome trace's ``ts`` x 1000 +
``baseTimeNanoseconds`` is ``time.time_ns()``), so a record lies beside
the device events of the same trace with no offset.  A span opened with
no span open is a root: it opens a request, whose id every record under
it carries.  ``spans()`` returns the records, ``span_table`` sums them
by name.  The records are the process's, and their nesting is that of one
thread's calls: the engine's, which runs on one thread.

The statistics take numpy arrays or torch tensors (on any device).
"""
from __future__ import annotations

import functools
import subprocess
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

try:
    _record_function = torch._C._profiler._RecordFunctionFast
except AttributeError:                                  # pragma: no cover
    _record_function = torch.profiler.record_function


class Record(NamedTuple):
    """One span: its name, start and end in ns of ``time.time_ns()``
    (``end_ns`` None while it is open), the index in ``spans()`` of the
    span around it (-1 at a root) and its request's id."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    request: int


# the records, a column each, so a span adds no object the cycle
# collector tracks: names, start and end ns, the enclosing record's index,
# the request's id
_names: list = []
_starts: list = []
_ends: list = []
_parents: list = []
_requests: list = []
_open = -1              # index of the innermost open span, -1 at none
_last_request = 0
_now = time.time_ns


class _Off:
    """The span of a process no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "index", "rf", "outer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _open, _last_request
        outer = self.outer = _open
        if outer < 0:
            _last_request += 1
        _open = self.index = len(_names)
        _names.append(self.name)
        _parents.append(outer)
        _requests.append(_last_request)
        _ends.append(None)
        _starts.append(_now())
        rf = self.rf = _record_function(self.name)
        rf.__enter__()
        return None

    def __exit__(self, *exc):
        global _open
        _ends[self.index] = _now()
        self.rf.__exit__(*exc)
        _open = self.outer
        return False


def span(name: str):
    """A context manager marking ``name``'s host time while a torch
    profiler records, and a shared no-op while none does."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str, card: bool = False):
    """Decorate a function so each call runs inside ``span(name)``; while
    no profiler records, a call costs one read of the enabled flag.  With
    ``card`` only a call whose first argument is a CUDA tensor opens the
    span: a kernel wrapper's card path, not its plain version."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled or (
                    card and args[0].device.type != "cuda"):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list:
    """The records since the process started or ``clear_spans()``, in the
    order the spans opened (a parent before its children)."""
    return [Record(*r) for r in zip(_names, _starts, _ends, _parents,
                                    _requests)]


def clear_spans() -> None:
    """Drop the records; raises inside an open span."""
    if _open >= 0:
        raise RuntimeError("clear_spans inside an open span")
    for col in (_names, _starts, _ends, _parents, _requests):
        col.clear()


def self_ns(records) -> list:
    """Each record's self time in ns: its span less the union of its
    children's spans (clipped to it); None for an open record."""
    kids = [[] for _ in records]
    for i, r in enumerate(records):
        if r.parent >= 0:
            kids[r.parent].append(i)
    out = []
    for r, ks in zip(records, kids):
        if r.end_ns is None:
            out.append(None)
            continue
        covered, t = 0, r.start_ns
        for a, b in sorted((records[k].start_ns, records[k].end_ns)
                           for k in ks if records[k].end_ns is not None):
            a, b = max(a, t), min(b, r.end_ns)
            if b > a:
                covered += b - a
                t = b
        out.append(r.end_ns - r.start_ns - covered)
    return out


def span_table(records) -> Dict[str, tuple]:
    """{name: (count, inclusive seconds, self seconds)} of the closed
    records, the most self time first."""
    table = {}
    for r, s in zip(records, self_ns(records)):
        if s is None:
            continue
        n, inc, own = table.get(r.name, (0, 0.0, 0.0))
        table[r.name] = (n + 1, inc + (r.end_ns - r.start_ns) * 1e-9,
                         own + s * 1e-9)
    return dict(sorted(table.items(), key=lambda kv: -kv[1][2]))


def span_line(records, top: int = 12) -> str:
    """The ``top`` names with the most self time, one line: name count
    inclusive-s self-s."""
    rows = list(span_table(records).items())[:top]
    return "; ".join(f"{k} {n} {inc:.6f} {own:.6f}"
                     for k, (n, inc, own) in rows)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def throughput(n_vars: int, n_sweeps: int, n_chains: int,
               seconds: float) -> float:
    """Variable updates/s — the [B] headline metric."""
    return n_vars * n_sweeps * n_chains / max(seconds, 1e-12)


def weight_stats(weights) -> Dict[str, float]:
    w = _f64(weights)
    return {
        "w_l2": float(np.linalg.norm(w)),
        "w_max": float(np.abs(w).max()) if w.size else 0.0,
        "w_mean": float(w.mean()) if w.size else 0.0,
    }


def marginal_entropy(marginals) -> float:
    """Mean per-variable entropy of the estimated marginals — a cheap
    convergence/mixing indicator."""
    m = np.clip(_f64(marginals), 1e-12, 1.0)
    ent = -(m * np.log(m)).sum(axis=-1)
    return float(ent.mean())


def card(device) -> Optional[str]:
    """The card a run measured on, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives it (a card may be set below
    its maximum power and then runs slower), or None for a CPU run."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
    return out.splitlines()[0] if out else None
