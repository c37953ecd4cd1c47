"""The work a kernel's call needs, counted from the graph and the cell's
shapes alone, and its share of the card's roofline.

The counts never look at how the program lays its data out: no streams,
tiers, padding, plans or instruction counts.  Each input byte is read once
and each output byte written once:

  * a world value is one byte (a boolean in the int8 worlds the port
    keeps); a world row is a variable's values in every chain;
  * a factor incidence is 9 bytes: a variable id (4), a weight id (4), a
    sign or type (1); a weight or a gradient entry is 4 bytes (float32);
  * a count is 4 bytes, read and written once.

Operations, per chain:

  * float32: one add a (variable, factor) pair of a draw (the weight
    into the variable's log-odds), two a drawn (variable, chain) (its
    probability against a uniform); one add a factor of the gradient;
  * int32, at four int8 chains an operation (the byte worlds' packing):
    two a member of each (variable, factor) pair of a draw (its literal
    under both values and the factor's combine), two a member of a factor
    of the gradient in each world; two a (variable, chain) of a tally.

The bound is the largest of bytes / HBM rate, float32 ops / float32 rate
and int32 ops / the derived int32 rate (``trace.PEAKS``); the share is the
bound over the kernel's measured time.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .trace import PEAKS

HERE = os.path.dirname(os.path.abspath(__file__))
INC_BYTES, W_BYTES, COUNT_BYTES = 9, 4, 4
SWAR = 4


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    f32: float = 0.0
    i32: float = 0.0

    def __add__(self, o):
        return Work(self.bytes + o.bytes, self.f32 + o.f32, self.i32 + o.i32)

    def __mul__(self, k: float):
        return Work(self.bytes * k, self.f32 * k, self.i32 * k)

    def bound(self) -> tuple:
        """(seconds, the term that binds)."""
        terms = dict(bytes=self.bytes / PEAKS["hbm_bytes_per_s"],
                     f32=self.f32 / PEAKS["f32_ops_per_s"],
                     i32=self.i32 / PEAKS["int32_ops_per_s"])
        k = max(terms, key=terms.get)
        return terms[k], k


def _edges(g: dict) -> tuple:
    arity = np.diff(np.asarray(g["f_ptr"], np.int64))
    fac = np.repeat(np.arange(len(arity)), arity)
    return arity, fac, np.asarray(g["e_vid"], np.int64)


def draw_sweep(g: dict, NC: int, drawn: np.ndarray) -> Work:
    """One sweep drawing the variables ``drawn`` (bool [V])."""
    arity, fac, vid = _edges(g)
    own = drawn[vid]                      # an edge of a drawn variable
    pairs = np.unique(fac[own] * len(drawn) + vid[own])
    pf = pairs // len(drawn)              # the factor of each pair
    visited = np.zeros(len(arity), bool)
    visited[pf] = True
    rows = np.unique(vid[visited[fac]])   # world rows the draws read
    n_drawn = int(drawn.sum())
    members = float(arity[pf].sum())      # members of every pair's factor
    return Work(
        bytes=NC * (len(rows) + n_drawn) + INC_BYTES * float(
            arity[visited].sum()) + W_BYTES * len(np.unique(
                np.asarray(g["f_wid"])[visited])),
        f32=NC * (len(pairs) + 2.0 * n_drawn),
        i32=NC * 2.0 * members / SWAR)


def tally_sweep(g: dict, NC: int, K: int = 2) -> Work:
    """One sweep's tally of every variable's K values over the chains."""
    V = len(g["var_card"])
    return Work(bytes=NC * V + 2 * COUNT_BYTES * K * V,
                i32=2.0 * NC * V / SWAR)


def gradient(g: dict, NC: int) -> Work:
    """One gradient of an evidence and a free world over the factors with
    an evidence member (DeepDive's default)."""
    arity, fac, vid = _edges(g)
    ev_edge = np.asarray(g["var_role"])[vid] == 1
    kept = np.zeros(len(arity), bool)
    kept[fac[ev_edge]] = True
    rows = np.unique(vid[kept[fac]])
    n_inc = float(arity[kept].sum())
    return Work(bytes=2 * NC * len(rows) + INC_BYTES * n_inc
                + W_BYTES * len(g["w_init"]),
                f32=NC * float(kept.sum()),
                i32=2 * 2.0 * NC * n_inc / SWAR)


def kernel_names(kernel: str) -> list:
    """Device-name patterns of a port kernel (``kernels/<kernel>.json``)."""
    with open(os.path.join(HERE, "kernels", kernel + ".json")) as f:
        return json.load(f)["device_names"]


def share(ctx: dict, kernel: str, work: Work) -> float | None:
    """Percent of ``kernel``'s time in the traced stretch that ``work``
    (all of the stretch's) needs at the roofline; None when the kernel did
    not run there."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(kernel_names(kernel))
    if not launches or seconds <= 0:
        return None
    bound, term = work.bound()
    ctx.setdefault("notes", []).append(dict(
        roofline=kernel, bound_s=bound, binds=term, kernel_s=seconds,
        launches=launches, bytes=work.bytes, f32_ops=work.f32,
        i32_ops=work.i32))
    return 100.0 * bound / seconds


def drawn_sets(ctx: dict) -> list:
    """(sweeps, drawn mask) of the traced stretch: inference draws the
    query variables; learning's evidence world the query variables and
    its free world every variable, a sweep each per epoch sweep."""
    g = ctx["setup"].graph
    query = np.asarray(g["var_role"]) != 1
    tr, job = ctx["trace"], ctx["job"]
    if job.kind == "infer":
        return [(tr.jobs * job.sweeps(), query)]
    n = tr.jobs * job.sweeps()
    return [(n, query), (n, np.ones_like(query))]


def draw_share(ctx: dict, kernel: str) -> float | None:
    if ctx.get("trace") is None:
        return None
    g, NC = ctx["setup"].graph, ctx["setup"].n_chains
    work = Work()
    for n, drawn in drawn_sets(ctx):
        work = work + draw_sweep(g, NC, drawn) * n
    return share(ctx, kernel, work)


def tally_share(ctx: dict, kernel: str) -> float | None:
    tr, job = ctx.get("trace"), ctx["job"]
    if tr is None or job.kind != "infer":
        return None
    s = ctx["setup"]
    return share(ctx, kernel, tally_sweep(s.graph, s.n_chains)
                 * (tr.jobs * job.n_sweeps))


def gradient_share(ctx: dict, kernel: str) -> float | None:
    tr, job = ctx.get("trace"), ctx["job"]
    if tr is None or job.kind != "learn":
        return None
    s = ctx["setup"]
    return share(ctx, kernel, gradient(s.graph, s.n_chains)
                 * (tr.jobs * job.cfg.n_epochs))
