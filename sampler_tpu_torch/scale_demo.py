"""KBC-scale demonstration: compile + run a 10^7-variable graph on a mesh of
graph ranks (counterpart of sampler_tpu/scale_demo.py).

Run:  python -m sampler_tpu_torch.scale_demo [--rows N] [--cols N]
          [--devices N] [--sweeps N] [--graph-axis N] [--device cuda|cpu]

Compiles a rows x cols Ising grid with the chunked color-major compiler
(``align=8*G, shards=G``), splits the streams over the ``graph`` axis of a
mesh of ranks (``parallel.graph_shard.infer_gs``; the halo exchange
engages where the read bounds allow), runs a few sweeps end to end, and
prints one JSON line with throughput and the memory budget, including the
extrapolation to 10^8 variables.

The ranks are processes (``parallel.launch``).  On the card, a mesh of
more ranks than cards puts several ranks on one card, over Gloo (NCCL
refuses two ranks on one card); ``--device cpu`` runs CPU ranks over Gloo.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np


# per-factor record fields replaced by 1-row placeholders before sharded
# placement (parallel/graph_shard._strip_factor_records) — excluded from the
# sharded-footprint figure so the budget matches what devices actually hold
_STRIPPED_FIELDS = frozenset({
    "f_vids", "f_ispos", "f_eqpred", "f_mask", "f_type", "f_wid", "f_feat",
    "f_arity", "f_cwbase", "f_cwstride", "pos_of_vid"})


def _nbytes(a) -> int:
    return int(a.nbytes) if isinstance(a, np.ndarray) \
        else int(a.numel() * a.element_size())


def memory_budget(dg, info) -> dict:
    """Per-field device-stream bytes + per-variable totals + 10^8 projection.

    Reports BOTH the full single-device image (what to_device places) and
    the graph-sharded footprint (factor records stripped).  ``dg`` holds
    numpy arrays (compile_graph's) or tensors (to_device's)."""
    from .compile import iter_arrays

    per_field = {n: _nbytes(a) for n, a in iter_arrays(dg)}
    total = sum(per_field.values())
    sharded = sum(b for n, b in per_field.items()
                  if n not in _STRIPPED_FIELDS)
    per_var = total / max(info.n_vars, 1)
    per_var_sh = sharded / max(info.n_vars, 1)
    top = dict(sorted(per_field.items(), key=lambda kv: -kv[1])[:6])
    return {
        "total_bytes": int(total),
        "bytes_per_var": round(per_var, 1),
        "sharded_bytes": int(sharded),
        "sharded_bytes_per_var": round(per_var_sh, 1),
        "top_fields": top,
        "projected_1e8_gb": round(per_var * 1e8 / 2**30, 1),
        "projected_1e8_sharded_gb": round(per_var_sh * 1e8 / 2**30, 1),
    }


def demo_mesh(device, n_ranks: int, n_graph: int):
    """The ``(n_ranks // n_graph) x n_graph`` mesh of ``device``'s kind:
    rank r on card r % (cards), over Gloo where cards are shared."""
    import torch

    from .compile import resolve_device
    from .parallel.comm import make_mesh

    dev = resolve_device(device)
    if n_ranks % n_graph:
        raise SystemExit(f"--graph-axis {n_graph} does not divide the "
                         f"{n_ranks} ranks")
    if dev.type != "cuda":
        return make_mesh(n_ranks // n_graph, n_graph, ["cpu"] * n_ranks)
    cards = torch.cuda.device_count()
    return make_mesh(n_ranks // n_graph, n_graph,
                     [f"cuda:{r % cards}" for r in range(n_ranks)],
                     "gloo" if n_ranks > cards else None)


def main(argv=None, mesh=None) -> dict:
    """Run the demonstration; ``mesh`` (a ``parallel.comm.Mesh`` or open
    ``parallel.launch.Ranks``) replaces the mesh the flags derive.
    Returns the printed record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=3200)
    ap.add_argument("--cols", type=int, default=3200)
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to use (0 = every card, or the graph axis "
                         "when it is larger: its ranks then share cards)")
    ap.add_argument("--graph-axis", type=int, default=0,
                    help="graph-axis size (0 = every rank on the graph axis)")
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--chains", type=int, default=2,
                    help="chains a rank")
    ap.add_argument("--band_wmax", type=int, default=8192,
                    help="max banded window width; raise for wide grids "
                         "(e.g. 16384 for 10^4 columns) so banding + halo "
                         "stay on at configs[4] scale")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .benchgraphs import big_ising_grid
    from .compile import compile_graph, resolve_device
    from .observe import card, marginal_entropy
    from .parallel.graph_shard import halo_plan, infer_gs

    dev = resolve_device(args.device)
    if mesh is None:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        n_ranks = args.devices or max(cards, args.graph_axis, 1)
        mesh = demo_mesh(dev, n_ranks, args.graph_axis or n_ranks)
    m = getattr(mesh, "mesh", mesh)
    n_graph, n_chains_ax = m.n_graph, m.n_chains

    t0 = time.perf_counter()
    g, colors = big_ising_grid(args.rows, args.cols)
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    dg, info = compile_graph(g, colors=colors, align=8 * n_graph,
                             band_wmax=args.band_wmax, shards=n_graph)
    t_compile = time.perf_counter() - t0
    budget = memory_budget(dg, info)
    del g, colors                    # free the host FactorGraph before
    gc.collect()                     # the ranks take their slices

    plan = halo_plan(dg, info, n_graph)
    t0 = time.perf_counter()
    marg = infer_gs(dg, dg.w_init, 0, 0, args.sweeps, info, mesh,
                    args.chains)
    t_run = time.perf_counter() - t0
    if marg.shape[0] != info.n_vars or not np.isfinite(marg).all():
        raise RuntimeError(f"marginals {marg.shape}, finite: "
                           f"{bool(np.isfinite(marg).all())}")

    updates = info.n_vars * args.sweeps * args.chains * n_chains_ax
    out = {
        "device": str(dev),
        "card": card(m.devices[0]),
        "n_vars": info.n_vars,
        "n_factors": info.n_factors,
        "gen_s": t_gen,
        "compile_s": t_compile,
        "run_s": t_run,
        "updates_per_s": updates / t_run,
        "mesh": {"chains": n_chains_ax, "graph": n_graph},
        "backend": m.backend,
        "halo": None if plan is None else list(plan),
        "band_w": info.band_w,
        "memory": budget,
        "marginals": {"shape": list(marg.shape),
                      "mean_p1": float(marg[:, 1].mean()),
                      "entropy": marginal_entropy(marg)},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
