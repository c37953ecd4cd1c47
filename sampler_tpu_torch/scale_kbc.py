"""Large single-card KBC scale point (counterpart of tools/scale_kbc.py).

The KBC inference cell (bench.py's bench_kbc) runs the 5e5-variable
class; this runner measures the same power-law workload at 4e6 variables
(8x) on one card, through the main path (``run_inference_mc``), and prints
one JSON line with the keys of the JAX package's KBC_SCALE.json, the
card, and the device memory.

Timing follows bench.py's protocol (bench.py imports JAX, so the port
keeps its own loop): WARM_SWEEPS warm-up sweeps (phase 15's burn-in),
then ``--outer`` timed ``run_inference_mc`` calls of ``--inner`` sweeps,
one synchronisation at the end; updates/s = variables x chains x inner x
outer / seconds.

Run:  python -m sampler_tpu_torch.scale_kbc [--vars 4000000]
          [--chains 1024] [--hub-cap 256] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

WARM_SWEEPS = 2


def main(argv=None, inspect=None) -> dict:
    """Run the scale point and print its record (returned too).
    ``inspect(d, info, values, generator)``, when given, is called
    after the timed runs, with the placed graph and the last worlds,
    before they are freed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--vars", type=int, default=4_000_000)
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--hub-cap", type=int, default=256)
    ap.add_argument("--inner", type=int, default=5,
                    help="sweeps a timed call")
    ap.add_argument("--outer", type=int, default=2, help="timed calls")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .benchgraphs import random_kbc_graph
    from .coloring import greedy_coloring, rcm_order
    from .compile import compile_graph, iter_arrays, resolve_device, \
        to_device
    from .engine.multichain import (init_values_mc, run_inference_mc,
                                    run_sweeps_mc)
    from .observe import card
    from .scale_gpu import device_memory

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    host = {}
    t0 = time.perf_counter()
    g = random_kbc_graph(args.vars, 3 * args.vars, max_arity=3,
                         n_weights=100_000, seed=0, skew=1.1, window=2000)
    host["generate_s"] = time.perf_counter() - t0
    t = time.perf_counter()
    colors = greedy_coloring(g)
    host["greedy_coloring_s"] = time.perf_counter() - t
    t = time.perf_counter()
    order = rcm_order(g)
    host["rcm_order_s"] = time.perf_counter() - t
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    dg, info = compile_graph(g, colors=colors, order=order,
                             band_wmax=32768, hub_cap=args.hub_cap)
    t_compile = time.perf_counter() - t0
    del g, colors, order
    gc.collect()
    graph_bytes = sum(int(a.nbytes) for _, a in iter_arrays(dg))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    d = to_device(dg, dev)
    del dg
    gc.collect()

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    vals = init_values_mc(d, gen, args.chains, info)
    vals = run_sweeps_mc(d, vals, d.w_init, gen, WARM_SWEEPS, False, info,
                         device=dev)
    sync()
    t_warm = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.outer):
        vals, counts = run_inference_mc(d, vals, d.w_init, gen, args.inner,
                                        False, info, device=dev)
    sync()
    t_run = time.perf_counter() - t0
    memory = device_memory(dev)

    tot = counts.view(info.max_card, -1).to(torch.int64).sum(dim=0)
    if not bool((tot == args.inner * args.chains).all()):
        raise RuntimeError("a position's counts do not sum to sweeps x "
                           "chains")
    if not bool(((vals == 0) | (vals == 1)).all()):
        raise RuntimeError("a non-boolean world")

    rate = info.n_vars * args.inner * args.outer * args.chains / t_run
    out = {
        "device": str(dev),
        "card": card(dev),
        "n_vars": info.n_vars, "n_factors": info.n_factors,
        "n_colors": info.n_colors, "n_tiers": len(info.tiers),
        "has_hub": info.has_hub, "hub_cap": args.hub_cap,
        "chains": args.chains, "sweeps": args.inner * args.outer,
        "gen_s": t_gen, "host_s": host, "compile_s": t_compile,
        "warm_s": t_warm, "run_s": t_run,
        "updates_per_s": rate,
        "vs_north_star": rate / 1e9,
        "graph_bytes": graph_bytes,
        "world_bytes": vals.numel() * vals.element_size(),
        "hbm": memory,
    }
    if inspect is not None:
        inspect(d, info, vals, gen)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
