"""Large single-card run (counterpart of sampler_tpu/scale_tpu.py): the
memory model and throughput of a ~2.6 x 10^7-variable Ising grid on one
card, past the 10^6-variable flagship.

Compiles the grid, drops the streams only learning reads, places the rest
of the device image on the card, runs ``run_inference_mc`` (the main path:
``fused_color_draw`` and ``tally_counts``), and prints one JSON line with
updates/s and the device memory picture.  At the defaults the worlds hold
5120 * 5120 * 128 = 3.4e9 int8 values, past 2^31.

Run:  python -m sampler_tpu_torch.scale_gpu [--rows 5120] [--cols 5120]
          [--chains 128] [--sweeps 4] [--outer 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np

# streams only the learning gradient reads (grad_pair_tile's moment rows
# and the records' ownership masks): an inference run leaves them on the
# host (about 3.4 GB at 2.6e7 variables)
GRADIENT_ONLY = ("gd_wid", "gd_cown", "gd_ctch", "gd_ao", "gd_an", "gd_ax",
                 "cs_gowner", "cs_gtouch")


def drop_gradient_streams(dg, info):
    """``dg`` (compile_graph's numpy graph) with GRADIENT_ONLY replaced by
    [C, 1, 1] placeholders of their dtypes, as scale_tpu.py does."""
    C = info.n_colors
    return dg._replace(tiers=tuple(
        ts._replace(**{f: np.zeros((C, 1, 1), getattr(ts, f).dtype)
                       for f in GRADIENT_ONLY})
        for ts in dg.tiers))


def device_memory(dev) -> dict | None:
    """Peak and free device memory of a run on the card (None on the
    CPU): torch.cuda.max_memory_allocated and torch.cuda.mem_get_info."""
    import torch

    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "mem_get_info_free": free, "mem_get_info_total": total}


def main(argv=None, inspect=None) -> dict:
    """Run the scale point and print its record (returned too).
    ``inspect(d, info, values, counts)``, when given, is called
    after the timed runs, with the placed graph, the last worlds and
    counts, before they are freed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=5120)
    ap.add_argument("--cols", type=int, default=5120)
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--sweeps", type=int, default=4)
    ap.add_argument("--outer", type=int, default=3,
                    help="timed chained run_inference_mc calls")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .benchgraphs import big_ising_grid
    from .compile import compile_graph, resolve_device, to_device
    from .engine.multichain import init_values_mc, run_inference_mc
    from .observe import card
    from .scale_demo import memory_budget

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    t0 = time.perf_counter()
    g, colors = big_ising_grid(args.rows, args.cols)
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    dg, info = compile_graph(g, colors=colors)
    t_compile = time.perf_counter() - t0
    budget = memory_budget(dg, info)
    del g, colors
    gc.collect()

    dg = drop_gradient_streams(dg, info)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    d = to_device(dg, dev)
    del dg
    gc.collect()

    gen = torch.Generator(device=dev).manual_seed(0)
    vals = init_values_mc(d, gen, args.chains, info)

    t0 = time.perf_counter()
    vals, counts = run_inference_mc(d, vals, d.w_init, gen, args.sweeps,
                                    False, info, device=dev)
    sync()
    t_warm = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.outer):
        vals, counts = run_inference_mc(d, vals, d.w_init, gen, args.sweeps,
                                        False, info, device=dev)
    sync()
    t_run = time.perf_counter() - t0
    memory = device_memory(dev)

    # every position tallied: counts are [K, P] int32, summed in int64
    tot = counts.view(info.max_card, -1).to(torch.int64).sum(dim=0)
    if not bool((tot == args.sweeps * args.chains).all()):
        raise RuntimeError("a position's counts do not sum to sweeps x "
                           "chains")

    updates = info.n_vars * args.sweeps * args.outer * args.chains
    out = {
        "device": str(dev),
        "card": card(dev),
        "n_vars": info.n_vars,
        "n_factors": info.n_factors,
        "chains": args.chains,
        "sweeps": args.sweeps * args.outer,
        "band_w": info.band_w,
        "gen_s": t_gen,
        "compile_s": t_compile,
        "warm_s": t_warm,
        "run_s": t_run,
        "updates_per_s": updates / t_run,
        "world_elements": vals.numel(),
        "memory": budget,
        "hbm": memory,
    }
    if inspect is not None:
        inspect(d, info, vals, counts)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
