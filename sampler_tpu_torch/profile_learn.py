"""Dissect the learning-vs-inference throughput gap (counterpart of
sampler_tpu/profile_learn.py).

Times, on the main path's kernels and the learning flagship graph (the
Ising grid with every other variable labelled), each component of a
learning epoch in isolation:

  * one prefolded world sweep (the fused path: ``fused_color_draw``),
  * the gradient pass alone (``mc_weight_gradient_cs``:
    ``grad_pair_tile``),
  * the fused-affine fold (the per-epoch weights refresh) alone,

and prints a JSON breakdown with the implied epoch budget, so "learning is
slower" becomes "X% sweeps, Y% gradient, Z% fold".  On the card each time
is the median of a few runs of host clock around work that ends in
``torch.cuda.synchronize``.

Run:  python -m sampler_tpu_torch.profile_learn [--grid 1024]
          [--chains 256] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def timeit(fn, sync, reps: int = 3, inner: int = 1) -> float:
    """Median seconds of one ``fn()`` over ``reps`` runs of ``inner``
    calls, each run ending in ``sync()``, after one warm-up call."""
    fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        sync()
        ts.append((time.perf_counter() - t0) / inner)
    return float(np.median(ts))


def main(argv=None) -> dict:
    """Print the breakdown (returned too)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--sweeps_per_epoch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .benchgraphs import big_ising_grid
    from .compile import compile_graph, resolve_device, to_device
    from .engine.multichain import (init_values_mc, mc_weight_gradient_cs,
                                    prepare_fold, resolve_modes, sweep_mc)
    from .observe import card

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    g, colors = big_ising_grid(args.grid, args.grid)
    g.var_role[::2] = 1
    g.var_init[::2] = (np.arange((g.n_vars + 1) // 2) % 2).astype(np.int32)
    dg, info = compile_graph(g, colors=colors)
    d = to_device(dg, dev)
    del dg
    modes = resolve_modes(info, dev)
    NC = args.chains
    gen = torch.Generator(device=dev).manual_seed(0)
    v_ev = init_values_mc(d, gen, NC, info)
    v_free = init_values_mc(d, gen, NC, info)
    w = d.w_init
    folded = prepare_fold(d, w, info, modes)

    t_sweep = timeit(lambda: sweep_mc(d, v_ev, w, gen, False, info, folded,
                                      modes), sync, inner=4)
    t_fold = timeit(lambda: prepare_fold(d, w, info, modes), sync, inner=4)
    t_grad = timeit(lambda: mc_weight_gradient_cs(d, v_ev, v_free, False,
                                                  info, modes), sync, inner=2)

    V = info.n_vars
    s = args.sweeps_per_epoch
    epoch = 2 * s * t_sweep + t_grad + t_fold
    upd = 2 * s * V * NC
    out = {
        "device": str(dev), "card": card(dev),
        "grid": args.grid, "chains": NC, "modes": list(modes),
        "sweep_s": t_sweep,
        "fold_s": t_fold,
        "grad_s": t_grad,
        "epoch_budget_s": epoch,
        "epoch_pct": {
            "world_sweeps": 100 * 2 * s * t_sweep / epoch,
            "gradient": 100 * t_grad / epoch,
            "fold": 100 * t_fold / epoch,
        },
        "inference_updates_per_s": V * NC / t_sweep,
        "implied_learning_updates_per_s": upd / epoch,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
