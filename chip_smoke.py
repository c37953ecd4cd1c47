#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sampler_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one line with its result and elapsed seconds):
  0 device   the card (nvidia-smi name and power limit), torch and CUDA;
             exits nonzero when no CUDA device is present
  1 build    nvcc builds every kernel in sampler_tpu_torch/csrc into
             sampler_tpu_torch/_build/ (ptxas register/shared-memory lines)
  2 kernels  each kernel against its plain PyTorch version at the flagship
             shapes (1024x1024 Ising grid, 512 chains, random worlds)
  3 oracle   infer_mc on an evidence-clamped 16x16 grid, fused and unfused,
             against exact enumeration (|dp| < 0.01)
  4 flagship infer_mc on the 1024x1024 grid with 512 chains, fused (the main
             path) and unfused; kernel times, bounds, rates, peak memory,
             and where a fused sweep's time goes
  5 grad     the learning flagship (the 1024x1024 grid, every other
             variable labelled evidence, 256 chains a world): grad_pair_tile
             against its plain version, and the whole kernel-route gradient
             against the chunked route (banded_gather) and the per-factor
             gradient; kernel time and bound
  6 learn    learn_mc on the learning flagship (10 epochs of 2 sweeps, the
             main learning path): launches, rate, peak memory and where an
             epoch's time goes; then the kernel and chunked gradient routes
             learn the same weights on a 16x16 grid, and a labelled coin
             reaches its log-odds
Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}.  Any failed check ends the run nonzero.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12      # H100 SXM int8 tensor cores, dense
GRID = 1024
CHAINS = 512
BURN, SWEEPS = 3, 20
LEARN_CHAINS = 256            # chains a world (bench.py's learning default)
LEARN_EPOCHS, LEARN_SWEEPS = 10, 2
GRAD_RTOL = 1e-5              # relative to the largest |value| compared


def require(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def report(name: str, t0: float, **fields) -> None:
    import torch

    torch.cuda.synchronize()
    fields["seconds"] = round(time.perf_counter() - t0, 3)
    print(f"[{name}] {json.dumps(fields)}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rows_read(nbr, starts, W: int) -> int:
    """Distinct in-window values rows the gather needs (this run's data)."""
    import torch

    local = nbr - starts.reshape(-1, *([1] * (nbr.dim() - 1)))
    inside = (local >= 0) & (local < W)
    return int(torch.unique(nbr[inside]).numel())


def labelled_flagship(grid: int):
    """bench.py's learning graph: the grid with every other variable
    evidence, labelled ``arange % card``."""
    import numpy as np

    from sampler_tpu_torch.benchgraphs import big_ising_grid

    g, colors = big_ising_grid(grid, grid)
    g.var_role[::2] = 1
    g.var_init[::2] = (np.arange((g.n_vars + 1) // 2)
                       % np.asarray(g.var_card)[::2]).astype(np.int32)
    return g, colors


def grad_phase(dev) -> tuple:
    """Phase 5.  Returns (graph, device graph, info, kernel numbers)."""
    import torch

    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import (
        _grad_row_chunk, _mc_weight_gradient_factors, init_values_mc,
        mc_weight_gradient_cs)
    from sampler_tpu_torch.ops.banded import banded_gather
    from sampler_tpu_torch.ops.grad import (GRAD_W_MAX, grad_pair_tile,
                                            grad_pair_tile_plain)

    t5 = time.perf_counter()
    chains = LEARN_CHAINS
    g, colors = labelled_flagship(GRID)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors)
    compile_s = time.perf_counter() - tc
    ti = info.tiers[0]
    W = dg.w_init.shape[0]
    require(len(info.tiers) == 1 and ti.affine2 and ti.band_k == 1
            and W <= GRAD_W_MAX, f"learning flagship tiers {info.tiers}")
    d = to_device(dg, dev)
    del dg
    ts = d.tiers[0]
    C, gB, D, TB, Wb = (info.n_colors, info.block_size, ti.degree,
                        ti.band_tb, ti.band_w)
    nt = ti.block // TB
    gen = torch.Generator(device=dev).manual_seed(11)
    v_ev = init_values_mc(d, gen, chains, info)
    v_free = torch.randint(0, 2, v_ev.shape, generator=gen, device=dev,
                           dtype=torch.int8)

    def args(c, coef):
        return (v_ev, v_free, ts.bd_nbr, ts.bd_start[c], ts.gd_wid, coef,
                ts.gd_ao, ts.gd_an, ts.gd_ax, c, c * gB + ti.off, Wb, TB, D,
                W)

    err, rel = 0.0, 0.0
    for c in range(C):
        for coef in (ts.gd_ctch, ts.gd_cown):
            got = grad_pair_tile(*args(c, coef))
            ref = grad_pair_tile_plain(*args(c, coef))
            e, scale = float((got - ref).abs().max()), float(ref.abs().max())
            require(scale > 0, f"color {c}: all partials are 0")
            require(e <= GRAD_RTOL * scale,
                    f"grad_pair_tile color {c}: |err| {e} of {scale}")
            err, rel = max(err, e), max(rel, e / scale)
            del got, ref
    row_chunk = _grad_row_chunk(ti, ti.block, D, ti.arity, 2 * chains)
    routes = {}
    for lne in (False, True):
        banded_gather.launches = 0
        chunked = mc_weight_gradient_cs(d, v_ev, v_free, lne, info,
                                        ("cuda", "cuda"),
                                        row_chunk=row_chunk)
        gathers = banded_gather.launches
        require(gathers == C * (ti.block // row_chunk),
                f"chunked route: {gathers} banded_gather launches")
        kernel = mc_weight_gradient_cs(d, v_ev, v_free, lne, info,
                                       ("cuda", "cuda"))
        factors = _mc_weight_gradient_factors(d, v_ev, v_free, lne, info)
        scale = float(factors.abs().max())
        diffs = {name: float((kernel - ref).abs().max())
                 for name, ref in (("chunked", chunked),
                                   ("factors", factors))}
        for name, e in diffs.items():
            require(e <= GRAD_RTOL * scale,
                    f"lne={lne}: kernel route vs {name}: {e} of {scale}")
        routes[f"learn_non_evidence={lne}"] = dict(
            grad=kernel.tolist(), max_abs_diff=diffs, scale=scale,
            chunked_banded_gather_launches=gathers)
        del chunked, kernel, factors

    k = dict(ms=time_ms(lambda: grad_pair_tile(*args(0, ts.gd_ctch)),
                        iters=20),
             plain_ms=time_ms(lambda: grad_pair_tile_plain(
                 *args(0, ts.gd_ctch)), iters=3, warmup=1),
             library_ms=None, max_abs_err=err)
    # bound of one launch: own rows and the in-window neighbour rows of
    # both worlds, six 4-byte record streams, starts and the partials; the
    # moments are int8 dot products (So: an add a byte of an own row; Sn
    # and Sx: an add and a multiply-add a byte of an in-window neighbour
    # row), and about 8 f32 operations a record
    nbr0 = ts.bd_nbr[0, :nt].reshape(nt, D, TB)
    local = nbr0 - ts.bd_start[0].reshape(nt, 1, 1)
    n_in = int(((local >= 0) & (local < Wb)).sum())
    nbytes = (2 * chains * (nt * TB + rows_read(nbr0, ts.bd_start[0], Wb))
              + 6 * 4 * nt * D * TB + 4 * nt + 4 * nt * W)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * chains * (nt * TB + 3 * n_in) / INT8_OPS_PER_S
             + 8 * nt * D * TB / F32_OPS_PER_S) * 1e3
    k.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes=nbytes, bound_ops_ms=t_ops)
    del v_ev, v_free
    report("5 grad", t5, compile_graph_s=round(compile_s, 3),
           P=d.var_card.shape[0], ntiles=nt, TB=TB, D=D, W_window=Wb,
           n_weights=W, NC=chains, records_in_window=n_in,
           partials_max_abs_err=err, partials_max_rel_err=rel,
           row_chunk=row_chunk, routes=routes, kernel=k)
    return g, d, info, k


def learn_phase(dev, g, d, info) -> dict:
    """Phase 6.  Returns the launches of the learning flagship's run."""
    import dataclasses

    import numpy as np
    import torch

    from sampler_tpu_torch import fixtures
    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.benchgraphs import big_ising_grid
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.learn import LearnConfig, apply_update
    from sampler_tpu_torch.engine.multichain import (
        init_values_mc, learn_mc, mc_weight_gradient, prepare_fold,
        sweep_mc)
    from sampler_tpu_torch.ops.banded import banded_gather
    from sampler_tpu_torch.ops.fused import fused_color_draw
    from sampler_tpu_torch.ops.grad import grad_pair_tile

    t6 = time.perf_counter()
    chains = LEARN_CHAINS
    cfg = LearnConfig(n_epochs=LEARN_EPOCHS, n_sweeps_per_epoch=LEARN_SWEEPS,
                      stepsize=0.01, diminish=0.99, regularization="l2",
                      reg_param=0.01)
    modes = ("cuda", "cuda")
    C = info.n_colors
    counters = (grad_pair_tile, fused_color_draw, banded_gather)
    # one epoch first, so the counted run starts warm
    learn_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(1),
             dataclasses.replace(cfg, n_epochs=1), info, chains, modes,
             device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    tr = time.perf_counter()
    w, v_ev, v_free = learn_mc(d, d.w_init,
                               torch.Generator(device=dev).manual_seed(2),
                               cfg, info, chains, modes, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tr
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    require(launches["grad_pair_tile"] == C * cfg.n_epochs,
            f"learning: grad_pair_tile launches {launches}")
    require(launches["fused_color_draw"]
            == 2 * C * cfg.n_epochs * cfg.n_sweeps_per_epoch,
            f"learning: fused_color_draw launches {launches}")
    nw = g.n_weights
    require(bool(torch.isfinite(w).all()), f"weights {w.tolist()}")
    require(bool((w[:nw] != d.w_init[:nw]).all()),
            f"weights did not move: {w.tolist()}")
    require(bool(((v_ev == 0) | (v_ev == 1)).all()
                 and ((v_free == 0) | (v_free == 1)).all()),
            "non-boolean world")
    ev = (d.var_role == fs.ROLE_EVIDENCE) & (d.var_card > 1)
    require(bool((v_ev[ev] == d.var_init.to(torch.int8)[ev, None]).all()),
            "the evidence world lost a label")
    sweeps = cfg.n_epochs * cfg.n_sweeps_per_epoch
    tensors = [getattr(d, f) for f in d._fields if f != "tiers"]
    tensors += [x for ts in d.tiers for x in ts]
    graph_bytes = sum(t.numel() * t.element_size() for t in tensors
                      if isinstance(t, torch.Tensor))
    run = dict(wall_s=wall, learning_sweeps_per_s=sweeps / wall,
               learning_updates_per_s=g.n_vars * sweeps * 2 * chains / wall,
               peak_memory_bytes=peak, device_graph_bytes=graph_bytes,
               world_bytes=v_ev.numel(), launches=launches,
               weights=w.tolist(), w_init=d.w_init.tolist())

    # where an epoch's time goes: the epoch body of _learn_mc_from, with
    # CUDA events between its parts
    gen = torch.Generator(device=dev).manual_seed(3)
    parts = dict(fold=0.0, sweeps=0.0, gradient=0.0, update=0.0)
    reps = 3
    for _ in range(reps):
        ev_t = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev_t[0].record()
        folded = prepare_fold(d, w, info, modes)
        ev_t[1].record()
        for _ in range(cfg.n_sweeps_per_epoch):
            sweep_mc(d, v_ev, w, gen, False, info, folded, modes)
            sweep_mc(d, v_free, w, gen, True, info, folded, modes)
        ev_t[2].record()
        grad = mc_weight_gradient(d, v_ev, v_free, False, info, modes)
        ev_t[3].record()
        apply_update(w, grad, d.w_fixed, cfg.stepsize, cfg.regularization,
                     cfg.reg_param)
        ev_t[4].record()
        ev_t[4].synchronize()
        for i, name in enumerate(parts):
            parts[name] += ev_t[i].elapsed_time(ev_t[i + 1]) / reps
    run["epoch_breakdown_ms"] = dict(parts, epoch=sum(parts.values()))
    del v_ev, v_free

    # the kernel route and the chunked index_select route learn the same
    # weights from the same draws (tests/test_grad_kernel.py's grid)
    gs, colors_s = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    rng = np.random.default_rng(7)
    gs.var_role[:] = rng.random(gs.n_vars) < 0.5
    gs.var_init[:] = rng.integers(0, 2, gs.n_vars)
    dgs, infos = compile_graph(gs, colors=colors_s, band_tile=8,
                               band_min_block=1)
    ds = to_device(dgs, dev)
    cfg_s = LearnConfig(n_epochs=10, n_sweeps_per_epoch=2, stepsize=0.05,
                        diminish=0.98, regularization="l2", reg_param=0.01)
    small = {}
    for label, m in (("kernel", ("cuda", "cuda")),
                     ("chunked", ("off", "cuda"))):
        grad_pair_tile.launches = 0
        ws, _, _ = learn_mc(ds, ds.w_init,
                            torch.Generator(device=dev).manual_seed(1),
                            cfg_s, infos, 4, m, device=dev)
        small[label] = (ws, grad_pair_tile.launches)
    require(small["kernel"][1] == infos.n_colors * cfg_s.n_epochs
            and small["chunked"][1] == 0,
            f"16x16 routes: grad_pair_tile launches "
            f"{small['kernel'][1]}, {small['chunked'][1]}")
    dw = float((small["kernel"][0] - small["chunked"][0]).abs().max())
    require(dw <= 1e-4, f"16x16: kernel and chunked routes differ by {dw}")

    gc = fixtures.labeled_coin_graph(n_flips=400, p_heads=0.75, seed=2)
    p_hat = gc.var_init.mean()
    w_star = float(np.log(p_hat / (1 - p_hat)))
    dgc, infoc = compile_graph(gc)
    dc = to_device(dgc, dev)
    wc, _, _ = learn_mc(dc, dc.w_init, torch.Generator(device=dev)
                        .manual_seed(0),
                        LearnConfig(n_epochs=300, stepsize=0.03,
                                    diminish=0.995, regularization="none"),
                        infoc, 8, device=dev)
    coin_err = abs(float(wc[0]) - w_star)
    require(coin_err < 0.12, f"coin: learned {float(wc[0])}, want {w_star}")
    report("6 learn", t6, chains=chains, epochs=cfg.n_epochs,
           sweeps_per_epoch=cfg.n_sweeps_per_epoch, run=run,
           grid16_kernel_vs_chunked_max_abs_dw=dw,
           grid16_weights=small["kernel"][0].tolist(),
           coin_learned=float(wc[0]), coin_log_odds=w_star,
           coin_abs_err=coin_err)
    return launches


def main() -> int:
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    report("0 device", t0, card=card, torch=torch.__version__,
           cuda=torch.version.cuda, device_name=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count())

    from sampler_tpu_torch import oracle
    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.benchgraphs import big_ising_grid
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import (infer_mc,
                                                     init_values_mc,
                                                     prepare_fold,
                                                     resolve_modes, sweep_mc)
    from sampler_tpu_torch.ops import _build
    from sampler_tpu_torch.ops.banded import (banded_gather,
                                              banded_gather_plain)
    from sampler_tpu_torch.ops.fused import (fold_affine, fused_color_draw,
                                             fused_color_draw_plain,
                                             hash_bits, tile_seed, u32,
                                             uniform24)

    # ---- 1: build ---------------------------------------------------------
    t1 = time.perf_counter()
    _, build_s, ptxas = _build.build()
    for line in ptxas:
        print(f"  {line}", flush=True)
    report("1 build", t1, nvcc_seconds=round(build_s, 3),
           library=_build.library_path(), ptxas_lines=len(ptxas))

    # ---- 2: kernels against their plain versions, flagship shapes ---------
    t2 = time.perf_counter()
    g, colors = big_ising_grid(GRID, GRID)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors)
    compile_s = time.perf_counter() - tc
    ti = info.tiers[0]
    require(len(info.tiers) == 1 and ti.affine2 and ti.band_k == 1,
            f"flagship tiers {info.tiers}")
    d = to_device(dg, dev)
    ts = d.tiers[0]
    C, B, D, TB, W = info.n_colors, ti.block, ti.degree, ti.band_tb, ti.band_w
    A1 = ti.arity - 1
    nt = B // TB
    P = d.var_card.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    values = torch.randint(0, 2, (P, CHAINS), generator=gen, device=dev,
                           dtype=torch.int8)
    beta, base = fold_affine(ts, ti, C, d.w_init)

    gather_in = []
    for c in range(C):
        nbr = ts.cs_nbr[c * B * D * A1:(c + 1) * B * D * A1].view(
            nt, TB * D * A1)
        starts = ts.bd_start[c]
        # the planner's own starts, then the same tiles with every start
        # moved off the 256 grid and clipped to P - W
        shifted = torch.clamp(starts + 100, max=P - W)
        for st in (starts, shifted):
            out = banded_gather(values, nbr, st, W)
            require(torch.equal(out, banded_gather_plain(values, nbr, st, W)),
                    f"banded_gather differs from its plain version (c={c})")
        gather_in.append((nbr, starts, shifted))
    unaligned = sum(int((s % 256 != 0).sum()) for _, s, _ in gather_in)
    clipped = sum(int((s == P - W).sum()) for _, _, s in gather_in)

    seed = torch.tensor([12345, -67890], dtype=torch.int32, device=dev)
    fused_err, n_diff, n_draws = 0.0, 0, 0
    for c in range(C):
        args = (values, ts.bd_nbr, ts.bd_start[c], beta, base, c, seed, W,
                TB, D)
        out, delta = fused_color_draw(*args, return_delta=True)
        ref, ref_delta = fused_color_draw_plain(*args, return_delta=True)
        fused_err = max(fused_err, float((delta - ref_delta).abs().max()))
        diff = out != ref
        n_diff += int(diff.sum())
        n_draws += diff.numel()
        if bool(diff.any()):
            rows, chains = diff.nonzero(as_tuple=True)
            t = rows // TB
            u = uniform24(hash_bits((rows % TB) * CHAINS + chains,
                                    u32(seed[0]), tile_seed(seed[1], t)))
            gap = float((u - torch.sigmoid(delta[diff])).abs().max())
            require(gap < 1e-5, f"a differing draw has |u - p| = {gap}")
        del out, delta, ref, ref_delta, diff
    require(fused_err < 1e-5, f"fused delta error {fused_err}")
    require(n_diff <= 1e-4 * n_draws, f"{n_diff} of {n_draws} draws differ")
    report("2 kernels", t2, compile_graph_s=round(compile_s, 3), P=P,
           ntiles=nt, TB=TB, D=D, W=W, NC=CHAINS, R=TB * D * A1,
           banded_gather="exact", starts_unaligned=unaligned,
           starts_clipped_to_P_minus_W=clipped,
           fused_delta_max_abs_err=fused_err, fused_draws_differing=n_diff,
           fused_draws=n_draws)

    # ---- 3: oracle parity on the card --------------------------------------
    t3 = time.perf_counter()
    gs, colors_s = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    rng_q = torch.Generator().manual_seed(1)
    query = torch.randperm(gs.n_vars, generator=rng_q)[:12].numpy()
    gs.var_role[:] = fs.ROLE_EVIDENCE
    gs.var_role[query] = fs.ROLE_QUERY
    gs.var_init[:] = torch.randint(0, 2, (gs.n_vars,),
                                   generator=rng_q).numpy()
    dgs, infos = compile_graph(gs, colors=colors_s, band_tile=8,
                               band_min_block=1)
    require(infos.affine2, "small grid must take the fused path")
    exact = oracle.exact_marginals(gs, clamp_evidence=True)
    ds = to_device(dgs, dev)
    errs = {}
    for label, modes, counter in (("fused", ("cuda", "cuda"),
                                   fused_color_draw),
                                  ("unfused", ("cuda", "off"),
                                   banded_gather)):
        counter.launches = 0
        marg, _ = infer_mc(ds, ds.w_init,
                           torch.Generator(device=dev).manual_seed(3), 200,
                           2000, infos, CHAINS, modes=modes, device=dev)
        errs[label] = float(abs(marg[query, :2] - exact[query]).max())
        require(errs[label] < 0.01, f"{label} |dp| = {errs[label]}")
        require(counter.launches > 0, f"{label} path launched no kernel")
    report("3 oracle", t3, max_abs_dp=errs, n_query=len(query),
           chains=CHAINS, sweeps=2000)

    # ---- 4: flagship --------------------------------------------------------
    t4 = time.perf_counter()
    nbr0, starts0, _ = gather_in[0]
    fargs = (values, ts.bd_nbr, ts.bd_start[0], beta, base, 0, seed, W, TB,
             D)
    kern = {
        "fused_color_draw": dict(
            ms=time_ms(lambda: fused_color_draw(*fargs), iters=50),
            plain_ms=time_ms(lambda: fused_color_draw_plain(*fargs),
                             iters=3, warmup=1),
            library_ms=None),
        "banded_gather": dict(
            ms=time_ms(lambda: banded_gather(values, nbr0, starts0, W),
                       iters=50),
            plain_ms=time_ms(lambda: banded_gather_plain(values, nbr0,
                                                         starts0, W),
                             iters=5, warmup=1),
            library_ms=time_ms(lambda: values.index_select(
                0, nbr0.reshape(-1)), iters=50)),
    }
    # bounds: each input byte read once, each output byte written once
    f_nbr = ts.bd_nbr[0, :nt]
    f_bytes = (rows_read(f_nbr.reshape(nt, D, TB), starts0, W) * CHAINS
               + 2 * f_nbr.numel() * 4 + nt * TB * 4 + nt * 4 + 8
               + nt * TB * CHAINS)
    # per (row, chain): D multiply-adds, a sigmoid (4), the hash and the
    # uniform (about 24 integer operations), counted at the f32 rate
    f_ops = nt * TB * CHAINS * (2 * D + 4 + 24)
    g_bytes = (rows_read(nbr0, starts0, W) * CHAINS + nbr0.numel() * 4
               + nt * 4 + nbr0.numel() * CHAINS)
    for name, nbytes, ops in (("fused_color_draw", f_bytes, f_ops),
                              ("banded_gather", g_bytes, 0)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        kern[name].update(bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations", bytes=nbytes, ops=ops)
    del values, gather_in, fargs

    runs = {}
    for label, modes in (("fused", None), ("unfused", ("cuda", "off"))):
        fused_color_draw.launches = 0
        banded_gather.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = time.perf_counter()
        marg, vals = infer_mc(d, d.w_init,
                              torch.Generator(device=dev).manual_seed(7),
                              BURN, SWEEPS, info, CHAINS, modes=modes,
                              device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tr
        launches = {"fused_color_draw": fused_color_draw.launches,
                    "banded_gather": banded_gather.launches}
        require(marg.shape == (g.n_vars, 2), f"marginals {marg.shape}")
        require(bool((marg >= 0).all() and (marg <= 1).all()),
                "marginals outside [0, 1]")
        require(float(abs(marg.sum(1) - 1).max()) < 1e-5,
                "marginal rows do not sum to 1")
        require(bool(((vals == 0) | (vals == 1)).all()), "non-boolean world")
        runs[label] = dict(
            wall_s=wall,
            variable_updates_per_s=g.n_vars * CHAINS * (BURN + SWEEPS)
            / wall,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            launches=launches, mean_p1=float(marg[:, 1].mean()))
        del vals
    require(runs["fused"]["launches"]["fused_color_draw"]
            == C * (BURN + SWEEPS), "fused path: fused_color_draw launches")
    require(runs["unfused"]["launches"]["banded_gather"]
            == C * (BURN + SWEEPS), "unfused path: banded_gather launches")
    dp = abs(runs["fused"]["mean_p1"] - runs["unfused"]["mean_p1"])
    require(dp < 0.01, f"fused and unfused mean marginals differ by {dp}")
    # where a fused sweep's time goes (CUDA events; after the counted runs)
    modes = resolve_modes(info, dev)
    folded = prepare_fold(d, d.w_init, info, modes)
    gen_b = torch.Generator(device=dev).manual_seed(9)
    world = init_values_mc(d, gen_b, CHAINS, info)
    counts = torch.zeros((2, P), dtype=torch.int32, device=dev)
    block, drawn = world[:B], torch.zeros_like(world[:B])

    def tally():
        for k in range(2):
            counts[k] += (world == k).sum(dim=1, dtype=torch.int32)

    sweep_ms = time_ms(lambda: sweep_mc(d, world, d.w_init, gen_b, False,
                                        info, folded, modes), iters=10)
    parts = {"fused_color_draw_x2": 2 * kern["fused_color_draw"]["ms"],
             "block_write_x2": 2 * time_ms(lambda: block.copy_(torch.where(
                 ts.cm_resample[0][:, None], drawn, block)))}
    parts["rest"] = sweep_ms - sum(parts.values())
    breakdown = dict(sweep_ms=sweep_ms, parts_ms=parts,
                     tally_ms=time_ms(tally))
    del world, counts, block, drawn, d, ds, folded
    kern["fused_color_draw"].update(
        launches=runs["fused"]["launches"]["fused_color_draw"],
        max_abs_err=fused_err)
    kern["banded_gather"].update(
        launches=runs["unfused"]["launches"]["banded_gather"],
        max_abs_err=0.0)
    report("4 flagship", t4, card=card, grid=f"{GRID}x{GRID}", chains=CHAINS,
           burn=BURN, sweeps=SWEEPS, runs=runs, kernels=kern,
           fused_sweep_breakdown=breakdown)

    # ---- 5, 6: the learning flagship --------------------------------------
    g, d, info, kern["grad_pair_tile"] = grad_phase(dev)
    learn_launches = learn_phase(dev, g, d, info)
    kern["grad_pair_tile"]["launches"] = learn_launches["grad_pair_tile"]
    del d

    sources = {"fused_color_draw": ("sampler_tpu_torch/csrc/"
                                    "fused_color_draw.cu",
                                    "sampler_tpu/ops/fused.py:365"),
               "banded_gather": ("sampler_tpu_torch/csrc/banded_gather.cu",
                                 "sampler_tpu/ops/banded.py:261"),
               "grad_pair_tile": ("sampler_tpu_torch/csrc/grad_pair_tile.cu",
                                  "sampler_tpu/ops/grad.py:42")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for name, k in kern.items()]}
    print(json.dumps(line), flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
