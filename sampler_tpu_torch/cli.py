"""dw-compatible command-line interface of the PyTorch/CUDA port
(counterpart of sampler_tpu/cli.py):

  python -m sampler_tpu_torch.cli gibbs -w weights.bin -v variables.bin
           -f factors.bin -m graph.meta [--domains d.bin] -o outdir
           -l epochs -i epochs -s sweeps -a stepsize -d diminish
           -b burn_in [--n_chains N] [--regularization l1|l2]
           [--reg_param λ] [--sample_evidence] [--learn_non_evidence]
           [--device cuda|cpu] [--n_graph_shards G]
           [--checkpoint_every N [--resume]] [--quiet]
  python -m sampler_tpu_torch.cli text2bin {weight|variable|factor|domain}
           in.tsv out.bin
  python -m sampler_tpu_torch.cli bin2text ...

``gibbs`` loads the binary graph files, compiles the graph, learns the
weights (``-l`` epochs), then runs burn-in and inference, and writes
``inference_result.out.text`` and ``inference_result.out.weights.text``
into the output directory.  It runs on the CUDA device unless
``--device cpu`` is given; without a card ``--device cuda`` raises, and
the run never moves to the CPU by itself.

``-t/--n_threads`` and ``-c/--n_datacopy`` are accepted for drop-in
compatibility; ``-t`` maps to ``--n_chains`` (independent chains).  On the
card the chain count is rounded up to a multiple of 16, where the kernels
take their 16-byte variants (the JAX command line rounds to the TPU's 128
lanes instead; ``engine.multichain.effective_chains``).

Learning, burn-in and inference run on the multi-chain engine in chunks
of N epochs or sweeps with ``--checkpoint_every N`` (one chunk each
without it), each chunk drawn from a generator derived from (--seed,
phase, absolute epoch or sweep index); with checkpoints the state is saved
after each chunk, and a killed run restarted with ``--resume`` writes the
same bytes as an uninterrupted run with the same N (on graphs without a
hub tier, whose ``index_add_`` sums in a varying order).

``--n_graph_shards G`` above 1 compiles with ``align=8*G, shards=G`` and
runs learning and inference on a (chains, graph) mesh of ranks
(``parallel.graph_shard``): the graph split over G ranks, the card count
divided by G running chains in parallel (``--device cpu``: G CPU ranks).
A shard count that does not divide the card count exits with a message.
Its checkpoints are the phases "gs_learn" and "gs_infer".
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from .engine.rng import chunk_generator
from .observe import clear_spans, span, span_line, spans
from .ops import kernel_launches


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dw", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gibbs", help="learning + marginal inference")
    g.add_argument("-w", "--weights", required=True)
    g.add_argument("-v", "--variables", required=True)
    g.add_argument("-f", "--factors", required=True)
    g.add_argument("-m", "--meta", required=True)
    g.add_argument("--domains", default=None)
    g.add_argument("-o", "--outdir", required=True)
    g.add_argument("-l", "--n_learning_epoch", type=int, default=0)
    g.add_argument("-i", "--n_inference_epoch", type=int, default=500)
    g.add_argument("-s", "--n_samples_per_learning_epoch", type=int, default=1)
    g.add_argument("-a", "--alpha", "--stepsize", dest="alpha", type=float,
                   default=0.01)
    g.add_argument("-d", "--diminish", type=float, default=0.95)
    g.add_argument("-b", "--burn_in", type=int, default=0)
    g.add_argument("-t", "--n_threads", type=int, default=None,
                   help="compat alias for --n_chains")
    g.add_argument("-c", "--n_datacopy", type=int, default=None,
                   help="compat alias (NUMA replicas → chains)")
    g.add_argument("--n_chains", type=int, default=1)
    g.add_argument("--order", choices=["id", "rcm"], default="id",
                   help="variable ordering within (color, tier) segments: "
                        "'rcm' runs reverse Cuthill-McKee to recover "
                        "locality (tightens the banded-gather windows on "
                        "irregular graphs)")
    g.add_argument("--max_tiers", type=int, default=4,
                   help="degree-tier cap for the device layout (1 disables "
                        "bucketing; skewed KBC graphs want >= 2)")
    g.add_argument("--band_wmax", type=int, default=8192,
                   help="max banded-gather window width (positions); raise "
                        "for wide graphs (e.g. 16384 for a 10^4-column "
                        "grid) so the banded gathers and fused draws stay "
                        "on")
    g.add_argument("--hub_cap", type=int, default=2048,
                   help="variables with more incident factors than this go "
                        "to the chunked-CSR hub tier (power-law heads); a "
                        "low cap (e.g. 256) keeps the degree tail from "
                        "padding its dense tier")
    g.add_argument("--hub_chunk", type=int, default=512,
                   help="records per hub-tier chunk")
    g.add_argument("--n_graph_shards", type=int, default=1,
                   help="shard the graph over this many devices (the "
                        "remaining factor of the device count runs chains "
                        "in parallel); with --device cpu, this many CPU "
                        "ranks")
    g.add_argument("--regularization", choices=["l1", "l2"], default=None)
    g.add_argument("--reg_param", type=float, default=0.0)
    g.add_argument("--sample_evidence", action="store_true")
    g.add_argument("--learn_non_evidence", action="store_true")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the CUDA device (default; raises without "
                        "one) or on the CPU (the kernels' plain PyTorch "
                        "versions)")
    g.add_argument("--checkpoint", default=None,
                   help="checkpoint file (default <outdir>/checkpoint.npz "
                        "when --checkpoint_every is set)")
    g.add_argument("--checkpoint_every", type=int, default=0,
                   help="snapshot sampler state every N sweeps (inference/"
                        "burn-in) or N epochs (learning); 0 = off")
    g.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    g.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run, from the "
                        "graph's load on, to DIR/trace.json, and log the "
                        "program's spans with the most self time")
    g.add_argument("--quiet", "-q", action="store_true")

    for name in ("text2bin", "bin2text"):
        c = sub.add_parser(name)
        c.add_argument("relation", choices=["weight", "variable", "factor",
                                            "domain"])
        c.add_argument("input")
        c.add_argument("output")

    return p


def seed_words(seed: int) -> np.ndarray:
    """The run's --seed as two uint32 words (the checkpoint's rng_key)."""
    return np.array([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF],
                    np.uint32)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiled(out_dir, device, log):
    """torch.profiler over the block when ``out_dir`` (--profile) is set:
    the trace written to ``out_dir``/trace.json, and one log line of the
    program's spans (``observe``) with the most self time."""
    if not out_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    clear_spans()
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        log(f"profiler trace written to {out_dir}/trace.json")
        log(f"spans (name count inclusive_s self_s): {span_line(spans())}")


def cmd_gibbs(args, mesh=None) -> int:
    """The gibbs command; ``mesh`` (a parallel.comm.Mesh or open
    parallel.launch.Ranks) replaces the mesh --n_graph_shards derives from
    the device count, as on one card whose ranks share it over Gloo."""
    import torch

    from .compile import resolve_device

    device = resolve_device(args.device)
    n_graph = max(args.n_graph_shards, 1)
    if n_graph > 1 and mesh is None:
        mesh = shard_mesh(n_graph, device)
    elif mesh is not None:
        m = getattr(mesh, "mesh", mesh)
        if m.n_graph != n_graph:
            raise SystemExit(f"--n_graph_shards {n_graph}, mesh of "
                             f"{m.n_graph} graph ranks")
    log = ((lambda *a: None) if args.quiet
           else (lambda *a: print(*a, flush=True)))
    with _profiled(args.profile, device, log):
        graph, info, weights, marg, launches = _gibbs_run(
            args, log, device, n_graph, mesh)
    if device.type == "cuda":
        log(f"peak device memory "
            f"{torch.cuda.max_memory_allocated(device)} bytes")
        if launches is None:
            log(f"kernel launches: {json.dumps(kernel_launches())}")
        else:
            log(f"kernel launches by rank: {json.dumps(launches)}")

    _write_outputs(args, log, graph, info, weights, marg)
    return 0


def _gibbs_run(args, log, device, n_graph, mesh) -> tuple:
    """Load, compile and run the gibbs command's phases; returns (graph,
    info, weights, marginals, each rank's launches or None)."""
    import torch

    from .compile import compile_graph, to_device
    from .engine.multichain import effective_chains
    from .io import binary

    t0 = time.time()
    with span("cli.load"):
        graph = binary.load_graph(args.meta, domains_path=args.domains)
    log(f"loaded graph: {graph.n_vars} vars, {graph.n_factors} factors, "
        f"{graph.n_weights} weights, {graph.n_edges} edges "
        f"[{time.time()-t0:.3f}s]")

    t0 = time.time()
    order = None
    if args.order == "rcm":
        from .coloring import rcm_order
        order = rcm_order(graph)
    dg, info = compile_graph(graph, align=8 * n_graph,
                             band_wmax=args.band_wmax, shards=n_graph,
                             max_tiers=args.max_tiers, order=order,
                             hub_cap=args.hub_cap, hub_chunk=args.hub_chunk)
    # a sharded run hands the ranks the host graph; they move their slices
    d = to_device(dg, device if n_graph == 1 else "cpu")
    del dg
    _sync(device)
    log(f"compiled: {info.n_colors} colors, block {info.block_size}, "
        f"degree {info.max_degree}, arity {info.max_arity}, "
        f"tiers {[(ti.block, ti.degree, ti.arity) for ti in info.tiers]} "
        f"[{time.time()-t0:.3f}s]")

    weights = d.w_init
    n_chains = args.n_chains
    if args.n_threads:
        n_chains = max(n_chains, args.n_threads)
    n_eff = effective_chains(info, device, n_chains, d.var_card.shape[0],
                             n_worlds=2 if args.n_learning_epoch else 1)
    if n_eff != n_chains:
        log(f"n_chains {n_chains} -> {n_eff} (rounded up to a multiple of "
            "16, where the kernels take their 16-byte variants)")
        n_chains = n_eff

    every = args.checkpoint_every
    ckpt_path = args.checkpoint
    if every and not ckpt_path:
        os.makedirs(args.outdir, exist_ok=True)
        ckpt_path = os.path.join(args.outdir, "checkpoint.npz")
    state = None
    if args.resume and ckpt_path and os.path.exists(ckpt_path):
        from . import checkpoint
        state = checkpoint.load(ckpt_path)
        sig = dict(n_vars=info.n_vars, n_factors=info.n_factors,
                   seed=args.seed, n_chains=n_chains, n_graph=n_graph)
        got = {k: state.meta.get(k) for k in sig}
        got["n_graph"] = state.meta.get("n_graph", 1)
        if got != sig:
            raise SystemExit(
                f"checkpoint {ckpt_path} was written by a different run "
                f"(meta {state.meta} vs {sig})")
        log(f"resuming from {ckpt_path}: phase={state.meta.get('phase')} "
            f"epoch={state.epoch} sweep={state.sweep}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if n_graph > 1:
        weights, marg, launches = _run_gibbs_sharded(
            args, log, d, info, weights, n_chains, n_graph, every,
            ckpt_path, state, device, mesh)
    else:
        weights, marg = _run_gibbs_phases(
            args, log, graph, d, info, weights, n_chains, every, ckpt_path,
            state, device)
        launches = None
    return graph, info, weights, marg, launches


def _write_outputs(args, log, graph, info, weights, marg):
    from .io import results

    os.makedirs(args.outdir, exist_ok=True)
    results.write_marginals(graph, marg,
                            os.path.join(args.outdir,
                                         "inference_result.out.text"))
    # drop the reserved zero slot appended by compile (sparse-cw sentinel)
    results.write_weights_out(
        _host(weights)[: info.n_weights],
        os.path.join(args.outdir, "inference_result.out.weights.text"))
    log(f"wrote {args.outdir}/inference_result.out.text")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


_fault_counter = [0]


def _fault_hook():
    """Fault injection for preemption-recovery tests: hard-kill the process
    after N checkpoint saves when SAMPLER_TPU_FAULT_AFTER=N (a preemption
    landing between chunks)."""
    n = os.environ.get("SAMPLER_TPU_FAULT_AFTER")
    if not n:
        return
    _fault_counter[0] += 1
    if _fault_counter[0] >= int(n):
        sys.stderr.write("FAULT INJECTED: exiting after "
                         f"{_fault_counter[0]} checkpoint saves\n")
        sys.stderr.flush()
        os._exit(3)


def _run_gibbs_phases(args, log, graph, d, info, weights, n_chains, every,
                      ckpt_path, state, device):
    """learn → burn-in → inference, each phase in chunks of ``every``
    epochs or sweeps (the whole phase one chunk when it is 0), the state
    saved after each chunk when checkpoints are on.  Each chunk's
    generator is derived from the ABSOLUTE epoch/sweep index, so a resumed
    run replays exactly what an uninterrupted run with the same ``every``
    draws."""
    import dataclasses

    import torch

    from . import checkpoint
    from .engine.learn import LearnConfig
    from .engine.multichain import (init_values_mc, learn_mc,
                                    run_inference_mc, run_sweeps_mc)

    meta = dict(n_vars=info.n_vars, n_factors=info.n_factors,
                seed=args.seed, n_chains=n_chains)

    def gen(phase, index):
        return chunk_generator(args.seed, phase, index, device)

    def on_device(a):
        return torch.as_tensor(a).to(device)

    def chunks(done, n):
        while done < n:
            chunk = min(every or n, n - done)
            yield done, chunk
            done += chunk

    def save(phase, worlds, counts=None, sweep=0, epoch=0, w=None):
        """Snapshot the device ``worlds`` (one tensor, or the learning
        pair) when checkpoints are on; without them nothing leaves the
        card."""
        if not every:
            return
        with span("cli.checkpoint"):
            values = (np.stack([_host(v) for v in worlds])
                      if isinstance(worlds, tuple) else _host(worlds))
            checkpoint.save(checkpoint.SamplerState(
                values=values, weights=_host(w),
                rng_key=seed_words(args.seed), counts=counts,
                sweep=sweep, epoch=epoch, meta={**meta, "phase": phase}),
                ckpt_path)
        _fault_hook()

    # ---- learning ----------------------------------------------------
    n_epochs = args.n_learning_epoch
    epochs_done, v_ev, v_free = 0, None, None
    if state is not None and state.meta.get("phase") == "learn":
        epochs_done = state.epoch
        weights = on_device(state.weights)
        v_ev = on_device(state.values[0])
        v_free = on_device(state.values[1])
        state = None
    elif state is not None:           # burn/infer phase: learning finished
        epochs_done = n_epochs
        weights = on_device(state.weights)

    if epochs_done < n_epochs:
        t0 = time.time()
        cfg = LearnConfig(
            n_epochs=n_epochs,
            n_sweeps_per_epoch=args.n_samples_per_learning_epoch,
            stepsize=args.alpha,
            diminish=args.diminish,
            regularization=args.regularization or "none",
            reg_param=args.reg_param,
            learn_non_evidence=args.learn_non_evidence,
        )
        for done, chunk in chunks(epochs_done, n_epochs):
            weights, v_ev, v_free = learn_mc(
                d, weights, gen("learn", done),
                dataclasses.replace(cfg, n_epochs=chunk), info, n_chains,
                v_ev=v_ev, v_free=v_free,
                alpha=cfg.stepsize * cfg.diminish ** done, device=device)
            save("learn", (v_ev, v_free), epoch=done + chunk, w=weights)
        _sync(device)
        dt = time.time() - t0
        sweeps = n_epochs * cfg.n_sweeps_per_epoch
        log(f"learning: {sweeps} sweeps in {dt:.3f}s "
            f"({sweeps * graph.n_vars / max(dt, 1e-9):.4g} vars/s)")
    del v_ev, v_free

    # ---- burn-in + inference ------------------------------------------
    t0 = time.time()
    n_burn, n_inf = args.burn_in, args.n_inference_epoch
    K = info.max_card
    burn_done, inf_done = 0, 0
    counts = np.zeros((d.var_card.shape[0], K), np.int64)
    if state is not None and state.meta.get("phase") == "burn":
        values = on_device(state.values)
        burn_done = state.sweep
    elif state is not None and state.meta.get("phase") == "infer":
        values = on_device(state.values)
        burn_done, inf_done = n_burn, state.sweep
        counts = state.counts.astype(np.int64)
    else:
        values = init_values_mc(d, gen("init", 0), n_chains, info)
    for done, chunk in chunks(burn_done, n_burn):
        values = run_sweeps_mc(d, values, weights, gen("burn", done), chunk,
                               args.sample_evidence, info, device)
        save("burn", values, sweep=done + chunk, w=weights)
    _sync(device)
    t_run = time.time()
    for done, chunk in chunks(inf_done, n_inf):
        values, cts = run_inference_mc(
            d, values, weights, gen("run", done), chunk,
            args.sample_evidence, info, device)
        with span("cli.marginals"):
            # device counts are flat row-major [K, P]
            counts += _host(cts).astype(np.int64).reshape(K, -1).T
        save("infer", values, counts=counts, sweep=done + chunk,
             w=weights)
    dt_run = time.time() - t_run
    with span("cli.marginals"):
        marg = (counts[_host(d.pos_of_vid)]
                / float(n_inf * n_chains)).astype(np.float32)
    dt = time.time() - t0
    total = (n_burn + n_inf) * graph.n_vars * n_chains
    log(f"inference: {n_inf} sweeps x {n_chains} chains in "
        f"{dt:.3f}s ({total / max(dt, 1e-9):.4g} vars/s)")
    run = (n_inf - inf_done) * graph.n_vars * n_chains
    log(f"counted sweeps: {n_inf - inf_done} in {dt_run:.3f}s "
        f"({run / max(dt_run, 1e-9):.4g} vars/s)")
    return weights, marg


def shard_mesh(n_graph: int, device):
    """The (chains, graph) mesh of ``--n_graph_shards n_graph``: every card
    (with --device cpu, n_graph CPU ranks), n_graph to a chains row; exits
    when n_graph does not divide the card count."""
    import torch

    from .parallel.comm import make_mesh

    cuda = device.type == "cuda"
    n_dev = torch.cuda.device_count() if cuda else n_graph
    if n_dev % n_graph or n_dev < n_graph:
        raise SystemExit(f"--n_graph_shards {n_graph} does not divide the "
                         f"{n_dev} available devices")
    return make_mesh(n_dev // n_graph, n_graph,
                     [f"cuda:{i}" for i in range(n_dev)] if cuda
                     else ["cpu"] * n_dev)


def _run_gibbs_sharded(args, log, host, info, weights, n_chains, n_graph,
                       every, ckpt_path, state, device, mesh):
    """Learn and infer on ``mesh`` (a parallel.comm.Mesh or open
    parallel.launch.Ranks): the graph's streams split over the ``n_graph``
    ranks of a chains row, the rows running chains in parallel
    (``n_chains`` chains a rank), one set of ranks for both phases.  With
    ``every`` set, both snapshot at chunk boundaries (phases "gs_learn"
    and "gs_infer"); the ranks derive their generators from the absolute
    epoch or sweep, so a killed and resumed run writes the bytes of an
    uninterrupted checkpointed one.  Returns (weights, marginals, each
    rank's kernel launches)."""
    import contextlib

    import torch

    from . import checkpoint
    from .engine.learn import LearnConfig
    from .parallel.graph_shard import infer_gs, learn_gs
    from .parallel.launch import Ranks

    m = mesh.mesh if isinstance(mesh, Ranks) else mesh
    log(f"mesh: chains={m.n_chains} x graph={m.n_graph} over "
        f"{m.backend}, {n_chains} chains/device")
    meta = dict(n_vars=info.n_vars, n_factors=info.n_factors,
                seed=args.seed, n_chains=n_chains, n_graph=n_graph)

    def save(phase, values, counts=None, sweep=0, epoch=0, w=None):
        checkpoint.save(checkpoint.SamplerState(
            values=values, weights=np.asarray(w),
            rng_key=seed_words(args.seed), counts=counts, sweep=sweep,
            epoch=epoch, meta={**meta, "phase": phase}), ckpt_path)
        _fault_hook()

    phase = None if state is None else state.meta.get("phase")
    opened = (contextlib.nullcontext(mesh) if isinstance(mesh, Ranks)
              else Ranks(mesh))
    launches = None
    with opened as ranks:
        n_epochs = args.n_learning_epoch
        if phase == "gs_infer":
            weights = torch.as_tensor(state.weights)
        elif n_epochs > 0:
            cfg = LearnConfig(
                n_epochs=n_epochs,
                n_sweeps_per_epoch=args.n_samples_per_learning_epoch,
                stepsize=args.alpha, diminish=args.diminish,
                regularization=args.regularization or "none",
                reg_param=args.reg_param,
                learn_non_evidence=args.learn_non_evidence)
            resume = None
            if phase == "gs_learn":
                resume = (state.epoch, state.weights, state.values[0],
                          state.values[1])
            on_ckpt = None
            if every:
                def on_ckpt(done, w, v_ev, v_free):
                    save("gs_learn", np.stack([v_ev, v_free]), epoch=done,
                         w=w)
            t0 = time.time()
            weights = learn_gs(host, weights, args.seed, cfg, info, ranks,
                               n_chains, checkpoint_every=every,
                               on_checkpoint=on_ckpt, resume_state=resume)
            launches = ranks.launches
            log(f"learning: {n_epochs} epochs [{time.time()-t0:.3f}s]")
        resume = None
        if phase == "gs_infer":
            resume = (state.sweep, state.values,
                      state.counts.astype(np.int64))
        on_ckpt = None
        if every:
            def on_ckpt(done, values, counts):
                save("gs_infer", values, counts=counts, sweep=done,
                     w=weights)
        t0 = time.time()
        marg = infer_gs(host, weights, args.seed, args.burn_in,
                        args.n_inference_epoch, info, ranks, n_chains,
                        sample_evidence=args.sample_evidence,
                        checkpoint_every=every, on_checkpoint=on_ckpt,
                        resume_state=resume)
        launches = ([{k: a[k] + b[k] for k in a}
                     for a, b in zip(launches, ranks.launches)]
                    if launches else ranks.launches)
        log(f"inference: {args.n_inference_epoch} sweeps "
            f"(+{args.burn_in} burn-in) [{time.time()-t0:.3f}s]")
    return weights, marg, launches


def cmd_text2bin(args) -> int:
    # Single-relation conversion: TSV lines → binary records, serialized
    # directly (no cross-relation validation — a lone factor file cannot
    # know the variables' cardinalities)
    from .io import text
    with open(args.input) as fp:
        lines = [ln.rstrip("\n") for ln in fp if ln.strip()]
    conv = {"weight": text.weight_lines_to_bin,
            "variable": text.variable_lines_to_bin,
            "factor": text.factor_lines_to_bin,
            "domain": text.domain_lines_to_bin}[args.relation]
    with open(args.output, "wb") as fp:
        fp.write(conv(lines))
    return 0


def cmd_bin2text(args) -> int:
    from . import format_spec as fs
    from .io import binary
    out_lines = []
    if args.relation == "weight":
        w_init, w_fixed = binary.read_weights(args.input)
        out_lines = [f"{i}\t{int(f)}\t{v:.17g}"
                     for i, (f, v) in enumerate(zip(w_fixed, w_init))]
    elif args.relation == "variable":
        role, init, dtype, card = binary.read_variables(args.input)
        out_lines = [f"{i}\t{int(role[i])}\t{int(init[i])}\t{int(dtype[i])}\t"
                     f"{int(card[i])}" for i in range(len(role))]
    elif args.relation == "factor":
        f_type, f_wid, f_feat, f_ptr, e_vid, e_ispos, e_eq = \
            binary.read_factors(args.input)
        for f in range(len(f_type)):
            lo, hi = int(f_ptr[f]), int(f_ptr[f + 1])
            cat = int(f_type[f]) in fs.CATEGORICAL_FUNCS
            edges = []
            for e in range(lo, hi):
                tok = f"{int(e_vid[e])}:{int(e_ispos[e])}"
                if cat:
                    tok += f":{int(e_eq[e])}"
                edges.append(tok)
            out_lines.append("\t".join(
                [str(int(f_type[f])), str(int(f_wid[f])),
                 f"{float(f_feat[f]):.17g}"] + edges))
    elif args.relation == "domain":
        doms = binary.read_domains(args.input)
        out_lines = ["\t".join([str(v), str(len(vals))] +
                               [str(int(x)) for x in vals])
                     for v, vals in sorted(doms.items())]
    with open(args.output, "w") as fp:
        fp.write("\n".join(out_lines) + ("\n" if out_lines else ""))
    return 0


def main(argv=None, mesh=None) -> int:
    """Run a command; ``mesh``: as in cmd_gibbs."""
    args = build_parser().parse_args(argv)
    if args.cmd == "gibbs":
        return cmd_gibbs(args, mesh)
    if args.cmd == "text2bin":
        return cmd_text2bin(args)
    if args.cmd == "bin2text":
        return cmd_bin2text(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
