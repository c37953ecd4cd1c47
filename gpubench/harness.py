"""One run of one cell: set-up, the timed window, the traced stretch, the
metrics and the verdict.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the cell's configuration and traffic, ``configs/<config>.json`` and
``workloads/<traffic>.json`` hold them, the configuration names its graph
generator (``generators/<name>.py``) and the traffic its job kind
(``kinds/<job>.py``: the job, its judge's numbers, its faults);
``limits/<cell>.json`` holds the limits of its checks,
``metrics/<metric>.py`` the reader of each metric and
``kernels/<kernel>.json`` the device names of each kernel.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import random
import sys
import time

import numpy as np
import torch

from . import graphs, jobs, judge, reference, trace
from .jobs import job_generator, make as make_job

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "sampler_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_parts(bench: dict, name: str) -> tuple:
    """(cell, config, traffic) of workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    return (cell, load_json("configs", cell["config"] + ".json"),
            load_json("workloads", cell["traffic"] + ".json"))


def metric_names(bench: dict, cell: str, traced: bool) -> list:
    """The cell's end-to-end metrics (untraced) or per-layer ones."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Setup:
    """What set-up made: the graph arrays (the benchmark's), the coloring
    handed to compile_graph, and the program's compiled graph."""
    graph: dict
    colors: np.ndarray
    dg: object
    info: object
    pos_of_vid: np.ndarray
    n_chains: int
    device: torch.device
    host_compile_s: float


def set_up(config: dict, traffic: dict, seed: int, device) -> Setup:
    """``dw gibbs``'s order: the graph from the seed, the coloring (the
    generator's exact one, or the program's greedy coloring), RCM where
    the configuration says so, compile_graph with its flags, to_device."""
    from sampler_tpu_torch.coloring import greedy_coloring, rcm_order
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.graph import FactorGraph

    labels = config["labels"] if traffic["job"] == "learn" else None
    g, colors = graphs.make(config, seed, labels)
    fg = FactorGraph(**g)
    t0 = time.perf_counter()
    if colors is None:
        colors = greedy_coloring(fg)
    kw = dict(config.get("compile", {}))
    if config.get("order") == "rcm":
        kw["order"] = rcm_order(fg)
    dg, info = compile_graph(fg, colors=colors, **kw)
    host_s = time.perf_counter() - t0
    n_chains = int(traffic.get("n_chains", config["n_chains"]))
    return Setup(g, np.asarray(colors), to_device(dg, device), info,
                 np.asarray(dg.pos_of_vid, np.int64), n_chains,
                 torch.device(device), host_s)


JUDGED = 16                     # jobs a run keeps for the judge


@dataclasses.dataclass
class Window:
    jobs: list           # (seconds, updates, sweeps) of each finished job
    seconds: float       # window start to the last finished job's end
    briefs: list         # each finished job's brief (jobs.Done)
    kept: list           # (job index, keep on the host) of the judged jobs
    traced: object       # trace.Summary of the profiled jobs, or None

    @property
    def judged(self) -> list:
        return sorted(i for i, _ in self.kept)


def run_window(s: Setup, job, seconds: float, seed: int, traced: bool,
               out_dir: str, judged: int = JUDGED) -> Window:
    """Jobs back to back until ``seconds`` have passed; a job starts only
    while the last one's time still fits, and counts only if it ends
    inside.  The judged jobs are drawn from the seed among the finished
    ones (a reservoir of ``judged``); what the judge keeps of them is
    copied to the host at once, off the clock and off the card's peak.
    With ``traced``, the jobs from the second on, as many as fill about a
    second, run under torch.profiler; they are not judged, so no copy
    falls inside the traced stretch."""
    pick = random.Random(seed)
    V, NC = s.info.n_vars, s.n_chains
    done, briefs, kept = [], [], []
    prof = summary = None
    n_prof = in_prof = n_seen = 0
    paused = paused_end = 0.0
    t_start = time.perf_counter()
    t_end = t_start
    last = 0.0
    while True:
        t0 = time.perf_counter()
        if done and t0 + 1.02 * last > t_start + seconds + paused:
            break
        i = len(done)
        if traced and i == 1 and prof is None:
            n_prof = max(1, int(np.ceil(1.0 / max(last, 1e-3))))
            prof = trace.start(s.device)
            t_prof = time.perf_counter()
        r = job.run(s, job_generator(seed, i, s.device))
        t1 = time.perf_counter()
        profiled = prof is not None and summary is None
        if profiled:
            in_prof += 1
            if in_prof == n_prof:
                sync(s.device)
                summary = trace.stop(prof, time.perf_counter() - t_prof,
                                     in_prof, job, out_dir)
        if t1 > t_start + seconds + paused:
            break
        last = t1 - t0
        done.append((last, job.updates(V, NC), job.sweeps()))
        briefs.append(r.brief)
        t_end, paused_end = t1, paused
        if not profiled:
            slot = n_seen if n_seen < judged else pick.randrange(n_seen + 1)
            n_seen += 1
            if slot < judged:
                tk = time.perf_counter()
                host = {k: v.cpu() if torch.is_tensor(v) else v
                        for k, v in r.keep.items()}
                if slot < len(kept):
                    kept[slot] = (i, host)
                else:
                    kept.append((i, host))
                paused += time.perf_counter() - tk
        del r
    if prof is not None and summary is None:
        summary = trace.stop(prof, time.perf_counter() - t_prof, in_prof,
                             job, out_dir)
    return Window(done, t_end - t_start - paused_end, briefs, kept, summary)


def vid_space(s: Setup, kind, keep: dict) -> dict:
    """A judged job's kept worlds on the device in variable-id space
    [V, NC], its counts [K, V]."""
    pos = torch.as_tensor(s.pos_of_vid, device=s.device)
    out = {}
    for k, v in keep.items():
        if k in kind.WORLDS:
            out[k] = torch.as_tensor(v).to(s.device).index_select(0, pos)
        elif k in kind.COUNTS:
            out[k] = torch.as_tensor(v).reshape(s.info.max_card, -1)[
                :, torch.as_tensor(s.pos_of_vid)]
        else:
            out[k] = v
    return out


def check(s: Setup, win: Window, job, traffic: dict, control: bool,
          seed: int) -> tuple:
    """(numbers, notes) of the window's judged jobs (``kinds/<kind>.py``
    ``numbers``)."""
    fa = reference.Factors(s.graph, s.device)
    if not judge.proper(fa, s.colors):
        raise RuntimeError("the coloring handed to compile_graph is not "
                           "proper: the sweep's order is undefined")
    kind = jobs.kind(traffic["job"])
    kept = [vid_space(s, kind, keep) for _, keep in win.kept]
    gen = torch.Generator(device=s.device)
    gen.manual_seed(seed & 0x7FFFFFFF)
    return kind.numbers(fa, s.graph, s.colors, kept, win.briefs, traffic,
                        control, gen)


def run_cell(root: str, name: str, seed: int, seconds: float, traced: bool,
             device="cuda", control: bool = False, t_process: float = None,
             out=sys.stdout, err=sys.stderr) -> dict:
    """Run cell ``name`` once; returns the result line's object."""
    bench = load_bench(root)
    cell, config, traffic = cell_parts(bench, name)
    return run(cell, config, traffic, load_json("limits", name + ".json"),
               metric_names(bench, name, traced), seed, seconds, traced,
               device, control, t_process, out, err)


def run(cell: dict, config: dict, traffic: dict, limits: dict,
        metric_list: list, seed: int, seconds: float, traced: bool,
        device="cuda", control: bool = False, t_process: float = None,
        out=sys.stdout, err=sys.stderr) -> dict:
    """One run of a cell given its parts (``run_cell`` finds them)."""
    t_process = time.time() if t_process is None else t_process
    name = cell["name"]
    dev = torch.device(device)
    card = trace.card(dev)
    print(json.dumps(dict(card=card, peaks=trace.PEAKS)), file=out,
          flush=True)

    s = set_up(config, traffic, seed, dev)
    from sampler_tpu_torch import ops
    make_job(traffic, warmup=True).run(s, job_generator(seed, -1, dev))
    if traced:
        trace.warm(dev)
    sync(dev)
    job = make_job(traffic)
    out_dir = os.path.join(HERE, "out")
    launches0 = ops.kernel_launches()
    setup_s = time.time() - t_process

    win = run_window(s, job, seconds, seed, traced, out_dir)
    sync(dev)
    launches = {k: v - launches0[k] for k, v in ops.kernel_launches().items()
                if v - launches0[k]}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    print(json.dumps(dict(launches=launches, jobs=len(win.jobs),
                          judged_jobs=win.judged, window_s=win.seconds,
                          host_compile_s=s.host_compile_s)), file=out,
          flush=True)
    if not win.jobs:
        raise RuntimeError(f"no job finished in {seconds} s")

    ctx = dict(cell=cell, config=config, traffic=traffic, setup=s, job=job,
               window=win, setup_s=setup_s, peak_bytes=peak,
               host_compile_s=s.host_compile_s, trace=win.traced)
    metrics = {}
    for m in metric_list:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    for note in ctx.get("notes", []):
        print(json.dumps(note), file=out, flush=True)

    # the program's state goes before the reference runs
    s.dg = None
    del ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, notes = check(s, win, job, traffic, control, seed)
    for note in notes:
        print(json.dumps(note), file=out, flush=True)
    ok, rows = judge.verdict(numbers, limits)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=err, flush=True)
        raise SystemExit(3)
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                       count=1, memory_peak_bytes=int(peak))
    result = dict(correct=ok, attempted=len(win.jobs), failed=0,
                  metrics=metrics, device=device_info)
    if traced and win.traced is not None:
        device_info.update(busy_s=win.traced.busy_s,
                           window_s=win.traced.window_s)
        result["breakdown"] = win.traced.breakdown
    if control:
        result["control"] = True
    result["check"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k} {v} limit {lim}", file=err, flush=True)
    return result
