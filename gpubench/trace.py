"""The traced stretch: torch.profiler over whole jobs, reduced to device
time by kernel, device busy time and the host work in each idle gap.

The card's peaks are the published ones for one H100 SXM (NVIDIA's data
sheet, dense, at its 700 W limit): 3.35 TB/s of HBM, 67 TFLOP/s float32
outside the tensor cores.  Integer operations have no published rate; the
one used is derived: 64 int32 operations a clock on each SM (Hopper's
four partitions of 16 integer lanes) x 132 SMs x the 1980 MHz boost
clock.  The card's name and power limit are printed beside them
(``card``).
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import os
import re
import subprocess

import torch

PEAKS = dict(hbm_bytes_per_s=3.35e12, f32_ops_per_s=67e12,
             int32_ops_per_s=64 * 132 * 1.98e9,
             int32_derivation="64 a clock an SM x 132 SMs x 1980 MHz")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


def card(device) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (copied from the port's ``observe.card``); None on the CPU."""
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


def start(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def warm(device) -> None:
    """Start and stop a profiler once in set-up: the first start
    initializes the device tracer, which takes seconds."""
    prof = start(device)
    torch.ones(8, device=device).sum().item()
    prof.__exit__(None, None, None)


def short(name: str) -> str:
    """A kernel's name without return type, template arguments and
    parameters."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name[:80]


def merge(intervals) -> list:
    """Union of [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy, lo: float, hi: float) -> list:
    """The idle [start, end) intervals of [lo, hi) outside ``busy``."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def attribute(gap_list, host) -> dict:
    """Idle seconds by the host op running at each gap's midpoint (the
    innermost: the latest to start); gaps with none go to "host (no op)"."""
    host = sorted(host)
    by, active, j = {}, [], 0
    for a, b in sorted(gap_list):
        m = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= m:
            heapq.heappush(active, (host[j][1], host[j][0], host[j][2]))
            j += 1
        while active and active[0][0] <= m:
            heapq.heappop(active)
        live = [x for x in active if x[0] > m]
        name = max(live, key=lambda x: x[1])[2] if live else "host (no op)"
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    return by


@dataclasses.dataclass
class Summary:
    window_s: float            # the stretch's host seconds
    busy_s: float              # device seconds with an operation running
    n_kernels: int
    jobs: int
    sweeps: int                # sweeps of the profiled jobs
    by_kernel: dict            # full kernel name -> (seconds, launches)
    breakdown: dict

    def kernel_seconds(self, patterns) -> tuple:
        """(seconds, launches) of the kernels whose names match any of
        ``patterns`` (regular expressions searched in the full name)."""
        rx = [re.compile(p) for p in patterns]
        sec = n = 0
        for name, (t, c) in self.by_kernel.items():
            if any(r.search(name) for r in rx):
                sec += t
                n += c
        return sec, n


def stop(prof, window_s: float, n_jobs: int, job, out_dir: str) -> Summary:
    """Close the profiler and reduce its chrome trace (written under
    ``out_dir`` and removed once read)."""
    prof.__exit__(None, None, None)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace-{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    dev, host, by = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                t, c = by.get(e["name"], (0.0, 0))
                by[e["name"]] = (t + dur * 1e-6, c + 1)
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e["name"]))
    busy = merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    if host or dev:
        lo = min([h[0] for h in host] + [d[0] for d in dev])
        hi = max([h[1] for h in host] + [d[1] for d in dev])
    else:
        lo = hi = 0.0
    idle = attribute(gaps(busy, lo, hi), host) if dev else {}
    ops = {}
    for name, (t, _) in by.items():
        ops[short(name)] = ops.get(short(name), 0.0) + t
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(window_s=window_s, busy_s=busy_s,
                   n_kernels=sum(c for _, c in by.values()), jobs=n_jobs,
                   sweeps=n_jobs * job.sweeps(), by_kernel=by,
                   breakdown=dict(device_ops=[list(x) for x in top],
                                  idle_gaps=[list(x) for x in top_idle]))
