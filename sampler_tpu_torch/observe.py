"""Observability: structured run logging and throughput/convergence stats
(counterpart of sampler_tpu/observe.py).

Replaces the reference's printf + timer.h walltime prints (SURVEY.md §5.1/5.5)
with structured per-phase records (JSON lines) plus the headline metric —
variable updates/s — computed the same way bench.py reports it.  The
statistics take numpy arrays or torch tensors (on any device).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


class RunLog:
    """JSONL event logger; quiet mode drops human echo but keeps the file."""

    def __init__(self, path: Optional[str] = None, quiet: bool = False):
        self.path = path
        self.quiet = quiet
        self._fp = open(path, "a") if path else None
        self._t0 = time.time()

    def event(self, kind: str, **fields: Any) -> None:
        rec = {"t": round(time.time() - self._t0, 4), "kind": kind, **fields}
        if self._fp:
            self._fp.write(json.dumps(rec) + "\n")
            self._fp.flush()
        if not self.quiet:
            msg = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{rec['t']:9.2f}s] {kind}: {msg}", file=sys.stderr,
                  flush=True)

    def close(self) -> None:
        if self._fp:
            self._fp.close()
            self._fp = None


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
