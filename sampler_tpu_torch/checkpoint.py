"""Chain-state checkpoint/resume (the .npz layout of
sampler_tpu/checkpoint.py).

The whole sampler state (worlds, weights, tallies, epoch and sweep
counters, the run's seed words) is a handful of flat arrays in one .npz
file.  Where the JAX package keeps its PRNG key, the port keeps
``rng_key``: the seed words from which the run derives a fresh
torch.Generator for each chunk (``engine.rng.chunk_generator``), so nothing of a
generator's state needs saving.  The worlds keep their dtype (int8, or
int32 above card 127).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass
class SamplerState:
    """Everything needed to resume a run deterministically."""

    values: np.ndarray           # [P] or [P, NC] current assignments
    weights: np.ndarray          # [W] float32
    rng_key: np.ndarray          # the run's seed words (uint32)
    counts: Optional[np.ndarray] = None   # [P, K] marginal tallies
    sweep: int = 0               # sweeps completed
    epoch: int = 0               # learning epochs completed
    meta: Optional[Dict[str, Any]] = None


def save(state: SamplerState, path: str) -> None:
    """Write ``state`` to ``path`` through a temporary file and a rename,
    so a kill mid-write leaves the previous checkpoint whole."""
    tmp = path + ".tmp"
    arrays = dict(
        values=np.asarray(state.values),
        weights=np.asarray(state.weights),
        rng_key=np.asarray(state.rng_key),
        sweep=np.asarray(state.sweep),
        epoch=np.asarray(state.epoch),
    )
    if state.counts is not None:
        arrays["counts"] = np.asarray(state.counts)
    arrays["meta_json"] = np.frombuffer(
        json.dumps(state.meta or {}).encode(), dtype=np.uint8)
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load(path: str) -> SamplerState:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta_json"]).decode()) if "meta_json" in z else {}
    return SamplerState(
        values=z["values"],
        weights=z["weights"],
        rng_key=z["rng_key"],
        counts=z["counts"] if "counts" in z else None,
        sweep=int(z["sweep"]),
        epoch=int(z["epoch"]),
        meta=meta,
    )
