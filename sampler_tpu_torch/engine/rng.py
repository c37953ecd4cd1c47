"""Seeded generators for runs cut into chunks, resumed, or split over
ranks.

A run never carries a generator's state across a chunk: each chunk (a
checkpoint's span of epochs or sweeps, or one sweep or epoch of a rank)
draws from a fresh torch.Generator seeded from a hash of the run's seed,
the phase, the chunk's absolute index and, on a mesh, the rank's
coordinates.  So a resumed run draws what an uninterrupted one does, and
a chunked call what a single call does, bit for bit.
"""
from __future__ import annotations

import hashlib

import torch


def chunk_generator(seed: int, phase: str, index: int, device, *coords):
    """A fresh torch.Generator on ``device`` for the chunk of ``phase``
    ("learn", "infer", "init", "burn", "run", "gs_sweep", ...) that starts
    at epoch or sweep ``index``, seeded from a hash of (seed, phase,
    index, *coords); ``coords`` are a rank's mesh coordinates, so every
    rank draws its own noise."""
    key = ":".join(str(x) for x in (seed, phase, index, *coords))
    h = hashlib.sha256(key.encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h[:8], "little") & ((1 << 63) - 1))
