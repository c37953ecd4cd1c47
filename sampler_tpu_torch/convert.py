"""Carry a compiled graph across from the JAX package.

``from_jax`` takes a ``sampler_tpu`` DeviceGraph and CompileInfo and returns
the port's own (numpy) DeviceGraph and CompileInfo with the same streams and
weights, so one compiled graph can feed both packages identical inputs.  It
reads fields by name and does not import the JAX package: its arrays may be
numpy arrays or anything ``np.asarray`` accepts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .compile import CompileInfo, DeviceGraph, TierInfo, TierStreams


def from_jax(dg, info) -> tuple:
    """(DeviceGraph, CompileInfo) of the port from the JAX package's.

    Stream shapes are kept as given (logical or flat); ``to_device``
    flattens either."""
    tiers = tuple(
        TierStreams(**{f: np.asarray(getattr(ts, f))
                       for f in TierStreams._fields})
        for ts in dg.tiers)
    top = {f: np.asarray(getattr(dg, f))
           for f in DeviceGraph._fields if f != "tiers"}
    tier_infos = tuple(TierInfo(**dataclasses.asdict(ti))
                       for ti in info.tiers)
    fields = dataclasses.asdict(info)
    fields["tiers"] = tier_infos
    return DeviceGraph(tiers=tiers, **top), CompileInfo(**fields)
