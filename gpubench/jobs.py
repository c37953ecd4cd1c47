"""The jobs a cell's window runs, one at a time, back to back.

A traffic file (``gpubench/workloads/<name>.json``) names its job kind,
``"job": <kind>``, and holds the flags of ``dw gibbs``.  A kind is
``gpubench/kinds/<kind>.py``, found by that name: its ``Job`` drives the
program's entry points as the command line drives them
(``sampler_tpu_torch/cli.py``, ``_run_gibbs_phases``) and ends on a host
read; its ``numbers`` judge what the kept jobs produced; its ``FAULTS``
are the faults of its timed path (``gpubench.faults``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def job_generator(seed: int, index: int, device) -> torch.Generator:
    """The job's generator, from (seed, job index) alone."""
    key = np.random.SeedSequence([seed & (2 ** 64 - 1), index & (2 ** 64 - 1)])
    g = torch.Generator(device=device)
    g.manual_seed(int(key.generate_state(1, np.uint64)[0] >> 1))
    return g


@dataclasses.dataclass
class Done:
    """A finished job: the little the judge reads of every job (``brief``)
    and what it keeps of a judged one (``keep``)."""
    brief: object
    keep: dict


_KINDS = {}


def kind(name: str):
    """The module ``kinds/<name>.py``."""
    if name not in _KINDS:
        path = os.path.join(HERE, "kinds", name + ".py")
        if not os.path.exists(path):
            raise ValueError(f"no job kind {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            "gpubench_kind_" + name.replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _KINDS[name] = mod
    return _KINDS[name]


def make(traffic: dict, warmup: bool = False):
    """The traffic's job, or its short warm-up job of the same kind and
    shapes."""
    return kind(traffic["job"]).Job(traffic, 2 if warmup else None)
