"""The benchmark's factor graphs, made from a seed.

A configuration names its generator, ``gpubench/generators/<name>.py``,
whose ``make(seed, **graph)`` returns (graph, colors or None).  A graph is
a dict of numpy arrays with the fields of
``sampler_tpu_torch.graph.FactorGraph`` (structure of arrays, factor edges
in CSR order: body..., head), so the program receives only arrays and the
reference reads the same ones.  The benchmark owns its generators: a later
change to the program cannot move its inputs.

Factor-function ids are the file format's (DeepDive's ``FUNC_*``), copied
here so that nothing of the program is imported.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np

FUNC_IMPLY_NATURAL = 0
FUNC_OR = 1
FUNC_AND = 2
FUNC_EQUAL = 3
FUNC_ISTRUE = 4
FUNC_IMPLY_MLN = 13
ROLE_EVIDENCE = 1
HERE = os.path.dirname(os.path.abspath(__file__))


def arrays(var_role, var_init, w_init, f_type, f_wid, f_ptr, e_vid,
           e_ispos) -> dict:
    """A boolean graph's arrays, every feature 1 and no weight fixed."""
    V, F, E = len(var_role), len(f_type), len(e_vid)
    return dict(
        var_dtype=np.zeros(V, np.uint8),
        var_role=np.asarray(var_role, np.uint8),
        var_init=np.asarray(var_init, np.int32),
        var_card=np.full(V, 2, np.int32),
        w_init=np.asarray(w_init, np.float64),
        w_fixed=np.zeros(len(w_init), bool),
        f_type=np.asarray(f_type, np.int32),
        f_wid=np.asarray(f_wid, np.int32),
        f_feat=np.ones(F, np.float64),
        f_ptr=np.asarray(f_ptr, np.int64),
        e_vid=np.asarray(e_vid, np.int32),
        e_ispos=np.asarray(e_ispos, bool),
        e_eqpred=np.ones(E, np.int32),
    )


def generator(name: str):
    """``make`` of ``generators/<name>.py``."""
    path = os.path.join(HERE, "generators", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_generator_" + name.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def label(g: dict, rule: str) -> dict:
    """Learning labels: ``"evidence"`` keeps the generator's evidence;
    ``"every_second"`` makes every second variable evidence labelled
    ``(index // 2) % 2``, as the port's ``bench.py`` labels its lattice."""
    if rule == "every_second":
        g = dict(g, var_role=g["var_role"].copy(),
                 var_init=g["var_init"].copy())
        g["var_role"][::2] = ROLE_EVIDENCE
        g["var_init"][::2] = np.arange((len(g["var_role"]) + 1) // 2) % 2
    elif rule != "evidence":
        raise ValueError(f"unknown label rule {rule!r}")
    return g


def make(config: dict, seed: int, labels: str | None = None) -> tuple:
    """(graph, colors or None) of ``config`` for ``seed``, labelled by
    ``labels`` when given (learning jobs)."""
    g, colors = generator(config["generator"])(seed, **config["graph"])
    if labels is not None:
        g = label(g, labels)
    return g, colors
