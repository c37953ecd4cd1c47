"""Inference-result writers — output-format parity with the reference (copy
of sampler_tpu/io/results.py; the port imports nothing of the JAX package).

Text files:
  inference_result.out.text          vid [category] marginal_probability
  inference_result.out.weights.text  wid weight_value
Boolean variables get one line (P(v=1)); categorical variables one line per
category.  Category values are written in the variable's sparse domain
representation when a domain map exists.
"""
from __future__ import annotations

import numpy as np

from .. import format_spec as fs
from ..graph import FactorGraph


def marginals_lines(graph: FactorGraph, marginals: np.ndarray):
    """marginals: float [V, K] (dense category indices)."""
    lines = []
    for v in range(graph.n_vars):
        if graph.var_dtype[v] == fs.DTYPE_BOOLEAN:
            lines.append(f"{v} {marginals[v, 1]:.6f}")
        else:
            dom = (graph.domains or {}).get(v)
            for k in range(int(graph.var_card[v])):
                cat = int(dom[k]) if dom is not None else k
                lines.append(f"{v} {cat} {marginals[v, k]:.6f}")
    return lines


def write_marginals(graph: FactorGraph, marginals: np.ndarray, path: str) -> None:
    with open(path, "w") as fp:
        fp.write("\n".join(marginals_lines(graph, marginals)) + "\n")


def write_weights_out(weights: np.ndarray, path: str) -> None:
    with open(path, "w") as fp:
        for i, w in enumerate(np.asarray(weights)):
            fp.write(f"{i} {float(w):.8f}\n")


def read_marginals(path: str):
    """Parse a marginals text file → list of (vid, category|None, prob)."""
    out = []
    for ln in open(path):
        parts = ln.split()
        if len(parts) == 2:
            out.append((int(parts[0]), None, float(parts[1])))
        elif len(parts) == 3:
            out.append((int(parts[0]), int(parts[1]), float(parts[2])))
    return out
