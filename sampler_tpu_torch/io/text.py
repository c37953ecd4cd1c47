"""Text (TSV) ↔ binary converters — the `text2bin` / `bin2text` subcommands
(copy of sampler_tpu/io/text.py; the port imports nothing of the JAX
package).

Reference analog: the dw text2bin/bin2text tools DeepDive's grounding pipes
through.  One TSV line per record,
tab-separated, field order identical to the binary layout:

    weight:   wid  is_fixed  initial_value
    variable: vid  role  initial_value  dtype  cardinality
    factor:   ftype  wid  feature  edge...   where edge = vid:ispos[:eqpred]
    domain:   vid  card  v0 v1 ... v{card-1}
"""
from __future__ import annotations

import numpy as np

from .. import format_spec as fs
from ..graph import FactorGraph


def graph_to_text(graph: FactorGraph):
    """Returns dict of section name → list of TSV lines."""
    weights = [f"{i}\t{int(f)}\t{v:.17g}"
               for i, (f, v) in enumerate(zip(graph.w_fixed, graph.w_init))]
    variables = [
        f"{i}\t{int(graph.var_role[i])}\t{int(graph.var_init[i])}\t"
        f"{int(graph.var_dtype[i])}\t{int(graph.var_card[i])}"
        for i in range(graph.n_vars)
    ]
    factors = []
    for f in range(graph.n_factors):
        lo, hi = int(graph.f_ptr[f]), int(graph.f_ptr[f + 1])
        cat = int(graph.f_type[f]) in fs.CATEGORICAL_FUNCS
        edges = []
        for e in range(lo, hi):
            tok = f"{int(graph.e_vid[e])}:{int(graph.e_ispos[e])}"
            if cat:
                tok += f":{int(graph.e_eqpred[e])}"
            edges.append(tok)
        factors.append("\t".join(
            [str(int(graph.f_type[f])), str(int(graph.f_wid[f])),
             f"{float(graph.f_feat[f]):.17g}"] + edges))
    domains = [
        "\t".join([str(vid), str(len(vals))] + [str(int(v)) for v in vals])
        for vid, vals in sorted((graph.domains or {}).items())
    ]
    return {"weights": weights, "variables": variables, "factors": factors,
            "domains": domains}


# ---------------------------------------------------------------------------
# direct single-relation TSV → binary record converters.  These serialize
# each line straight to the on-disk layout with NO cross-relation
# validation: a converter must not require (or guess at) the other
# relations' content — a factor file's true variable cardinalities are
# simply unknown here.
# ---------------------------------------------------------------------------

def weight_lines_to_bin(lines) -> bytes:
    rec = np.empty(len(lines), fs.WEIGHT_RECORD)
    for i, ln in enumerate(lines):
        wid, fixed, v = ln.split("\t")
        rec[i] = (int(wid), int(fixed), float(v))
    return rec.tobytes()


def variable_lines_to_bin(lines) -> bytes:
    rec = np.empty(len(lines), fs.VARIABLE_RECORD)
    for i, ln in enumerate(lines):
        vid, role, init, dtype, card = ln.split("\t")
        rec[i] = (int(vid), int(role), int(init), int(dtype), int(card))
    return rec.tobytes()


def factor_lines_to_bin(lines) -> bytes:
    chunks = []
    for ln in lines:
        parts = ln.split("\t")
        ftype, wid, feat = int(parts[0]), int(parts[1]), float(parts[2])
        cat = ftype in fs.CATEGORICAL_FUNCS
        chunks.append(np.array([ftype], fs.BE_U16).tobytes())
        chunks.append(np.array([len(parts) - 3], fs.BE_I64).tobytes())
        for tok in parts[3:]:
            bits = tok.split(":")
            chunks.append(np.array([int(bits[0])], fs.BE_I64).tobytes())
            chunks.append(np.array([int(bits[1])], fs.BE_U8).tobytes())
            if cat:
                eq = int(bits[2]) if len(bits) > 2 else 1
                chunks.append(np.array([eq], fs.BE_I64).tobytes())
        chunks.append(np.array([wid], fs.BE_I64).tobytes())
        chunks.append(np.array([feat], fs.BE_F64).tobytes())
    return b"".join(chunks)


def domain_lines_to_bin(lines) -> bytes:
    chunks = []
    for ln in lines:
        parts = ln.split("\t")
        vid, card = int(parts[0]), int(parts[1])
        chunks.append(np.array([vid, card], fs.BE_I64).tobytes())
        chunks.append(np.asarray([int(x) for x in parts[2:2 + card]],
                                 fs.BE_I64).tobytes())
    return b"".join(chunks)


def text_to_graph(weights_lines, variables_lines, factors_lines,
                  domains_lines=()) -> FactorGraph:
    w_fixed, w_init = [], []
    for ln in weights_lines:
        _, f, v = ln.split("\t")
        w_fixed.append(bool(int(f)))
        w_init.append(float(v))

    role, init, dtype, card = [], [], [], []
    for ln in variables_lines:
        _, r, iv, dt, c = ln.split("\t")
        role.append(int(r)); init.append(int(iv))
        dtype.append(int(dt)); card.append(int(c))

    factors = []
    for ln in factors_lines:
        parts = ln.split("\t")
        ftype, wid, feat = int(parts[0]), int(parts[1]), float(parts[2])
        edges = []
        for tok in parts[3:]:
            bits = tok.split(":")
            vid, ispos = int(bits[0]), bool(int(bits[1]))
            eq = int(bits[2]) if len(bits) > 2 else 1
            edges.append((vid, ispos, eq))
        factors.append((ftype, wid, feat, edges))

    domains = {}
    for ln in domains_lines:
        parts = ln.split("\t")
        vid, c = int(parts[0]), int(parts[1])
        domains[vid] = np.asarray([int(x) for x in parts[2:2 + c]], np.int64)

    g = FactorGraph.build(
        var_card=card, factors=factors, weights=w_init,
        var_role=np.asarray(role, np.uint8),
        var_init=np.asarray(init, np.int32),
        var_dtype=np.asarray(dtype, np.uint8),
        w_fixed=np.asarray(w_fixed, bool),
    )
    if domains:
        g.domains = domains
    return g
