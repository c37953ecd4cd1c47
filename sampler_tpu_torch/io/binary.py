"""Binary factor-graph format reader/writer (counterpart of
sampler_tpu/io/binary.py: the same bytes, and the same errors at the same
byte offsets).

Implements the DimmWitted on-disk contract: five big-endian files and a
metadata CSV, every byte width from format_spec.  Categorical ``domains``
files map sparse category values to dense 0..k-1 indices at load time
(variable initial values and factor equal-predicates are translated); the
sparse values are kept on the FactorGraph for round-tripping.

The factors file holds variable-length records (a member list inline), so
its record starts form a chain: one pass over the 10-byte record headers
finds them (and raises on a truncated or implausible header), then every
field of every record is read, or written, at once through big-endian
views of the bytes.  ``read_factors`` parses the file with the native host
library, as the JAX package does; the vectorised reader is its plain
version (``read_factors(native=False)``), and ``read_factors_loop`` the
record-by-record reader both are held to.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Optional

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .. import format_spec as fs
from .. import native as native_mod
from ..graph import FactorGraph

_CATEGORICAL = np.array(sorted(fs.CATEGORICAL_FUNCS), np.int64)


# ---------------------------------------------------------------------------
# big-endian fields at arbitrary byte offsets
# ---------------------------------------------------------------------------

def _get(raw: np.ndarray, offsets: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """The ``dtype`` field at each byte offset of the uint8 array ``raw``."""
    n = dtype.itemsize
    if len(offsets) == 0 or len(raw) < n:
        return np.zeros(0, dtype)
    return sliding_window_view(raw, n)[offsets].view(dtype).ravel()


def _put(out: np.ndarray, offsets: np.ndarray, values, dtype: np.dtype):
    """Write ``values`` as big-endian ``dtype`` at each byte offset."""
    n = dtype.itemsize
    b = np.asarray(values).astype(dtype).view(np.uint8).reshape(-1, n)
    out[offsets[:, None] + np.arange(n)] = b


def _is_categorical(f_type) -> np.ndarray:
    return np.isin(np.asarray(f_type, np.int64), _CATEGORICAL)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def write_weights(graph: FactorGraph, path: str) -> None:
    rec = np.empty(graph.n_weights, fs.WEIGHT_RECORD)
    rec["wid"] = np.arange(graph.n_weights)
    rec["is_fixed"] = graph.w_fixed.astype(np.uint8)
    rec["init"] = graph.w_init
    rec.tofile(path)


def write_variables(graph: FactorGraph, path: str) -> None:
    rec = np.empty(graph.n_vars, fs.VARIABLE_RECORD)
    rec["vid"] = np.arange(graph.n_vars)
    rec["role"] = graph.var_role
    rec["init"] = _dense_to_sparse(graph, np.arange(graph.n_vars),
                                   graph.var_init)
    rec["dtype"] = graph.var_dtype
    rec["card"] = graph.var_card
    rec.tofile(path)


def write_factors(graph: FactorGraph, path: str) -> None:
    """The new-format factors file: every field of every record written at
    once (the equal-predicates only for categorical factors' edges, in
    their sparse values)."""
    f_type = np.asarray(graph.f_type, np.int64)
    f_ptr = np.asarray(graph.f_ptr, np.int64)
    arity = np.diff(f_ptr)
    F, E = len(f_type), int(f_ptr[-1])
    cat = _is_categorical(f_type)
    esz = np.where(cat, 17, 9)
    rec = 10 + arity * esz + 16
    starts = np.concatenate([[0], np.cumsum(rec)[:-1]]).astype(np.int64)
    out = np.zeros(int(rec.sum()), np.uint8)
    _put(out, starts, f_type, fs.BE_U16)
    _put(out, starts + 2, arity, fs.BE_I64)
    fid = np.repeat(np.arange(F), arity)
    slot = np.arange(E) - np.repeat(f_ptr[:-1], arity)
    eoff = starts[fid] + 10 + slot * esz[fid]
    _put(out, eoff, graph.e_vid, fs.BE_I64)
    out[eoff + 8] = np.asarray(graph.e_ispos).astype(np.uint8)
    ecat = cat[fid]
    eq = _dense_to_sparse(graph, graph.e_vid[ecat], graph.e_eqpred[ecat])
    _put(out, eoff[ecat] + 9, eq, fs.BE_I64)
    tail = starts + 10 + arity * esz
    _put(out, tail, graph.f_wid, fs.BE_I64)
    _put(out, tail + 8, graph.f_feat, fs.BE_F64)
    with open(path, "wb") as fp:
        fp.write(out.tobytes())


def write_factors_old(graph: FactorGraph, factors_path: str,
                      edges_path: str) -> None:
    """OLD two-file layout (format_spec.OLD_FACTOR_RECORD / EDGE_RECORD):
    fixed-width factor records + a separate edges file."""
    rec = np.empty(graph.n_factors, fs.OLD_FACTOR_RECORD)
    rec["ftype"] = graph.f_type
    rec["arity"] = graph.arities()
    rec["wid"] = graph.f_wid
    rec["feat"] = graph.f_feat
    rec.tofile(factors_path)
    E = graph.n_edges
    erec = np.empty(E, fs.EDGE_RECORD)
    erec["vid"] = graph.e_vid
    erec["fid"] = np.repeat(np.arange(graph.n_factors), graph.arities())
    erec["position"] = np.arange(E) - np.repeat(graph.f_ptr[:-1],
                                                graph.arities())
    erec["ispos"] = graph.e_ispos.astype(np.uint8)
    erec["eqpred"] = _dense_to_sparse(graph, graph.e_vid, graph.e_eqpred)
    erec.tofile(edges_path)


def write_comb_weights(graph: FactorGraph, path: str) -> None:
    """Optional sparse per-combination weight entries
    (format_spec.CWEIGHT_HEADER + arity × categoryValue:i64)."""
    arity = graph.arities()
    fid = np.asarray(graph.cw_fid, np.int64)
    a = arity[fid].astype(np.int64)
    N = len(fid)
    rec = 16 + 8 * a
    starts = np.concatenate([[0], np.cumsum(rec)[:-1]]).astype(np.int64)
    out = np.zeros(int(rec.sum()), np.uint8)
    _put(out, starts, fid, fs.BE_I64)
    _put(out, starts + 8, graph.cw_wid, fs.BE_I64)
    ent = np.repeat(np.arange(N), a)
    slot = np.arange(int(a.sum())) - np.repeat(np.cumsum(a) - a, a)
    vid = graph.e_vid[graph.f_ptr[fid][ent] + slot]
    cats = _dense_to_sparse(graph, vid, np.asarray(graph.cw_cats)[ent, slot])
    _put(out, starts[ent] + 16 + 8 * slot, cats, fs.BE_I64)
    with open(path, "wb") as fp:
        fp.write(out.tobytes())


def write_domains(graph: FactorGraph, path: str) -> None:
    words = []
    for vid, values in sorted((graph.domains or {}).items()):
        words.append(np.array([vid, len(values)], np.int64))
        words.append(np.asarray(values, np.int64))
    with open(path, "wb") as fp:
        if words:
            fp.write(np.concatenate(words).astype(fs.BE_I64).tobytes())


def write_meta(graph: FactorGraph, path: str, weights_file: str,
               variables_file: str, factors_file: str,
               edges_file: str = "") -> None:
    line = ",".join([
        str(graph.n_weights), str(graph.n_vars), str(graph.n_factors),
        str(graph.n_edges), weights_file, variables_file, factors_file,
        edges_file,
    ])
    with open(path, "w") as fp:
        fp.write(line + "\n")


def write_graph(graph: FactorGraph, outdir: str, prefix: str = "graph",
                old_format: bool = False) -> str:
    """Write all files into ``outdir``; returns the metadata path.

    ``old_format=True`` writes the two-file factors+edges layout used by
    older reference revisions."""
    os.makedirs(outdir, exist_ok=True)
    wf = os.path.join(outdir, f"{prefix}.weights")
    vf = os.path.join(outdir, f"{prefix}.variables")
    ff = os.path.join(outdir, f"{prefix}.factors")
    write_weights(graph, wf)
    write_variables(graph, vf)
    ef = ""
    if old_format:
        ef = os.path.join(outdir, f"{prefix}.edges")
        write_factors_old(graph, ff, ef)
    else:
        write_factors(graph, ff)
    if graph.domains:
        write_domains(graph, os.path.join(outdir, f"{prefix}.domains"))
    if graph.cw_fid is not None and len(graph.cw_fid):
        write_comb_weights(graph, ff + ".cweights")
    meta = os.path.join(outdir, f"{prefix}.meta")
    write_meta(graph, meta, wf, vf, ff, edges_file=ef)
    return meta


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def read_weights(path: str):
    rec = np.fromfile(path, fs.WEIGHT_RECORD)
    order = np.argsort(rec["wid"], kind="stable")
    rec = rec[order]
    return rec["init"].astype(np.float64), rec["is_fixed"].astype(bool)


def read_variables(path: str):
    rec = np.fromfile(path, fs.VARIABLE_RECORD)
    order = np.argsort(rec["vid"], kind="stable")
    rec = rec[order]
    return (rec["role"].astype(np.uint8), rec["init"].astype(np.int64),
            rec["dtype"].astype(np.uint8), rec["card"].astype(np.int32))


def _factor_starts(buf: bytes):
    """(starts, ftype, arity) int64 [F] of the factor records in ``buf``:
    the one sequential pass, over the 10-byte headers only.  Raises on a
    truncated header, an implausible arity or a truncated body, with the
    byte offsets of the record-by-record reader."""
    total = len(buf)
    header = struct.Struct(">Hq").unpack_from
    cat = fs.CATEGORICAL_FUNCS
    starts, types, arities = [], [], []
    pos = 0
    while pos < total:
        if pos + 10 > total:
            raise ValueError(
                f"truncated factor record header at byte {pos}/{total}")
        ftype, arity = header(buf, pos)
        if arity < 0 or arity > 10**9:
            raise ValueError(
                f"implausible factor arity {arity} at byte {pos + 2} "
                "(corrupt factors file?)")
        rec_bytes = arity * (17 if ftype in cat else 9) + 16
        if pos + 10 + rec_bytes > total:
            raise ValueError(
                f"truncated factor record body at byte {pos + 10}/{total} "
                f"(arity {arity} needs {rec_bytes} bytes)")
        starts.append(pos)
        types.append(ftype)
        arities.append(arity)
        pos += 10 + rec_bytes
    return (np.asarray(starts, np.int64), np.asarray(types, np.int64),
            np.asarray(arities, np.int64))


def read_factors(path: str, native: bool = True):
    """Factor records: (f_type, f_wid, f_feat, f_ptr, e_vid, e_ispos,
    e_eqpred_sparse), exactly as ``read_factors_loop`` returns them.

    ``native`` (the default): the native host library's parser; a file it
    finds malformed is read again by the vectorised reader, which raises
    the ValueError with its byte offset.  ``native=False``: the vectorised
    reader alone (the plain version)."""
    with open(path, "rb") as fp:
        buf = fp.read()
    if native:
        out = native_mod.parse_factors(buf)
        if out is not None:
            return out
        _factor_starts(buf)
        raise ValueError(f"malformed factors file {path}")
    starts, f_type, arity = _factor_starts(buf)
    raw = np.frombuffer(buf, np.uint8)
    F = len(starts)
    f_ptr = np.concatenate([[0], np.cumsum(arity)]).astype(np.int64)
    E = int(f_ptr[-1])
    cat = _is_categorical(f_type)
    esz = np.where(cat, 17, 9)
    fid = np.repeat(np.arange(F), arity)
    slot = np.arange(E) - np.repeat(f_ptr[:-1], arity)
    eoff = starts[fid] + 10 + slot * esz[fid]
    e_eq = np.ones(E, np.int64)
    ecat = cat[fid]
    e_eq[ecat] = _get(raw, eoff[ecat] + 9, fs.BE_I64)
    tail = starts + 10 + arity * esz
    return (f_type.astype(np.int32), _get(raw, tail, fs.BE_I64)
            .astype(np.int32), _get(raw, tail + 8, fs.BE_F64)
            .astype(np.float64), f_ptr,
            _get(raw, eoff, fs.BE_I64).astype(np.int64),
            raw[eoff + 8].astype(bool), e_eq)


def read_factors_loop(path: str):
    """The record-by-record reader (the JAX package's Python loop): the
    reference both routes of ``read_factors`` are held to."""
    with open(path, "rb") as fp:
        buf = memoryview(fp.read())
    pos = 0
    f_type, f_wid, f_feat, f_ptr = [], [], [], [0]
    e_vid, e_ispos, e_eq = [], [], []

    def take(dtype, n=1):
        nonlocal pos
        out = np.frombuffer(buf, dtype, count=n, offset=pos)
        pos += dtype.itemsize * n
        return out

    total = len(buf)
    while pos < total:
        if pos + 10 > total:
            raise ValueError(
                f"truncated factor record header at byte {pos}/{total}")
        ftype = int(take(fs.BE_U16)[0])
        arity = int(take(fs.BE_I64)[0])
        if arity < 0 or arity > 10**9:
            raise ValueError(
                f"implausible factor arity {arity} at byte {pos - 8} "
                "(corrupt factors file?)")
        categorical = ftype in fs.CATEGORICAL_FUNCS
        rec_bytes = arity * (17 if categorical else 9) + 16
        if pos + rec_bytes > total:
            raise ValueError(
                f"truncated factor record body at byte {pos}/{total} "
                f"(arity {arity} needs {rec_bytes} bytes)")
        for _ in range(arity):
            e_vid.append(int(take(fs.BE_I64)[0]))
            e_ispos.append(bool(take(fs.BE_U8)[0]))
            e_eq.append(int(take(fs.BE_I64)[0]) if categorical else 1)
        f_type.append(ftype)
        f_wid.append(int(take(fs.BE_I64)[0]))
        f_feat.append(float(take(fs.BE_F64)[0]))
        f_ptr.append(len(e_vid))
    return (np.asarray(f_type, np.int32), np.asarray(f_wid, np.int32),
            np.asarray(f_feat, np.float64), np.asarray(f_ptr, np.int64),
            np.asarray(e_vid, np.int64), np.asarray(e_ispos, bool),
            np.asarray(e_eq, np.int64))


def read_factors_old(factors_path: str, edges_path: str):
    """OLD two-file layout: fixed-width factor records + edges file.
    Returns the same tuple as read_factors."""
    rec = np.fromfile(factors_path, fs.OLD_FACTOR_RECORD)
    erec = np.fromfile(edges_path, fs.EDGE_RECORD)
    F = len(rec)
    arity = rec["arity"].astype(np.int64)
    f_ptr = np.concatenate([[0], np.cumsum(arity)])
    if len(erec) != f_ptr[-1]:
        raise ValueError(
            f"edges file has {len(erec)} records, factors imply {f_ptr[-1]}")
    # order edges by (factor, position) regardless of file order
    order = np.lexsort((erec["position"], erec["fid"]))
    erec = erec[order]
    want_fid = np.repeat(np.arange(F), arity)
    if not (erec["fid"].astype(np.int64) == want_fid).all():
        raise ValueError("edges file factor ids do not match factor arities")
    return (rec["ftype"].astype(np.int32), rec["wid"].astype(np.int32),
            rec["feat"].astype(np.float64), f_ptr,
            erec["vid"].astype(np.int64), erec["ispos"].astype(bool),
            erec["eqpred"].astype(np.int64))


def read_comb_weights(path: str, arity: np.ndarray):
    """Sparse per-combination weight entries; ``arity`` is per-factor.
    Returns (cw_fid, cw_cats_sparse [N, max_arity], cw_wid).  The entry
    starts form a chain through the arity of each entry's factor: one pass
    over the 16-byte headers finds them, then the categories are read at
    once."""
    with open(path, "rb") as fp:
        buf = fp.read()
    total = len(buf)
    header = struct.Struct(">qq").unpack_from
    hsz = fs.CWEIGHT_HEADER.itemsize
    starts, fids, wids = [], [], []
    pos = 0
    while pos < total:
        if pos + hsz > total:
            raise ValueError(
                f"truncated .cweights header at byte {pos}/{total}")
        f, w = header(buf, pos)
        pos += hsz
        if f < 0 or f >= len(arity):
            raise ValueError(
                f".cweights entry references factor {f} "
                f"(graph has {len(arity)})")
        a = int(arity[f])
        if pos + 8 * a > total:
            raise ValueError(
                f"truncated .cweights entry at byte {pos}/{total}")
        starts.append(pos)
        fids.append(f)
        wids.append(w)
        pos += 8 * a
    fid = np.asarray(fids, np.int64)
    a = np.asarray(arity, np.int64)[fid] if len(fid) else np.zeros(0, np.int64)
    amax = int(a.max()) if len(a) else 1
    cats = np.zeros((len(fid), amax), np.int64)
    ent = np.repeat(np.arange(len(fid)), a)
    slot = np.arange(int(a.sum())) - np.repeat(np.cumsum(a) - a, a)
    cats[ent, slot] = _get(np.frombuffer(buf, np.uint8),
                           np.asarray(starts, np.int64)[ent] + 8 * slot,
                           fs.BE_I64)
    return fid, cats, np.asarray(wids, np.int32)


def read_domains_flat(path: str):
    """Domains file → flat arrays (d_vid [N], d_card [N], d_sparse [ΣK]).

    The whole file is one big-endian i64 stream: per record
    (vid, card, card × categoryValue).  Record starts form a sequential
    chain (each start depends on the previous card), so a minimal-body
    Python scan finds them; everything else is vectorized numpy."""
    arr = np.fromfile(path, fs.BE_I64).astype(np.int64)
    starts = []
    p, total = 0, len(arr)
    while p < total:
        if p + 2 > total:
            raise ValueError(
                f"truncated domain record header at word {p}/{total}")
        card = int(arr[p + 1])
        if card < 0 or p + 2 + card > total:
            raise ValueError(
                f"domain record at word {p} claims cardinality {card} "
                f"but only {total - p - 2} words remain (corrupt file?)")
        starts.append(p)
        p += 2 + card
    if p != total:
        raise ValueError(f"domains file truncated at word {p}/{total}")
    starts = np.asarray(starts, np.int64)
    d_vid = arr[starts]
    d_card = arr[starts + 1]
    mask = np.ones(total, bool)
    mask[starts] = False
    mask[starts + 1] = False
    return d_vid, d_card, arr[mask]


def read_domains(path: str) -> Dict[int, np.ndarray]:
    d_vid, d_card, d_sparse = read_domains_flat(path)
    splits = np.split(d_sparse, np.cumsum(d_card)[:-1])
    return {int(v): s for v, s in zip(d_vid, splits)}


def _sparse_to_dense_bulk(d_vid, d_card, d_sparse, q_vid, q_sval):
    """Vectorized (vid, sparseValue) → dense index translation.

    Pairs with no domain entry keep their original value."""
    if len(q_vid) == 0:
        return np.asarray(q_sval, np.int64)
    d_vidrep = np.repeat(d_vid, d_card)
    total = len(d_sparse)
    offs = np.concatenate([[0], np.cumsum(d_card)[:-1]])
    d_dense = np.arange(total, dtype=np.int64) - np.repeat(offs, d_card)
    # composite 1-D key: rank the sparse values so vid*R + rank can't collide
    us = np.unique(np.concatenate([d_sparse, q_sval]))
    R = len(us)
    key_d = d_vidrep * R + np.searchsorted(us, d_sparse)
    key_q = np.asarray(q_vid, np.int64) * R + np.searchsorted(us, q_sval)
    order = np.argsort(key_d, kind="stable")
    kd, dd = key_d[order], d_dense[order]
    pos = np.searchsorted(kd, key_q)
    pos_c = np.minimum(pos, len(kd) - 1)
    hit = kd[pos_c] == key_q
    return np.where(hit, dd[pos_c], np.asarray(q_sval, np.int64))


def read_meta(path: str):
    with open(path) as fp:
        parts = fp.read().strip().split(",")
    counts = dict(zip(["n_weights", "n_vars", "n_factors", "n_edges"],
                      map(int, parts[:4])))
    files = dict(zip(["weights", "variables", "factors", "edges"],
                     parts[4:8] + [""] * (8 - len(parts))))
    return counts, files


def load_graph(meta_path: str, domains_path: Optional[str] = None) -> FactorGraph:
    """Load a graph from a metadata CSV (paths resolved relative to it)."""
    counts, files = read_meta(meta_path)
    base = os.path.dirname(os.path.abspath(meta_path))
    rel = lambda p: p if os.path.isabs(p) else os.path.join(base, p)

    w_init, w_fixed = read_weights(rel(files["weights"]))
    role, init_sparse, dtype, card = read_variables(rel(files["variables"]))
    if files["edges"]:
        # old two-file revision: a non-empty edges entry means the factors
        # file has NO inline member list — parsing it with the new-format
        # reader would decode garbage
        f_type, f_wid, f_feat, f_ptr, e_vid, e_ispos, e_eq = \
            read_factors_old(rel(files["factors"]), rel(files["edges"]))
    else:
        f_type, f_wid, f_feat, f_ptr, e_vid, e_ispos, e_eq = read_factors(
            rel(files["factors"]))

    domains = None
    dflat = None
    if domains_path and os.path.exists(domains_path):
        dflat = read_domains_flat(domains_path)
        d_vid, d_card, d_sparse = dflat
        splits = np.split(d_sparse, np.cumsum(d_card)[:-1])
        domains = {int(v): s for v, s in zip(d_vid, splits)}

    # translate sparse category values → dense indices (vectorized)
    var_init = init_sparse.astype(np.int64).copy()
    e_eqpred = e_eq.copy()
    if dflat:
        var_init[d_vid] = _sparse_to_dense_bulk(*dflat, d_vid,
                                                var_init[d_vid])
        e_eqpred = _sparse_to_dense_bulk(*dflat, e_vid.astype(np.int64),
                                         e_eq)

    # optional sparse per-combination weights (sibling .cweights file)
    cw = {}
    cw_path = rel(files["factors"]) + ".cweights"
    if os.path.exists(cw_path):
        arity = np.diff(f_ptr)
        cw_fid, cw_cats_sp, cw_wid = read_comb_weights(cw_path, arity)
        cw_cats = cw_cats_sp.copy()
        if dflat:
            Amax = cw_cats.shape[1]
            slot = f_ptr[cw_fid][:, None] + np.arange(Amax)[None, :]
            valid = np.arange(Amax)[None, :] < arity[cw_fid][:, None]
            slot_vid = e_vid[np.minimum(slot, len(e_vid) - 1)]
            tr = _sparse_to_dense_bulk(
                *dflat, slot_vid[valid].astype(np.int64), cw_cats[valid])
            cw_cats[valid] = tr
        cw = dict(cw_fid=cw_fid, cw_cats=cw_cats.astype(np.int32),
                  cw_wid=cw_wid)

    g = FactorGraph(
        **cw,
        var_dtype=dtype,
        var_role=role,
        var_init=var_init.astype(np.int32),
        var_card=card,
        w_init=w_init,
        w_fixed=w_fixed,
        f_type=f_type,
        f_wid=f_wid,
        f_feat=f_feat,
        f_ptr=f_ptr,
        e_vid=e_vid.astype(np.int32),
        e_ispos=e_ispos,
        e_eqpred=e_eqpred.astype(np.int32),
        domains=domains,
    )
    g.validate()
    for name, want, got in [("weights", counts["n_weights"], g.n_weights),
                            ("variables", counts["n_vars"], g.n_vars),
                            ("factors", counts["n_factors"], g.n_factors),
                            ("edges", counts["n_edges"], g.n_edges)]:
        if want != got:
            raise ValueError(f"metadata says {want} {name}, files have {got}")
    return g


# ---------------------------------------------------------------------------
# dense -> sparse category values (through graph.domains)
# ---------------------------------------------------------------------------

def _dense_to_sparse(graph: FactorGraph, vid, dense) -> np.ndarray:
    """The sparse category value of each (variable, dense index) pair:
    ``graph.domains[vid][dense]`` where the variable has a domain, else
    the dense index itself."""
    out = np.asarray(dense, np.int64).copy()
    if not graph.domains:
        return out
    dvid = np.array(sorted(graph.domains), np.int64)
    vals = [np.asarray(graph.domains[int(v)], np.int64) for v in dvid]
    lens = np.array([len(v) for v in vals], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.concatenate(vals) if vals else np.zeros(0, np.int64)
    vid = np.asarray(vid, np.int64)
    k = np.minimum(np.searchsorted(dvid, vid), len(dvid) - 1)
    hit = dvid[k] == vid
    idx = out[hit]
    if ((idx < -lens[k[hit]]) | (idx >= lens[k[hit]])).any():
        raise IndexError("a dense category index lies outside its domain")
    out[hit] = flat[offs[k[hit]] + np.where(idx < 0, idx + lens[k[hit]],
                                            idx)]
    return out
