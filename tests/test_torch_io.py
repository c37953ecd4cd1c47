"""The port's binary and text I/O (sampler_tpu_torch/io) against the JAX
package's (sampler_tpu/io), on graphs built from the same seeds in both.

  * files written by the JAX writer load into the same arrays through the
    port's load_graph as through JAX's (Ising grid, a categorical graph
    with domains, the sparse-weight graph, the old two-file format);
  * the port's writer gives the JAX writer's bytes, file by file;
  * the vectorised read_factors equals the record-by-record loop;
  * truncated and corrupt factors, domains and .cweights files raise the
    JAX Python reader's errors, at the same byte offsets;
  * text2bin and bin2text give the JAX command line's bytes.
"""
import os

import numpy as np
import pytest

from sampler_tpu import fixtures as jfx
from sampler_tpu import format_spec as jfs
from sampler_tpu.benchgraphs import random_kbc_graph as jax_kbc
from sampler_tpu.cli import main as jax_main
from sampler_tpu.graph import FactorGraph as JaxFactorGraph
from sampler_tpu.io import binary as jb
from sampler_tpu.io import text as jtext
from sampler_tpu_torch import FactorGraph
from sampler_tpu_torch import fixtures as tfx
from sampler_tpu_torch import format_spec as tfs
from sampler_tpu_torch.benchgraphs import random_kbc_graph as torch_kbc
from sampler_tpu_torch.cli import main as torch_main
from sampler_tpu_torch.io import binary as tb


@pytest.fixture(autouse=True)
def _python_reader(monkeypatch):
    """The JAX reader's own Python loop, not its native parser: the loop
    is the error contract the port keeps."""
    monkeypatch.setenv("SAMPLER_TPU_NATIVE", "0")


def _with_domains(fx, fg, f):
    g = fx.categorical_graph(seed=3, n=6, card=4)
    rng = np.random.default_rng(3)
    g.domains = {v: np.sort(rng.choice(1000, 4, replace=False)).astype(
        np.int64) for v in (0, 2, 5)}
    return g


def _sparse_with_domains(fx, fg, f):
    g = fx.sparse_categorical_graph(seed=1, n=5)
    g.domains = {1: np.asarray([7, 70, 700], np.int64),
                 4: np.asarray([-3, 5, 9], np.int64)}
    return g


# name -> (graph maker over (fixtures, FactorGraph, format_spec), old format)
GRAPHS = {
    "ising_grid": (lambda fx, fg, f: fx.ising_grid(3, 4), False),
    "all_functions": (lambda fx, fg, f: fx.all_functions_graph(n=8), False),
    "categorical_domains": (_with_domains, False),
    "sparse": (lambda fx, fg, f: fx.sparse_categorical_graph(), False),
    "sparse_domains": (_sparse_with_domains, False),
    "mixed": (lambda fx, fg, f: fx.mixed_graph(), False),
    "old_format": (lambda fx, fg, f: fx.all_functions_graph(n=8), True),
    "old_format_domains": (_with_domains, True),
}


def _pair(name):
    make, old = GRAPHS[name]
    return (make(jfx, JaxFactorGraph, jfs), make(tfx, FactorGraph, tfs), old)


def _assert_graphs_equal(a, b):
    for field in ("var_dtype", "var_role", "var_init", "var_card", "w_init",
                  "w_fixed", "f_type", "f_wid", "f_feat", "f_ptr", "e_vid",
                  "e_ispos", "e_eqpred", "cw_fid", "cw_cats", "cw_wid"):
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            assert x is None and y is None, field
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert (a.domains is None) == (b.domains is None)
    for v in a.domains or {}:
        assert np.array_equal(a.domains[v], b.domains[v])
    assert sorted(a.domains or {}) == sorted(b.domains or {})


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_jax_files_load_equal(name, tmp_path):
    jg, _, old = _pair(name)
    meta = jb.write_graph(jg, str(tmp_path), old_format=old)
    dom = str(tmp_path / "graph.domains")
    _assert_graphs_equal(tb.load_graph(meta, domains_path=dom),
                         jb.load_graph(meta, domains_path=dom))


@pytest.mark.parametrize("name", sorted(GRAPHS) + ["kbc"])
def test_writer_gives_jax_bytes(name, tmp_path):
    if name == "kbc":
        kw = dict(max_arity=3, n_weights=50, seed=2, skew=1.1, window=200)
        jg, tg, old = jax_kbc(600, 1800, **kw), torch_kbc(600, 1800, **kw), \
            False
    else:
        jg, tg, old = _pair(name)
    ja, ta = tmp_path / "jax", tmp_path / "torch"
    jb.write_graph(jg, str(ja), old_format=old)
    tb.write_graph(tg, str(ta), old_format=old)
    names = sorted(os.listdir(ja))
    assert names == sorted(os.listdir(ta))
    for fname in names:
        a, b = (ja / fname).read_bytes(), (ta / fname).read_bytes()
        if fname.endswith(".meta"):
            a = a.replace(str(ja).encode(), b"")
            b = b.replace(str(ta).encode(), b"")
        assert a == b, fname


@pytest.mark.parametrize("name", ["all_functions", "sparse_domains", "kbc",
                                  "empty"])
def test_read_factors_matches_loop(name, tmp_path):
    path = str(tmp_path / "g.factors")
    if name == "kbc":
        tb.write_factors(torch_kbc(3000, 9000, max_arity=4, n_weights=100,
                                   seed=5), path)
    elif name == "empty":
        open(path, "wb").close()
    else:
        tb.write_factors(GRAPHS[name][0](tfx, FactorGraph, tfs), path)
    fast, loop = tb.read_factors(path), tb.read_factors_loop(path)
    jax = jb.read_factors(path)
    for a, b, c in zip(fast, loop, jax):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)


def _error(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_truncated_factors_raise_at_jax_offsets(tmp_path):
    """Every cut of the file: at a record boundary all three readers agree
    on the records; elsewhere they raise the same message."""
    full = tmp_path / "g.factors"
    jb.write_factors(jfx.all_functions_graph(n=6), str(full))
    raw = full.read_bytes()
    bad = str(tmp_path / "bad.factors")
    raised = 0
    for cut in range(1, len(raw)):
        with open(bad, "wb") as fp:
            fp.write(raw[:cut])
        try:
            ref = jb.read_factors(bad)
        except ValueError as e:
            assert _error(tb.read_factors, bad) == str(e), cut
            assert _error(tb.read_factors_loop, bad) == str(e), cut
            raised += 1
            continue
        for a, b in zip(tb.read_factors(bad), ref):
            assert np.array_equal(a, b), cut
    assert raised > len(raw) // 2


@pytest.mark.parametrize("arity", [1 << 40, -4, 10**9])
def test_corrupt_arity_raises_like_jax(tmp_path, arity):
    full = tmp_path / "g.factors"
    jb.write_factors(jfx.all_functions_graph(n=6), str(full))
    corrupt = bytearray(full.read_bytes())
    corrupt[2:10] = arity.to_bytes(8, "big", signed=True)
    bad = str(tmp_path / "arity.factors")
    with open(bad, "wb") as fp:
        fp.write(bytes(corrupt))
    want = _error(jb.read_factors, bad)
    assert _error(tb.read_factors, bad) == want
    assert _error(tb.read_factors_loop, bad) == want


def test_truncated_domains_raise_like_jax(tmp_path):
    g = _with_domains(jfx, JaxFactorGraph, jfs)
    path = str(tmp_path / "g.domains")
    jb.write_domains(g, path)
    tb.write_domains(_with_domains(tfx, FactorGraph, tfs),
                     str(tmp_path / "t.domains"))
    raw = open(path, "rb").read()
    assert (tmp_path / "t.domains").read_bytes() == raw
    bad = str(tmp_path / "bad.domains")
    arr = np.frombuffer(raw, jfs.BE_I64).copy()
    arr[1] = 1 << 30
    for data in (raw[:-8], raw[:-16], raw[:8], arr.astype(jfs.BE_I64)
                 .tobytes()):
        with open(bad, "wb") as fp:
            fp.write(data)
        assert _error(tb.read_domains, bad) == _error(jb.read_domains, bad)


def test_truncated_cweights_raise_like_jax(tmp_path):
    def build(fg, f):
        return fg.build(
            var_card=[3, 2, 4],
            factors=[(f.FUNC_AND_CATEGORICAL, 0, 1.0,
                      [(0, True, 0), (1, True, 0)],
                      [((0, 1), 1), ((2, 0), 2)]),
                     (f.FUNC_AND_CATEGORICAL, 0, 1.0, [(2, True, 0)],
                      [((3,), 0), ((1,), 2)])],
            weights=[0.0, 0.5, -0.5])
    jg, tg = build(JaxFactorGraph, jfs), build(FactorGraph, tfs)
    path = str(tmp_path / "g.cweights")
    jb.write_comb_weights(jg, path)
    tb.write_comb_weights(tg, str(tmp_path / "t.cweights"))
    raw = open(path, "rb").read()
    assert (tmp_path / "t.cweights").read_bytes() == raw
    for a, b in zip(tb.read_comb_weights(path, tg.arities()),
                    jb.read_comb_weights(path, jg.arities())):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bad = str(tmp_path / "bad.cweights")
    arr = bytearray(raw)
    arr[0:8] = (99).to_bytes(8, "big")
    for data in [raw[:cut] for cut in range(1, len(raw))] + [bytes(arr)]:
        with open(bad, "wb") as fp:
            fp.write(data)
        try:
            ref = jb.read_comb_weights(bad, jg.arities())
        except ValueError as e:
            assert _error(tb.read_comb_weights, bad, tg.arities()) == str(e)
            continue
        for a, b in zip(tb.read_comb_weights(bad, tg.arities()), ref):
            assert np.array_equal(a, b)


def test_unknown_role_rejected_like_jax(tmp_path):
    meta = jb.write_graph(jfx.all_functions_graph(n=4), str(tmp_path))
    vf = str(tmp_path / "graph.variables")
    rec = np.fromfile(vf, jfs.VARIABLE_RECORD).copy()
    rec["role"][0] = 9
    rec.tofile(vf)
    assert _error(tb.load_graph, meta) == _error(jb.load_graph, meta)


@pytest.mark.parametrize("relation", ["weight", "variable", "factor",
                                      "domain"])
def test_text2bin_bin2text_give_jax_bytes(relation, tmp_path):
    g = _with_domains(jfx, JaxFactorGraph, jfs)
    g.f_feat = g.f_feat * 0.37           # features that need 17 digits
    lines = jtext.graph_to_text(g)[relation + "s"]
    tsv = tmp_path / "in.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    out = {}
    for label, main in (("jax", jax_main), ("torch", torch_main)):
        binf = tmp_path / f"{label}.bin"
        assert main(["text2bin", relation, str(tsv), str(binf)]) == 0
        back = tmp_path / f"{label}.tsv"
        assert main(["bin2text", relation, str(binf), str(back)]) == 0
        out[label] = (binf.read_bytes(), back.read_bytes())
    assert out["torch"] == out["jax"]
    assert out["torch"][1].decode().strip() == tsv.read_text().strip()
