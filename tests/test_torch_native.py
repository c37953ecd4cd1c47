"""The port's native host library (sampler_tpu_torch/native.py,
csrc/host/sampler_native.cpp) against the JAX package's (sampler_tpu/native)
and against the port's own numpy plain versions.

  * the ABI version string;
  * the native factor-file parse equals the vectorised reader and the JAX
    package's native parse; malformed and truncated files raise the
    vectorised reader's byte-offset messages;
  * the default greedy coloring equals the JAX package's default (its
    native colorer) on KBC-shaped graphs, where the numpy colorer gives
    another proper coloring, and on the fixtures graphs; the numpy routes
    of both packages agree too;
  * compile_graph's native stream fill equals its numpy route and the JAX
    package's compile_graph, every array exactly;
  * processes that build the library at once all load it, and a failed
    build raises with the compiler's output.

Every comparison is exact (array-equal, dtypes included): both routes do
the same integer and float32 operations.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sampler_tpu.coloring as jcol
import sampler_tpu.compile as jc
from sampler_tpu import benchgraphs as jbg
from sampler_tpu import fixtures as jfx
from sampler_tpu import native as jnative
from sampler_tpu.io import binary as jb
from sampler_tpu_torch import coloring as tcol
from sampler_tpu_torch import compile as tc
from sampler_tpu_torch import native
from sampler_tpu_torch.io import binary as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kbc(n, **kw):
    args = dict(max_arity=3, n_weights=100, seed=0, skew=1.1, window=200)
    args.update(kw)
    return jbg.random_kbc_graph(n, 3 * n, **args)


def test_version_matches_the_jax_library():
    assert native.version() == native.ABI_VERSION == "sampler-native-0.3"
    assert jnative.version() == native.version()


# graphs whose factors files are parsed (categorical ones included)
PARSE_GRAPHS = {
    "biased_coin": lambda: jfx.biased_coin(),
    "ising_grid": lambda: jfx.ising_grid(3, 4),
    "all_functions": lambda: jfx.all_functions_graph(n=8),
    "categorical": lambda: jfx.categorical_graph(seed=3, n=6, card=4),
    "sparse_categorical": lambda: jfx.sparse_categorical_graph(),
    "mixed": lambda: jfx.mixed_graph(),
    "kbc": lambda: jbg.random_kbc_graph(3000, 9000, max_arity=4,
                                        n_weights=100, seed=5),
}


@pytest.mark.parametrize("name", sorted(PARSE_GRAPHS) + ["empty"])
def test_native_parse_equals_vectorised_and_jax(name, tmp_path):
    path = str(tmp_path / "g.factors")
    if name == "empty":
        open(path, "wb").close()
    else:
        jb.write_factors(PARSE_GRAPHS[name](), path)
    raw = open(path, "rb").read()
    nat = native.parse_factors(raw)
    default = tb.read_factors(path)
    plain = tb.read_factors(path, native=False)
    jax = jnative.parse_factors(raw)
    for a, b, c, d in zip(nat, default, plain, jax):
        assert a.dtype == b.dtype == c.dtype == d.dtype
        assert (np.array_equal(a, b) and np.array_equal(a, c)
                and np.array_equal(a, d))


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_truncated_files_raise_the_plain_readers_messages(tmp_path):
    """Every cut of a factors file: the native route returns the plain
    reader's records or raises its message at its byte offset."""
    full = tmp_path / "g.factors"
    jb.write_factors(jfx.all_functions_graph(n=6), str(full))
    raw = full.read_bytes()
    bad = str(tmp_path / "bad.factors")
    raised = 0
    for cut in range(1, len(raw)):
        with open(bad, "wb") as fp:
            fp.write(raw[:cut])
        if native.parse_factors(raw[:cut]) is None:
            want = _error(tb.read_factors, bad, native=False)
            assert _error(tb.read_factors, bad) == want, cut
            assert _error(tb.read_factors_loop, bad) == want, cut
            raised += 1
            continue
        for a, b in zip(tb.read_factors(bad),
                        tb.read_factors(bad, native=False)):
            assert np.array_equal(a, b), cut
    assert raised > len(raw) // 2


@pytest.mark.parametrize("arity", [1 << 40, -4, 10**9 + 1])
def test_corrupt_arity_raises_the_plain_readers_message(tmp_path, arity):
    full = tmp_path / "g.factors"
    jb.write_factors(jfx.all_functions_graph(n=6), str(full))
    corrupt = bytearray(full.read_bytes())
    corrupt[2:10] = arity.to_bytes(8, "big", signed=True)
    bad = str(tmp_path / "arity.factors")
    with open(bad, "wb") as fp:
        fp.write(bytes(corrupt))
    assert native.parse_factors(bytes(corrupt)) is None
    want = _error(tb.read_factors, bad, native=False)
    assert "byte" in want
    assert _error(tb.read_factors, bad) == want


def test_malformed_bytes_are_refused():
    assert native.parse_factors(b"\x00\x01\x02") is None


# the fault: the port colored with its numpy colorer while the JAX package
# colors natively, and the two colorings differ on KBC-shaped graphs
@pytest.mark.parametrize("n", [300, 5000, 50000])
def test_default_coloring_equals_jax_on_kbc_graphs(n, monkeypatch):
    g = _kbc(n)
    got = tcol.greedy_coloring(g)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jcol.greedy_coloring(g))
    tcol.validate_coloring(g, got)
    plain = tcol.greedy_coloring(g, native=False)
    tcol.validate_coloring(g, plain)
    monkeypatch.setenv("SAMPLER_TPU_NATIVE", "0")
    np.testing.assert_array_equal(plain, jcol.greedy_coloring(g))


@pytest.mark.parametrize("name", ["biased_coin", "ising_chain", "ising_grid",
                                  "all_functions_graph", "categorical_graph",
                                  "sparse_categorical_graph", "mixed_graph",
                                  "labeled_coin_graph"])
def test_default_coloring_equals_jax_on_fixtures(name, monkeypatch):
    g = getattr(jfx, name)()
    np.testing.assert_array_equal(tcol.greedy_coloring(g),
                                  jcol.greedy_coloring(g))
    monkeypatch.setenv("SAMPLER_TPU_NATIVE", "0")
    np.testing.assert_array_equal(tcol.greedy_coloring(g, native=False),
                                  jcol.greedy_coloring(g))


def test_compile_graph_colors_natively_by_default():
    g = _kbc(300)
    _, info = tc.compile_graph(g)
    _, info_j = jc.compile_graph(g)
    _, info_p = tc.compile_graph(g, native=False)
    assert dataclasses.asdict(info) == dataclasses.asdict(info_j)
    assert info.n_colors == int(jcol.greedy_coloring(g).max()) + 1
    assert info_p.n_colors == int(
        tcol.greedy_coloring(g, native=False).max()) + 1


BANDED = dict(band_tile=8, band_min_block=1)
# tests/test_torch_compile.py's graphs, a banded affine2 grid and a KBC
# graph with a hub tier
STREAM_CASES = {
    "biased_coin": (lambda: jfx.biased_coin(1.5), {}),
    "ising_chain": (lambda: jfx.ising_chain(8), {}),
    "ising_grid": (lambda: jfx.ising_grid(4, 4), {}),
    "all_functions": (lambda: jfx.all_functions_graph(), {}),
    "categorical": (lambda: jfx.categorical_graph(n=5, card=3), {}),
    "sparse_categorical": (lambda: jfx.sparse_categorical_graph(), {}),
    "mixed": (lambda: jfx.mixed_graph(), {}),
    "random_boolean": (lambda: jfx.random_boolean_graph(40, 60, seed=3), {}),
    "ising_16x16_banded": (lambda: jbg.big_ising_grid(16, 16)[0], BANDED),
    "triple_12x12_banded": (lambda: jbg.big_triple_grid(12, 12)[0], BANDED),
    "potts_12x12_banded": (lambda: jbg.big_potts_grid(12, 12)[0], BANDED),
    "ising_64x64_affine2": (lambda: jbg.big_ising_grid(64, 64)[0], BANDED),
    "kbc_hub": (lambda: _kbc(3000, window=2000),
                dict(band_wmax=32768, hub_cap=16, hub_chunk=8)),
}


def _assert_equal(a, b, what):
    names = [n for n, _ in tc.iter_arrays(a)]
    assert names == [n for n, _ in tc.iter_arrays(b)]
    for (name, x), (_, y) in zip(tc.iter_arrays(a), tc.iter_arrays(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_native_streams_equal_numpy_and_jax(name):
    make, kw = STREAM_CASES[name]
    g = make()
    colors = tcol.greedy_coloring(g)
    if name == "kbc_hub":
        kw = dict(kw, order=tcol.rcm_order(g))
    nat, info = tc.compile_graph(g, colors=colors, **kw)
    plain, info_p = tc.compile_graph(g, colors=colors, native=False, **kw)
    jax, info_j = jc.compile_graph(g, colors=colors, **kw)
    if name == "kbc_hub":
        assert info.has_hub and info.tiers[-1].hub and len(info.tiers) > 2
    if name == "ising_64x64_affine2":
        assert info.affine2 and info.tiers[0].band_w > 0
    assert dataclasses.asdict(info) == dataclasses.asdict(info_p) \
        == dataclasses.asdict(info_j)
    _assert_equal(nat, plain, "native vs numpy")
    _assert_equal(nat, jax, "native vs JAX")


def test_build_streams_refuses_a_wrong_dtype():
    outs = {"cs_nbr": np.zeros((1, 1, 1), np.int64)}
    with pytest.raises(TypeError):
        native.build_streams(np.zeros((1, 1), np.int32),
                             np.zeros((2, 2), np.int32), None, None, None,
                             None, None, None, None, None, None, outs, 3, 2,
                             False, 2, (1, 1, 0))


_BUILD = ("import sys\n"
          "import sampler_tpu_torch.native as n\n"
          "n.BUILD_DIR = sys.argv[1]\n"
          "lib, seconds = n.build()\n"
          "print(n.version(), seconds > 0)\n")


def test_concurrent_builds_all_load(tmp_path):
    """Three processes build the library into one empty directory at
    once: each loads a whole library (written under its own name, then
    renamed into place), and no temporary file is left."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.split()[0] == native.ABI_VERSION, out
    files = sorted(os.listdir(tmp_path))
    assert files == [os.path.basename(native.library_path())], files


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build.__wrapped__()
    assert os.listdir(tmp_path / "build") == []
