"""The port's host compile against the JAX package's.

sampler_tpu_torch.compile is a copy of sampler_tpu.compile (its native
stream fill is held to its numpy route in tests/test_torch_native.py): on
the same graph and coloring both must give array-equal streams and equal
static info.  from_jax carries
a JAX-compiled graph across unchanged.
"""
import dataclasses

import numpy as np
import pytest
import torch

import sampler_tpu.compile as jc
from sampler_tpu import benchgraphs as jbg
from sampler_tpu import fixtures as jfx
from sampler_tpu_torch import compile as tc
from sampler_tpu_torch.coloring import greedy_coloring, validate_coloring
from sampler_tpu_torch.convert import from_jax

BANDED = dict(band_tile=8, band_min_block=1)


CASES = {
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
}


def _compile_both(name):
    make, kw = CASES[name]
    g = make()
    colors = greedy_coloring(g)
    validate_coloring(g, colors)
    return (jc.compile_graph(g, colors=colors, **kw),
            tc.compile_graph(g, colors=colors, **kw))


def _assert_graphs_equal(a, b):
    for f in tc.DeviceGraph._fields:
        if f == "tiers":
            continue
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert len(a.tiers) == len(b.tiers)
    for t, (ta, tb) in enumerate(zip(a.tiers, b.tiers)):
        for f in tc.TierStreams._fields:
            x, y = np.asarray(getattr(ta, f)), np.asarray(getattr(tb, f))
            assert x.dtype == y.dtype, (t, f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"tier{t}.{f}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_streams_array_equal(name):
    (jdg, jinfo), (tdg, tinfo) = _compile_both(name)
    _assert_graphs_equal(jdg, tdg)
    assert dataclasses.asdict(jinfo) == dataclasses.asdict(tinfo)


@pytest.mark.parametrize("name", ["all_functions", "ising_16x16_banded"])
def test_from_jax_round_trip(name):
    (jdg, jinfo), (tdg, tinfo) = _compile_both(name)
    cdg, cinfo = from_jax(jdg, jinfo)
    assert cinfo == tinfo
    _assert_graphs_equal(cdg, tdg)
    # flat device arrays (the JAX package's at-rest layout) carry over too
    flat = from_jax(jc.flatten_streams(jdg), jinfo)[0]
    a, b = tc.to_device(flat, "cpu"), tc.to_device(tdg, "cpu")
    for ta, tb in zip(a.tiers, b.tiers):
        for f in tc.TierStreams._fields:
            assert torch.equal(getattr(ta, f), getattr(tb, f)), f


def test_greedy_coloring_is_proper():
    g = jfx.random_boolean_graph(60, 90, seed=1)
    validate_coloring(g, greedy_coloring(g))


def test_to_device_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dg, _ = tc.compile_graph(jfx.biased_coin())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.to_device(dg)
