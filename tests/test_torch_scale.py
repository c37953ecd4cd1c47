"""The port's large-graph entry points and observability helpers against
the JAX package's, on the CPU at small sizes:

  * memory_budget and iter_arrays equal sampler_tpu's, field by field, on
    a 64x64 grid and a small KBC graph;
  * scale_demo.main runs on four CPU graph ranks and keeps
    tests/test_scale.py's keys and halo assertions;
  * scale_gpu.main and scale_kbc.main run end to end with --device cpu
    and print the JAX modules' keys;
  * observe's statistics equal sampler_tpu.observe's within 1e-12 (float64
    sums in another order: a few ulps) on numpy and torch inputs.
"""
import json

import numpy as np
import pytest
import torch

from sampler_tpu import benchgraphs as jbg
from sampler_tpu import observe as jobs
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import iter_arrays as jax_iter_arrays
from sampler_tpu.scale_demo import memory_budget as jax_memory_budget
from sampler_tpu_torch import observe, scale_demo, scale_gpu, scale_kbc
from sampler_tpu_torch.coloring import greedy_coloring, rcm_order
from sampler_tpu_torch.compile import compile_graph, iter_arrays, to_device

OBSERVE_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs(name):
    if name == "grid64":
        g, colors = jbg.big_ising_grid(64, 64)
        return g, dict(colors=colors)
    g = jbg.random_kbc_graph(3000, 9000, max_arity=3, n_weights=100, seed=0,
                             skew=1.1, window=2000)
    return g, dict(colors=greedy_coloring(g), order=rcm_order(g),
                   band_wmax=32768, hub_cap=16, hub_chunk=8)


@pytest.mark.parametrize("name", ["grid64", "kbc"])
def test_memory_budget_and_iter_arrays_equal_jax(name):
    g, kw = _graphs(name)
    dg, info = compile_graph(g, **kw)
    jdg, jinfo = jax_compile(g, **kw)
    ours, theirs = list(iter_arrays(dg)), list(jax_iter_arrays(jdg))
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    for (n, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)
    budget = scale_demo.memory_budget(dg, info)
    assert budget == jax_memory_budget(jdg, jinfo)
    # the placed tensors count the same bytes
    assert scale_demo.memory_budget(to_device(dg, "cpu"), info) == budget


def test_scale_demo_pipeline_on_cpu_ranks():
    out = scale_demo.main(["--rows", "128", "--cols", "128", "--graph-axis",
                           "4", "--sweeps", "2", "--device", "cpu"])
    assert {"n_vars", "n_factors", "gen_s", "compile_s", "run_s",
            "updates_per_s", "mesh", "halo", "band_w",
            "memory"} <= set(out)
    assert out["n_vars"] == 128 * 128
    assert out["updates_per_s"] > 0
    assert out["mesh"] == {"chains": 1, "graph": 4}
    assert out["backend"] == "gloo"
    # banding must engage at this size and the halo must beat all_gather
    assert out["band_w"] > 0
    assert out["halo"] is not None and sum(out["halo"]) < 4 - 1
    assert out["memory"]["bytes_per_var"] < 425
    assert out["memory"]["sharded_bytes_per_var"] \
        < out["memory"]["bytes_per_var"]
    assert out["card"] is None


def test_scale_gpu_runs_on_cpu(capsys):
    out = scale_gpu.main(["--rows", "128", "--cols", "128", "--chains", "16",
                          "--sweeps", "2", "--outer", "2", "--device",
                          "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    # scale_tpu.py's keys (its hbm: device memory, None on the CPU)
    assert {"device", "n_vars", "n_factors", "chains", "sweeps",
            "band_w", "gen_s", "compile_s", "warm_s", "run_s",
            "updates_per_s", "memory", "hbm"} <= set(out)
    assert out["n_vars"] == 128 * 128 and out["sweeps"] == 4
    assert "modes" not in out and out["band_w"] > 0
    assert out["hbm"] is None and out["card"] is None
    assert out["world_elements"] > 128 * 128 * 16


def test_scale_gpu_drops_only_gradient_streams():
    g, colors = jbg.big_ising_grid(64, 64)
    dg, info = compile_graph(g, colors=colors)
    lean = scale_gpu.drop_gradient_streams(dg, info)
    for ts, lt in zip(dg.tiers, lean.tiers):
        for f in ts._fields:
            a, b = getattr(ts, f), getattr(lt, f)
            assert a.dtype == b.dtype, f
            if f in scale_gpu.GRADIENT_ONLY:
                assert b.shape == (info.n_colors, 1, 1), f
            else:
                assert b is a, f


def test_scale_kbc_runs_on_cpu():
    out = scale_kbc.main(["--vars", "5000", "--chains", "16", "--hub-cap",
                          "16", "--device", "cpu"])
    # KBC_SCALE.json's keys
    assert {"device", "n_vars", "n_factors", "n_colors", "n_tiers",
            "has_hub", "hub_cap", "chains", "sweeps", "gen_s",
            "compile_s", "warm_s", "run_s", "updates_per_s",
            "vs_north_star"} <= set(out)
    assert out["n_vars"] == 5000 and out["n_factors"] == 15000
    assert out["has_hub"] and out["sweeps"] == 10
    assert "modes" not in out
    assert out["world_bytes"] > 5000 * 16


def test_observe_equals_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=37)
    m = rng.dirichlet(np.ones(3), size=50)
    for ww, mm in ((w, m), (torch.from_numpy(w), torch.from_numpy(m)),
                   (w.astype(np.float32), m.astype(np.float32))):
        ours, ref = observe.weight_stats(ww), jobs.weight_stats(np.asarray(ww))
        assert ours.keys() == ref.keys()
        for k in ours:
            assert abs(ours[k] - ref[k]) <= OBSERVE_TOL, k
        assert abs(observe.marginal_entropy(mm)
                   - jobs.marginal_entropy(np.asarray(mm))) <= OBSERVE_TOL
    assert observe.weight_stats(np.zeros(0)) == jobs.weight_stats(np.zeros(0))
    assert observe.throughput(1000, 20, 512, 0.5) \
        == jobs.throughput(1000, 20, 512, 0.5)
