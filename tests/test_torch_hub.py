"""The port's chunked-CSR hub tier and rcm_order against the JAX package.

tests/test_hub.py's checks, on the port, minus its two graph-sharded
tests (graph sharding is not ported):

  * compile_graph's hub streams (hb_row and the chunked cs_* records
    [C, M, G, A]) and every other stream are array-equal to the JAX
    package's on the star graphs and on small random_kbc_graphs;
  * rcm_order (scipy's reverse Cuthill-McKee) and its BFS fallback give
    the JAX package's ranks;
  * inference through hub_color_draw matches exact enumeration: |dp| <
    0.01 on the boolean star, 0.012 on the card-3 star (JAX's bounds);
  * the chunked cs-stream gradient over dense and hub tiers equals the
    per-factor gradient and JAX's mc_weight_gradient_cs within 1e-4;
  * learning on a hub graph is deterministic under one generator;
  * the padded stream volume stays O(edges);
  * compile_graph takes bench.py's KBC shape (skew 1.1, hub_cap 256) at
    20,000 variables.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import coloring as jax_coloring
from sampler_tpu.benchgraphs import random_kbc_graph as jax_kbc_graph
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu.graph import FactorGraph as JaxFactorGraph
from sampler_tpu_torch import FactorGraph, oracle
from sampler_tpu_torch import coloring
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch.benchgraphs import random_kbc_graph
from sampler_tpu_torch.coloring import greedy_coloring, rcm_order
from sampler_tpu_torch.compile import compile_graph, to_device
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.engine.learn import LearnConfig

PLAIN = ("off", "off")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _star_graph(graph_cls=FactorGraph, n_leaves=14, w_pair=0.4, w_bias=0.3,
                card=2, seed=0):
    """tests/test_hub.py's star: one hub and n_leaves leaves, hub-leaf
    EQUAL couplings and ISTRUE biases; the hub's degree is n_leaves + 1."""
    rng = np.random.default_rng(seed)
    V = n_leaves + 1
    factors = [(fs.FUNC_ISTRUE, 0, 1.0, [(v, True)]) for v in range(V)]
    factors += [(fs.FUNC_EQUAL, 1, 1.0, [(0, True), (v, True)])
                for v in range(1, V)]
    g = graph_cls.build(var_card=[card] * V, weights=[w_bias, w_pair],
                        factors=factors)
    if card > 2:
        g.var_dtype[:] = fs.DTYPE_CATEGORICAL
        g.e_eqpred[:] = rng.integers(0, card, g.n_edges)
    return g


KBC = dict(max_arity=3, n_weights=11, seed=3, skew=1.2, evidence_frac=0.3)

# name -> (graph of a class, compile kwargs)
CASES = {
    "star_bool": (lambda cls: _star_graph(cls, n_leaves=14),
                  dict(hub_cap=6, hub_chunk=4)),
    "star_cat3": (lambda cls: _star_graph(cls, n_leaves=12, card=3, seed=4),
                  dict(hub_cap=5, hub_chunk=4)),
    "kbc300": ("kbc", dict(hub_cap=8, hub_chunk=4)),
    "kbc300_rcm": ("kbc", dict(hub_cap=8, hub_chunk=4, rcm=True)),
    "kbc4000": ("kbc4000", dict(hub_cap=64, hub_chunk=32)),
}


def _pair(name):
    """(port graph, JAX graph, compile kwargs) of one case."""
    make, kw = CASES[name]
    if make == "kbc":
        return (random_kbc_graph(300, 900, **KBC),
                jax_kbc_graph(300, 900, **KBC), dict(kw))
    if make == "kbc4000":
        args = dict(max_arity=3, n_weights=50, seed=1, skew=1.3)
        return (random_kbc_graph(4000, 12000, **args),
                jax_kbc_graph(4000, 12000, **args), dict(kw))
    return make(FactorGraph), make(JaxFactorGraph), dict(kw)


@pytest.mark.parametrize("name", list(CASES))
def test_hub_streams_equal_jax(name):
    g, gj, kw = _pair(name)
    colors = greedy_coloring(g)
    if kw.pop("rcm", False):
        kw["order"] = rcm_order(g)
    dg, info = compile_graph(g, colors=colors, **kw)
    dgj, infoj = jax_compile(gj, colors=colors, **kw)
    assert info.has_hub and info.tiers[-1].hub
    assert dataclasses.asdict(info) == dataclasses.asdict(infoj)
    for ts, tsj in zip(dg.tiers, dgj.tiers):
        for f in ts._fields:
            a, b = getattr(ts, f), np.asarray(getattr(tsj, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in dg._fields:
        if f != "tiers":
            np.testing.assert_array_equal(getattr(dg, f),
                                          np.asarray(getattr(dgj, f)),
                                          err_msg=f)


@pytest.mark.parametrize("scramble", [False, True])
def test_rcm_order_equals_jax(scramble):
    kw = dict(max_arity=3, n_weights=20, seed=5, skew=1.1, window=50,
              scramble=scramble)
    g = random_kbc_graph(3000, 9000, **kw)
    gj = jax_kbc_graph(3000, 9000, **kw)
    rank = rcm_order(g)
    np.testing.assert_array_equal(rank, jax_coloring.rcm_order(gj))
    assert sorted(rank.tolist()) == list(range(g.n_vars))


def test_bfs_order_equals_jax():
    g = random_kbc_graph(2000, 5000, max_arity=3, n_weights=20, seed=6,
                         skew=1.1, window=40)
    indptr, indices = coloring.variable_adjacency(g)
    got = coloring._bfs_order(indptr, indices, g.n_vars)
    np.testing.assert_array_equal(
        got, jax_coloring._bfs_order(indptr, indices, g.n_vars))
    assert sorted(got.tolist()) == list(range(g.n_vars))


@pytest.mark.parametrize("modes", [None, PLAIN], ids=["default", "plain"])
def test_hub_tier_engages_and_matches_oracle(modes):
    g = _star_graph(n_leaves=14)
    colors = greedy_coloring(g)
    coloring.validate_coloring(g, colors)
    dg, info = compile_graph(g, colors=colors, hub_cap=6, hub_chunk=4)
    assert info.has_hub and info.tiers[-1].hub
    assert info.tiers[-1].chunk_g == 4
    d = to_device(dg, "cpu")
    marg, _ = tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(0),
                           200, 4000, info, 8, modes=modes, device="cpu")
    err = np.abs(marg - oracle.exact_marginals(g)).max()
    assert err < 0.01, f"hub marginal error {err}"


def test_hub_tier_categorical_oracle():
    g = _star_graph(n_leaves=12, card=3, seed=4)
    dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=5,
                             hub_chunk=4)
    assert info.has_hub and not info.all_boolean
    d = to_device(dg, "cpu")
    marg, _ = tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(1),
                           200, 4000, info, 8, modes=PLAIN, device="cpu")
    err = np.abs(marg - oracle.exact_marginals(g)).max()
    assert err < 0.012, f"hub categorical marginal error {err}"


def test_hub_draw_writes_only_selected_rows():
    """hub_color_draw's rows are the hub tier's block; the sweep writes
    them under the resample mask, so evidence rows keep their labels."""
    g = _star_graph(n_leaves=14, seed=9)
    g.var_role[0] = fs.ROLE_EVIDENCE
    g.var_init[0] = 1
    dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=6,
                             hub_chunk=4)
    d = to_device(dg, "cpu")
    ti, ts = info.tiers[-1], d.tiers[-1]
    pos = int(d.pos_of_vid[0])
    c = pos // info.block_size
    assert pos - c * info.block_size >= ti.off          # the hub's row
    gen = torch.Generator().manual_seed(3)
    v = tmc.init_values_mc(d, gen, 16, info)
    drawn = tmc.hub_color_draw(d, ts, ti, v, d.w_init, gen, c, info)
    assert drawn.shape == (ti.block, 16)
    assert bool(((drawn == 0) | (drawn == 1)).all())
    out = tmc.run_sweeps_mc(d, v, d.w_init, gen, 5, False, info,
                            device="cpu")
    assert bool((out[pos] == 1).all())


@pytest.fixture(scope="module")
def kbc_worlds():
    g = random_kbc_graph(300, 900, **KBC)
    gj = jax_kbc_graph(300, 900, **KBC)
    colors = greedy_coloring(g)
    dg, info = compile_graph(g, colors=colors, hub_cap=8, hub_chunk=4)
    dgj, infoj = jax_compile(gj, colors=colors, hub_cap=8, hub_chunk=4)
    assert info.has_hub
    d = to_device(dg, "cpu")
    gen = torch.Generator().manual_seed(7)
    v_ev = tmc.init_values_mc(d, gen, 3, info)
    v_free = tmc.init_values_mc(d, gen, 3, info)
    return d, info, jax_to_device(dgj), infoj, v_ev, v_free


@pytest.mark.parametrize("learn_non_evidence", [False, True])
def test_hub_gradient_matches_per_factor_and_jax(kbc_worlds,
                                                 learn_non_evidence):
    """cs-stream gradient over dense and hub tiers == the per-factor
    gradient (owner dedup counts every factor once even when its owner
    record lives in a hub chunk) and == JAX's, within 1e-4."""
    d, info, dj, infoj, v_ev, v_free = kbc_worlds
    g_cs = tmc.mc_weight_gradient_cs(d, v_ev, v_free, learn_non_evidence,
                                     info, PLAIN)
    g_ref = tmc.mc_weight_gradient(d, v_ev, v_free, learn_non_evidence,
                                   info, modes=None)
    g_jax = jmc.mc_weight_gradient_cs(dj, jnp.asarray(v_ev.numpy()),
                                      jnp.asarray(v_free.numpy()),
                                      learn_non_evidence, infoj, PLAIN)
    assert float(g_cs.abs().max()) > 0.1
    np.testing.assert_allclose(g_cs.numpy(), g_ref.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(g_cs.numpy(), np.asarray(g_jax), rtol=0,
                               atol=1e-4)


def test_hub_gradient_row_chunks_agree(kbc_worlds):
    """The hub tier's chunks give the same gradient in row chunks of one
    chunk as all at once."""
    d, info, _, _, v_ev, v_free = kbc_worlds
    whole = tmc.mc_weight_gradient_cs(d, v_ev, v_free, False, info, PLAIN)
    one = tmc.mc_weight_gradient_cs(d, v_ev, v_free, False, info, PLAIN,
                                    row_chunk=1)
    np.testing.assert_allclose(one.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5)


def test_hub_learning_runs_and_is_deterministic():
    g = _star_graph(n_leaves=14, seed=9)
    rng = np.random.default_rng(2)
    g.var_role[:] = rng.random(g.n_vars) < 0.5
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=6,
                             hub_chunk=4)
    d = to_device(dg, "cpu")
    cfg = LearnConfig(n_epochs=8, n_sweeps_per_epoch=2, stepsize=0.05,
                      diminish=0.97)
    w1, _, _ = tmc.learn_mc(d, d.w_init, torch.Generator().manual_seed(0),
                            cfg, info, 4, modes=PLAIN, device="cpu")
    w2, _, _ = tmc.learn_mc(d, d.w_init, torch.Generator().manual_seed(0),
                            cfg, info, 4, modes=PLAIN, device="cpu")
    assert torch.equal(w1, w2)
    assert not torch.allclose(w1, d.w_init)


def test_hub_memory_stays_linear():
    """The padded stream volume of a hub graph is O(edges), not
    O(n_hub * max_degree)."""
    g = random_kbc_graph(4000, 12000, max_arity=3, n_weights=50, seed=1,
                         skew=1.3)
    dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=64,
                             hub_chunk=32)
    assert info.has_hub
    hub = info.tiers[-1]
    assert max(ti.degree for ti in info.tiers[:-1]) <= 64
    n_pairs = sum(int(ts.cs_mask.shape[0] * ts.cs_mask.shape[1]
                      * ts.cs_mask.shape[2]) for ts in dg.tiers)
    real = int(sum(g.arities()))
    assert n_pairs < 12 * real, (n_pairs, real)
    assert hub.chunk_g == 32


def test_bench_kbc_shape_compiles_with_a_hub_tier():
    """compile_graph no longer raises on bench.py's KBC shape: skew 1.1,
    document windows, hub_cap 256 (4 variables exceed it at 20,000)."""
    g = random_kbc_graph(20000, 60000, max_arity=3, n_weights=1000, seed=0,
                         skew=1.1, window=2000)
    _, info = compile_graph(g, colors=greedy_coloring(g), order=rcm_order(g),
                            band_wmax=32768, hub_cap=256)
    assert info.has_hub and info.tiers[-1].hub
    assert info.tiers[-1].chunk_g == 512
    assert all(ti.degree <= 256 for ti in info.tiers[:-1])


def test_sparse_weights_with_hub_refused():
    """As in the JAX package, sparse per-combination weights do not
    combine with a hub tier."""
    from sampler_tpu_torch import fixtures

    g = fixtures.sparse_categorical_graph()
    with pytest.raises(ValueError, match="hub"):
        compile_graph(g, hub_cap=0)
