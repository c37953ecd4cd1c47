"""The port's φ evaluation and single-chain engine (engine/potentials.py,
engine/sweep.py, engine/gibbs.py, engine/learn.py's learn and
weight_gradient) against the JAX package and the oracle.

  * eval_phi and factor_phis equal the JAX functions exactly on random
    literals and worlds, for every factor function;
  * color_logits (one chain, tiers concatenated) gives JAX's within 1e-5;
  * weight_gradient is within 1e-5 of JAX's, dense and sparse;
  * gibbs.infer with one chain matches exact enumeration within 0.01, and
    with several chains hands over to infer_mc;
  * learn recovers a labelled coin's log-odds within 0.12, and leaves a
    fixed weight alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import fixtures as jfx
from sampler_tpu import format_spec as jfs
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import potentials as jpot
from sampler_tpu.engine.learn import weight_gradient as jax_weight_gradient
from sampler_tpu.engine.sweep import color_logits as jax_color_logits
from sampler_tpu_torch import FactorGraph, compile_graph, fixtures, oracle
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch.compile import to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.engine import potentials as tpot
from sampler_tpu_torch.engine.gibbs import (infer, init_values,
                                            marginals_from_counts,
                                            run_inference)
from sampler_tpu_torch.engine.learn import (LearnConfig, learn,
                                            weight_gradient)
from sampler_tpu_torch.engine.sweep import color_logits, sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("present", [None, (jfs.FUNC_OR,),
                                     (jfs.FUNC_LINEAR, jfs.FUNC_EQUAL),
                                     (jfs.FUNC_IMPLY_MLN, jfs.FUNC_RATIO,
                                      jfs.FUNC_LOGICAL, jfs.FUNC_ISTRUE)])
def test_eval_phi_equals_jax(present):
    rng = np.random.default_rng(11)
    n, A = 500, 5
    lits = rng.random((n, A)) < 0.5
    arity = rng.integers(1, A + 1, n).astype(np.int32)
    mask = np.arange(A)[None, :] < arity[:, None]
    types = np.asarray(present or jfs.ALL_FACTOR_FUNCS)
    f_type = rng.choice(types, n).astype(np.int32)
    ref = np.asarray(jpot.eval_phi(jnp.asarray(lits), jnp.asarray(mask),
                                   jnp.asarray(f_type), jnp.asarray(arity),
                                   present))
    got = tpot.eval_phi(torch.from_numpy(lits), torch.from_numpy(mask),
                        torch.from_numpy(f_type), torch.from_numpy(arity),
                        present)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.array_equal(
        tpot.literals(torch.tensor([1, 2, 0]), torch.tensor([1, 1, 0]),
                      torch.tensor([True, True, False])),
        [True, False, False])


def _both(make):
    jg = make(jfx)
    jdg, jinfo = jax_compile(jg)
    tdg, tinfo = from_jax(jdg, jinfo)
    return jax_to_device(jdg), jinfo, to_device(tdg, "cpu"), tinfo


def _world(d, info, seed):
    card = np.maximum(d.var_card.numpy(), 1)
    rng = np.random.default_rng(seed)
    init = d.var_init.numpy()
    v = rng.integers(0, 1 << 20, card.shape[0]) % card
    v = np.where(d.var_role.numpy() == 1, init, v)
    return torch.from_numpy(v).to(tmc.values_dtype(info))


GRAPHS = {
    "all_functions": lambda fx: fx.all_functions_graph(n=10),
    "categorical": lambda fx: fx.categorical_graph(),
    "mixed": lambda fx: fx.mixed_graph(),
    "sparse": lambda fx: fx.sparse_categorical_graph(),
    "coin": lambda fx: fx.labeled_coin_graph(n_flips=50, seed=3),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_factor_phis_equal_jax(name):
    jd, jinfo, d, info = _both(GRAPHS[name])
    for seed in range(3):
        v = _world(d, info, seed)
        ref = np.asarray(jpot.factor_phis(jd, jnp.asarray(v.numpy()),
                                          jinfo.present_funcs))
        got = tpot.factor_phis(d, v, info.present_funcs)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(tpot.factor_phis(d, v).numpy(),
                                      np.asarray(jpot.factor_phis(
                                          jd, jnp.asarray(v.numpy()))))


@pytest.mark.parametrize("name", ["mixed", "sparse"])
def test_color_logits_equal_jax(name):
    jd, jinfo, d, info = _both(GRAPHS[name])
    v = _world(d, info, 4)
    for c in range(info.n_colors):
        ref = np.asarray(jax_color_logits(jd, jnp.asarray(v.numpy()),
                                          jd.w_init, c, jinfo,
                                          ("off", "off")))
        got = color_logits(d, v, d.w_init, c, info)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("lne", [False, True])
def test_weight_gradient_equals_jax(name, lne):
    jd, jinfo, d, info = _both(GRAPHS[name])
    v_ev, v_free = _world(d, info, 7), _world(d, info, 8)
    ref = np.asarray(jax_weight_gradient(
        jd, jnp.asarray(v_ev.numpy()), jnp.asarray(v_free.numpy()), lne,
        jinfo.present_funcs, jinfo.has_sparse_cw))
    got = weight_gradient(d, v_ev, v_free, lne, info.present_funcs,
                          info.has_sparse_cw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def _clamped_graph():
    """Query variables whose every neighbour is clamped evidence, under
    five factor functions, one of them categorical: one chain's draws of
    them are independent from sweep to sweep, so its marginals converge
    at the i.i.d. rate (a coupled graph needs many chains, as
    tests/test_inference.py pools)."""
    return FactorGraph.build(
        var_card=[2, 2, 2, 2, 2, 2, 3],
        weights=[1.5, -0.7, 0.9, 1.2, 0.8, -0.5, 0.6],
        factors=[(fs.FUNC_ISTRUE, 0, 1.0, [(0, True)]),
                 (fs.FUNC_ISTRUE, 1, 1.0, [(1, True)]),
                 (fs.FUNC_AND, 2, 1.0, [(2, True), (4, True)]),
                 (fs.FUNC_EQUAL, 3, 1.0, [(3, True), (5, True)]),
                 (fs.FUNC_IMPLY_MLN, 6, 1.0, [(4, True), (1, True)]),
                 (fs.FUNC_AND_CATEGORICAL, 4, 1.0, [(6, True, 2)]),
                 (fs.FUNC_AND_CATEGORICAL, 5, 1.0, [(6, True, 0)])],
        var_role=np.array([0, 0, 0, 0, 1, 1, 0], np.uint8),
        var_init=np.array([0, 0, 0, 0, 1, 0, 0], np.int32))


def test_infer_one_chain_matches_oracle():
    g = _clamped_graph()
    dg, info = compile_graph(g, max_tiers=1)
    d = to_device(dg, "cpu")
    marg, values = infer(d, d.w_init, torch.Generator().manual_seed(0), 100,
                         30000, info, device="cpu")
    assert values.shape == (d.var_card.shape[0],)
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    q = g.var_role == 0
    err = np.abs(marg[q, : exact.shape[1]] - exact[q]).max()
    assert err < 0.01, err


def _evidence_graph():
    g = fixtures.all_functions_graph(n=6, seed=2)
    g.var_role[0] = 1
    g.var_init[0] = 1
    return g


def test_run_inference_counts_every_sweep():
    g = fixtures.categorical_graph()
    dg, info = compile_graph(g)
    d = to_device(dg, "cpu")
    gen = torch.Generator().manual_seed(3)
    v0 = init_values(d, gen, info)
    card = d.var_card.to(v0.dtype)
    assert bool(((v0 >= 0) & ((v0 < card) | (card <= 1))).all())
    ev = d.var_role == 1
    assert torch.equal(v0[ev], d.var_init.to(v0.dtype)[ev])
    values, counts = run_inference(d, v0, d.w_init, gen, 30, False, info,
                                   device="cpu")
    assert counts.shape == (d.var_card.shape[0], info.max_card)
    assert bool((counts.sum(dim=1) == 30).all())
    assert torch.equal(values[ev], v0[ev])
    m = marginals_from_counts(counts, 30)
    assert torch.allclose(m.sum(dim=1), torch.ones(m.shape[0]))


def test_infer_several_chains_is_infer_mc():
    g = fixtures.ising_chain(6)
    dg, info = compile_graph(g)
    d = to_device(dg, "cpu")
    a, va = infer(d, d.w_init, torch.Generator().manual_seed(5), 10, 40,
                  info, n_chains=4, device="cpu")
    b, vb = tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(5), 10,
                         40, info, 4, device="cpu")
    assert np.array_equal(a, b) and torch.equal(va, vb)


def test_learn_recovers_coin_log_odds():
    g = fixtures.labeled_coin_graph(n_flips=400, p_heads=0.75, seed=2)
    p_hat = g.var_init.mean()
    w_star = np.log(p_hat / (1 - p_hat))
    dg, info = compile_graph(g)
    d = to_device(dg, "cpu")
    cfg = LearnConfig(n_epochs=400, stepsize=0.02, diminish=0.995,
                      regularization="none")
    w, v_ev, v_free = learn(d, d.w_init, torch.Generator().manual_seed(0),
                            cfg, info, device="cpu")
    assert abs(float(w[0]) - w_star) < 0.12, (float(w[0]), w_star)
    ev = d.var_role == 1
    assert torch.equal(v_ev[ev], d.var_init.to(v_ev.dtype)[ev])


def test_learn_leaves_fixed_weight():
    g = fixtures.labeled_coin_graph(n_flips=100, p_heads=0.8, seed=0)
    g.w_fixed[:] = True
    dg, info = compile_graph(g)
    d = to_device(dg, "cpu")
    w, _, _ = learn(d, d.w_init, torch.Generator().manual_seed(0),
                    LearnConfig(n_epochs=50, stepsize=0.1,
                                regularization="none"), info, device="cpu")
    assert float(w[0]) == 0.0


def test_sweep_keeps_evidence_unless_sampled():
    g = _evidence_graph()
    dg, info = compile_graph(g)
    d = to_device(dg, "cpu")
    gen = torch.Generator().manual_seed(1)
    v = init_values(d, gen, info)
    ev = d.var_role == 1
    for _ in range(20):
        sweep(d, v, d.w_init, gen, False, info)
        assert torch.equal(v[ev], d.var_init.to(v.dtype)[ev])
    moved = False
    for _ in range(50):
        sweep(d, v, d.w_init, gen, True, info)
        moved |= not torch.equal(v[ev], d.var_init.to(v.dtype)[ev])
    assert moved
