"""The port's weight learning (engine/learn.py, learn_mc) against the JAX
package and closed-form fixed points.

  * apply_update gives the JAX update for l1, l2 and no regularization,
    fixed weights included;
  * learn_mc on the CPU recovers a labelled coin's log-odds, separates two
    coin populations, and leaves a fixed weight alone (the fixed points of
    tests/test_learning.py);
  * on one generator seed the kernel route of the gradient and the
    chunked index_select route learn the same weights (the sweeps are the
    same draws; the gradients differ only in float order);
  * ten epochs of _learn_mc_from equal two chained five-epoch calls.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu.engine.learn import apply_update as jax_apply_update
from sampler_tpu_torch import FactorGraph, compile_graph, fixtures
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch.benchgraphs import big_ising_grid
from sampler_tpu_torch.compile import to_device
from sampler_tpu_torch.engine.learn import LearnConfig, apply_update
from sampler_tpu_torch.engine import multichain as tmc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _learn(g, cfg, n_chains=8, seed=0, modes=None, colors=None, **kw):
    dg, info = compile_graph(g, colors=colors, **kw)
    d = to_device(dg, "cpu")
    w, _, _ = tmc.learn_mc(d, d.w_init, torch.Generator().manual_seed(seed),
                           cfg, info, n_chains, modes=modes, device="cpu")
    return w.numpy()


def _log_odds(labels):
    p = labels.mean()
    return np.log(p / (1 - p))


@pytest.mark.parametrize("reg", ["l1", "l2", "none"])
def test_apply_update_matches_jax(reg):
    rng = np.random.default_rng(5)
    w = rng.normal(size=12).astype(np.float32)
    w[3] = 0.0
    grad = rng.normal(size=12).astype(np.float32)
    fixed = rng.random(12) < 0.3
    ref = jax_apply_update(jnp.asarray(w), jnp.asarray(grad),
                           jnp.asarray(fixed), 0.07, reg, 0.3)
    got = apply_update(torch.from_numpy(w), torch.from_numpy(grad),
                       torch.from_numpy(fixed), 0.07, reg, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-7)
    assert np.array_equal(got.numpy()[fixed], w[fixed])


def test_coin_weight_recovers_log_odds():
    g = fixtures.labeled_coin_graph(n_flips=400, p_heads=0.75, seed=2)
    cfg = LearnConfig(n_epochs=300, stepsize=0.03, diminish=0.995,
                      regularization="none")
    w = _learn(g, cfg)
    assert w[0] == pytest.approx(_log_odds(g.var_init), abs=0.12)


def test_two_weight_separation():
    rng = np.random.default_rng(3)
    n = 300
    labels_a = (rng.random(n) < 0.8).astype(np.int32)
    labels_b = (rng.random(n) < 0.3).astype(np.int32)
    factors = [(fs.FUNC_ISTRUE, 0, 1.0, [(i, True)]) for i in range(n)]
    factors += [(fs.FUNC_ISTRUE, 1, 1.0, [(n + i, True)]) for i in range(n)]
    g = FactorGraph.build(
        var_card=[2] * (2 * n), weights=[0.0, 0.0], factors=factors,
        var_role=np.full(2 * n, fs.ROLE_EVIDENCE, np.uint8),
        var_init=np.concatenate([labels_a, labels_b]))
    cfg = LearnConfig(n_epochs=400, stepsize=0.02, diminish=0.995,
                      regularization="none")
    w = _learn(g, cfg)
    assert w[0] == pytest.approx(_log_odds(labels_a), abs=0.2)
    assert w[1] == pytest.approx(_log_odds(labels_b), abs=0.2)


def test_fixed_weight_not_updated():
    g = fixtures.labeled_coin_graph(n_flips=100, p_heads=0.8, seed=0)
    g.w_fixed[:] = True
    cfg = LearnConfig(n_epochs=50, stepsize=0.1, regularization="none")
    assert _learn(g, cfg)[0] == 0.0


def _banded_grid(seed=7):
    """The 16x16 grid of tests/test_grad_kernel.py, half evidence."""
    g, colors = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    rng = np.random.default_rng(seed)
    g.var_role[:] = rng.random(g.n_vars) < 0.5
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    return g, colors


GRID_CFG = LearnConfig(n_epochs=10, n_sweeps_per_epoch=2, stepsize=0.05,
                       diminish=0.98, regularization="l2", reg_param=0.01)


def test_kernel_and_chunked_routes_learn_the_same_weights(monkeypatch):
    g, colors = _banded_grid()
    kw = dict(colors=colors, band_tile=8, band_min_block=1)
    calls = []
    orig = tmc.grad_pair_tile_plain
    monkeypatch.setattr(tmc, "grad_pair_tile_plain",
                        lambda *a: calls.append(1) or orig(*a))
    wk = _learn(g, GRID_CFG, 4, seed=1, modes=("plain", "plain"), **kw)
    assert len(calls) == 2 * GRID_CFG.n_epochs        # one a color an epoch
    calls.clear()
    wx = _learn(g, GRID_CFG, 4, seed=1, modes=("off", "plain"), **kw)
    assert not calls
    np.testing.assert_allclose(wk, wx, rtol=0, atol=1e-4)
    assert np.abs(wk[:g.n_weights] - g.w_init).max() > 1e-3   # they moved


def test_resume_at_epoch_granularity():
    g, colors = _banded_grid(seed=8)
    dg, info = compile_graph(g, colors=colors, band_tile=8, band_min_block=1)
    d = to_device(dg, "cpu")

    def start(seed):
        gen = torch.Generator().manual_seed(seed)
        v_ev = tmc.init_values_mc(d, gen, 4, info)
        return gen, v_ev, tmc.init_values_mc(d, gen, 4, info)

    gen, v_ev, v_free = start(2)
    full = tmc._learn_mc_from(d, d.w_init, v_ev, v_free, GRID_CFG.stepsize,
                              gen, GRID_CFG, info, device="cpu")
    half = dataclasses.replace(GRID_CFG, n_epochs=5)
    gen, v_ev, v_free = start(2)
    w, v_ev, v_free, alpha = tmc._learn_mc_from(
        d, d.w_init, v_ev, v_free, GRID_CFG.stepsize, gen, half, info,
        device="cpu")
    assert alpha == pytest.approx(GRID_CFG.stepsize * 0.98 ** 5, rel=1e-6)
    resumed = tmc._learn_mc_from(d, w, v_ev, v_free, alpha, gen, half, info,
                                 device="cpu")
    assert torch.equal(full[0], resumed[0])
    assert torch.equal(full[1], resumed[1])
    assert torch.equal(full[2], resumed[2])
    assert full[3] == resumed[3]


def test_learn_mc_leaves_given_worlds_alone():
    g, colors = _banded_grid(seed=9)
    dg, info = compile_graph(g, colors=colors, band_tile=8, band_min_block=1)
    d = to_device(dg, "cpu")
    gen = torch.Generator().manual_seed(4)
    v_ev = tmc.init_values_mc(d, gen, 4, info)
    v_free = tmc.init_values_mc(d, gen, 4, info)
    before = (v_ev.clone(), v_free.clone())
    cfg = dataclasses.replace(GRID_CFG, n_epochs=2)
    w, e, f = tmc.learn_mc(d, d.w_init, gen, cfg, info, 4, v_ev=v_ev,
                           v_free=v_free, device="cpu")
    assert torch.equal(v_ev, before[0]) and torch.equal(v_free, before[1])
    assert e.shape == f.shape == v_ev.shape
    assert bool(((e == 0) | (e == 1)).all() and ((f == 0) | (f == 1)).all())
    # the evidence world keeps its labels; the free world resamples them
    ev = torch.from_numpy(np.asarray(dg.var_role) == fs.ROLE_EVIDENCE)
    ev &= torch.from_numpy(np.asarray(dg.var_card) > 1)
    labels = d.var_init.to(torch.int8)[:, None]
    assert bool((e[ev] == labels[ev]).all())
    assert bool((f[ev] != labels[ev]).any())
    assert torch.isfinite(w).all()
