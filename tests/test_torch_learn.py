"""The port's weight learning (engine/learn.py, learn_mc) against the JAX
package and closed-form fixed points.

  * apply_update gives the JAX update for l1, l2 and no regularization,
    fixed weights included;
  * learn_mc on the CPU recovers a labelled coin's log-odds, separates two
    coin populations, and leaves a fixed weight alone (the fixed points of
    tests/test_learning.py);
  * on one generator seed the kernel route of the gradient
    (grad_pair_tile) and the records route (grad_records_sum, which an
    affine2 tier takes past GRAD_W_MAX weights) learn the same weights
    (the sweeps are the same draws; the gradients differ only in float
    order);
  * ten epochs of _learn_mc_from equal two chained five-epoch calls;
  * on an evidence-clamped triple grid (fusedm, arity 3) learning through
    the fused draw and through the eager draw reaches the same weights
    (mirrors tests/test_fused_dm.py's fold-refresh test), and on
    multi-window graphs (band_k 2) the records gradient equals the
    per-factor gradient and the JAX one;
  * on categorical, mixed, Potts and card-200 graphs the cs-stream
    gradient (the records route's categorical branch) and the per-factor
    gradient equal JAX mc_weight_gradient_cs within 1e-4, and learn_mc on an
    evidence Potts grid refolds fold_affine_cat every epoch and moves the
    weights (mirrors tests/test_fused_cat.py's learning test).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu import fixtures as jfx
from sampler_tpu.benchgraphs import big_potts_grid as jax_potts_grid
from sampler_tpu.engine.learn import apply_update as jax_apply_update
from sampler_tpu.graph import FactorGraph as JaxFactorGraph
from sampler_tpu_torch import FactorGraph, compile_graph, fixtures
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch.benchgraphs import (big_ising_grid, big_potts_grid,
                                           big_triple_grid)
from sampler_tpu_torch.compile import to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine.learn import LearnConfig, apply_update
from sampler_tpu_torch.engine import multichain as tmc
from torch_routes import learn_on_route


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _learn(g, cfg, n_chains=8, seed=0, colors=None, **kw):
    dg, info = compile_graph(g, colors=colors, **kw)
    d = to_device(dg, "cpu")
    w, _, _ = tmc.learn_mc(d, d.w_init, torch.Generator().manual_seed(seed),
                           cfg, info, n_chains, device="cpu")
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
    orig = tmc.grad_pair_tile
    monkeypatch.setattr(tmc, "grad_pair_tile",
                        lambda *a: calls.append(1) or orig(*a))
    wk = _learn(g, GRID_CFG, 4, seed=1, **kw)
    assert len(calls) == 2 * GRID_CFG.n_epochs        # one a color an epoch
    calls.clear()
    monkeypatch.setattr(tmc, "GRAD_W_MAX", 0)        # past the kernel's W
    wx = _learn(g, GRID_CFG, 4, seed=1, **kw)
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


def _evidence_triple_grid(seed=5):
    """tests/test_fused_dm.py's learning graph: the 16x16 triple grid with
    every variable labelled and the weights starting at 0."""
    g, colors = big_triple_grid(16, 16)
    g.var_role[:] = fs.ROLE_EVIDENCE
    g.var_init[:] = np.random.default_rng(seed).integers(0, 2, g.n_vars)
    g.w_init[:] = 0.0
    return g, colors


def test_fusedm_learning_fused_and_unfused_agree():
    g, colors = _evidence_triple_grid()
    dg, info = compile_graph(g, colors=colors, band_tile=8, band_min_block=1)
    assert info.fusedm and info.tiers[0].arity == 3
    d = to_device(dg, "cpu")
    cfg = LearnConfig(n_epochs=150, stepsize=1e-3, diminish=0.99,
                      regularization="none")
    out = {"fused": tmc.learn_mc(d, d.w_init,
                                 torch.Generator().manual_seed(0), cfg, info,
                                 8, device="cpu")[0].numpy(),
           "unfused": learn_on_route(d, info, torch.Generator().manual_seed(0),
                                     cfg, 8).numpy()}
    np.testing.assert_allclose(out["fused"], out["unfused"], atol=0.15)
    assert np.abs(out["fused"][:g.n_weights]).max() > 0.05   # they moved


def _mw_triple(seed=3):
    g, colors = big_triple_grid(32, 32)
    rng = np.random.default_rng(seed)
    g.var_role[:] = rng.random(g.n_vars) < 0.5
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    return g, colors


def _mw_ising(seed=4):
    g, _ = big_ising_grid(32, 32, w_pair=0.35, w_bias=0.2)
    rng = np.random.default_rng(seed)
    g.var_role[:] = rng.random(g.n_vars) < 0.5
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    r, c = np.divmod(np.arange(g.n_vars), 32)
    return g, ((r + c) % 3).astype(np.int32)


@pytest.mark.parametrize("make", [_mw_triple, _mw_ising],
                         ids=["triple_grid", "ising_3color"])
@pytest.mark.parametrize("lne", [False, True])
def test_multi_window_chunked_gradient_matches_factors(make, lne):
    g, colors = make()
    jdg, jinfo = jax_compile(g, colors=colors, band_tile=8, band_min_block=1,
                             band_wmax=512)
    ti = jinfo.tiers[0]
    assert ti.band_k == 2 and ti.fusedm
    tdg, tinfo = from_jax(jdg, jinfo)
    d = to_device(tdg, "cpu")
    P = jdg.var_card.shape[0]
    rng = np.random.default_rng(9)
    v_ev, v_free = (rng.integers(0, 2, (P, 6)).astype(np.int8)
                    for _ in range(2))
    tv_ev, tv_free = torch.from_numpy(v_ev), torch.from_numpy(v_free)
    factors = tmc._mc_weight_gradient_factors(d, tv_ev, tv_free, lne, tinfo)
    got = tmc.mc_weight_gradient_cs(d, tv_ev, tv_free, lne, tinfo)
    np.testing.assert_allclose(got.numpy(), factors.numpy(), rtol=0,
                               atol=1e-4)
    ref = jmc._mc_weight_gradient_factors(jax_to_device(jdg),
                                          jnp.asarray(v_ev),
                                          jnp.asarray(v_free), lne, jinfo)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert np.abs(factors.numpy()).max() > 1.0


def _potts_grid(make, card=3, seed=11, frac=0.5):
    """A 16x16 Potts grid that bands (band_tile=8) with about ``frac`` of
    its variables labelled."""
    g, colors = make(16, 16, card=card, seed=seed)
    rng = np.random.default_rng(seed)
    g.var_role[:] = rng.random(g.n_vars) < frac
    g.var_init[:] = rng.integers(0, card, g.n_vars)
    return g, colors


def _card200(graph_cls):
    factors = [
        (fs.FUNC_AND_CATEGORICAL, 0, 1.0, [(0, True, 7)]),
        (fs.FUNC_EQUAL, 1, 1.0, [(0, True, 3), (1, True, 3)]),
        (fs.FUNC_EQUAL, 1, 1.0, [(1, True, 150), (2, True, 150)]),
    ]
    g = graph_cls.build(var_card=[200] * 3, weights=[1.2, 0.8],
                        factors=factors)
    g.var_dtype[:] = fs.DTYPE_CATEGORICAL
    g.var_role[2] = fs.ROLE_EVIDENCE
    g.var_init[2] = 150
    return g, None


# name -> (graph maker given the JAX package's fixtures, benchgraphs and
# FactorGraph, compile kwargs)
CAT_GRAPHS = {
    "categorical": (lambda fx, bg, fg: (fx.categorical_graph(), None), {}),
    "mixed": (lambda fx, bg, fg: (fx.mixed_graph(), None), {}),
    "potts_grid": (lambda fx, bg, fg: _potts_grid(bg),
                   dict(band_tile=8, band_min_block=1)),
    "card200": (lambda fx, bg, fg: _card200(fg), {}),
}


@pytest.mark.parametrize("name", sorted(CAT_GRAPHS))
@pytest.mark.parametrize("lne", [False, True])
def test_categorical_gradient_matches_jax(name, lne):
    make, kw = CAT_GRAPHS[name]
    g, colors = make(jfx, jax_potts_grid, JaxFactorGraph)
    jdg, jinfo = jax_compile(g, colors=colors, **kw)
    tdg, tinfo = from_jax(jdg, jinfo)
    d = to_device(tdg, "cpu")
    assert not tinfo.all_boolean
    card = np.maximum(np.asarray(jdg.var_card), 1)[:, None]
    rng = np.random.default_rng(12)
    dt = tmc.values_dtype(tinfo)
    # card 200: values from the predicates' own categories, so that the
    # literals vary between the worlds
    pick = (np.array([0, 3, 7, 150]) if name == "card200"
            else np.arange(1 << 10))
    v_ev, v_free = (torch.from_numpy(
        pick[rng.integers(0, pick.size, (card.size, 6))] % card).to(dt)
        for _ in range(2))
    ref = jmc.mc_weight_gradient_cs(jax_to_device(jdg),
                                    jnp.asarray(v_ev.numpy()),
                                    jnp.asarray(v_free.numpy()), lne, jinfo,
                                    ("off", "off"))
    got = tmc.mc_weight_gradient_cs(d, v_ev, v_free, lne, tinfo)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    factors = tmc._mc_weight_gradient_factors(d, v_ev, v_free, lne, tinfo)
    np.testing.assert_allclose(factors.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    if lne:                  # without it only factors at evidence count
        assert np.abs(np.asarray(ref)).max() > 0.05


def test_potts_learning_refolds_and_moves(monkeypatch):
    """tests/test_fused_cat.py's learning grid through the fused draw's
    plain version: one fold_affine_cat an epoch, weights that move and stay
    finite, labels kept in the evidence world."""
    g, colors = _potts_grid(big_potts_grid, frac=1.0)
    dg, info = compile_graph(g, colors=colors, band_tile=8, band_min_block=1)
    assert info.affinek
    d = to_device(dg, "cpu")
    folds = []
    orig = tmc.fold_affine_cat
    monkeypatch.setattr(tmc, "fold_affine_cat",
                        lambda *a: folds.append(1) or orig(*a))
    cfg = LearnConfig(n_epochs=12, n_sweeps_per_epoch=3, stepsize=0.08,
                      diminish=0.97)
    w, v_ev, _ = tmc.learn_mc(d, d.w_init, torch.Generator().manual_seed(0),
                              cfg, info, 4, device="cpu")
    assert len(folds) == cfg.n_epochs
    assert np.isfinite(w.numpy()).all()
    assert np.abs(w.numpy() - d.w_init.numpy()).max() > 1e-3
    labels = d.var_init.to(v_ev.dtype)[:, None]
    ev = (d.var_role == fs.ROLE_EVIDENCE) & (d.var_card > 1)
    assert bool((v_ev[ev] == labels[ev]).all())
