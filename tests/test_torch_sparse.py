"""The port's sparse per-combination weights against the JAX package and the
oracle (mirrors tests/test_sparse_weights.py).

  * color_logits_mc's sparse branch gives the JAX package's candidate
    log-potentials (within 1e-6) on the sparse fixtures;
  * sparse_comb_wids equals JAX's exactly, for one world and for NC
    chains;
  * the cs-stream gradient on its default route (grad_records on the dense
    owner records, the sparse ones' table lookup beside it), the chunked
    route (the fused mode off; whole tiers and one row a chunk) and the
    per-factor gradient equal JAX mc_weight_gradient_cs within 1e-4, with
    the reserved zero slot's gradient 0; the default route runs no row
    chunk of the chunked route, and under graph sharding the ranks'
    gradients sum to JAX's;
  * infer_mc on the sparse fixtures matches exact enumeration within 0.01;
  * learn_mc and the single-chain learn recover per-category log-odds
    (atol 0.15, tests/test_sparse_weights.py's bound) and leave the
    reserved zero slot at 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import fixtures as jfx
from sampler_tpu import format_spec as jfs
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu.graph import FactorGraph as JaxFactorGraph
from sampler_tpu_torch import FactorGraph, compile_graph, fixtures, oracle
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch.compile import to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.engine.learn import LearnConfig, learn
from sampler_tpu_torch.ops import grad as tgrad
from sampler_tpu_torch.parallel import graph_shard as tgs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _evidence_neighbour(fx, fg, f):
    g = fx.sparse_categorical_graph(seed=2, n=5)
    g.var_role[1] = f.ROLE_EVIDENCE
    g.var_init[1] = 2
    g.validate()
    return g


def _absent_combination(fx, fg, f):
    return fg.build(var_card=[2, 2], weights=[1.3],
                    factors=[(f.FUNC_AND_CATEGORICAL, 0, 1.0,
                              [(0, True, 0), (1, True, 0)], [((1, 1), 0)])])


def _mixed_sparse_dense(fx, fg, f):
    return fg.build(
        var_card=[3, 3, 2], weights=[0.4, -0.6, 0.8, 0.3],
        factors=[
            (f.FUNC_AND_CATEGORICAL, 3, 1.0, [(0, True, 0)],
             [((0,), 0), ((1,), 1), ((2,), 2)]),
            (f.FUNC_AND_CATEGORICAL, 3, 1.5, [(0, True, 1), (1, True, 2)]),
            (f.FUNC_ISTRUE, 3, 1.0, [(2, True)]),
        ])


def _three_way(fx, fg, f):
    """An arity-3 sparse factor over cards 2, 3, 4 (strides 12, 4, 1)
    beside a unary sparse table and a dense pair factor."""
    rng = np.random.default_rng(4)
    tab3 = [((a, b, c), int(rng.integers(0, 5)))
            for a in range(2) for b in range(3) for c in range(4)
            if rng.random() < 0.6]
    return fg.build(
        var_card=[2, 3, 4, 3], weights=rng.normal(0, 0.7, 6).round(3),
        factors=[
            (f.FUNC_AND_CATEGORICAL, 0, 1.0,
             [(0, True, 0), (1, True, 0), (2, True, 0)], tab3),
            (f.FUNC_AND_CATEGORICAL, 0, 0.5, [(3, True, 0)],
             [((0,), 1), ((2,), 5)]),
            (f.FUNC_EQUAL, 5, 1.0, [(1, True, 2), (3, True, 1)]),
        ])


SPARSE_GRAPHS = {
    "sparse_categorical": lambda fx, fg, f: fx.sparse_categorical_graph(),
    "evidence_neighbour": _evidence_neighbour,
    "absent_combination": _absent_combination,
    "mixed_sparse_dense": _mixed_sparse_dense,
    "three_way": _three_way,
    "labeled_categorical": lambda fx, fg, f: fx.labeled_categorical_graph(
        n_obs=40, seed=3),
}


def _both(name):
    """(JAX DeviceGraph on device, JAX info, port graph on the CPU, port
    info) compiled once by the JAX package from the same graph."""
    jg = SPARSE_GRAPHS[name](jfx, JaxFactorGraph, jfs)
    jdg, jinfo = jax_compile(jg)
    assert jinfo.has_sparse_cw
    tdg, tinfo = from_jax(jdg, jinfo)
    return jax_to_device(jdg), jinfo, to_device(tdg, "cpu"), tinfo


def _worlds(d, dt, n, seed):
    card = np.maximum(d.var_card.numpy(), 1)[:, None]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 1 << 20, (card.size, n))
                             % card).to(dt) for _ in range(2)]


@pytest.mark.parametrize("name", sorted(SPARSE_GRAPHS))
def test_color_logits_sparse_match_jax(name):
    jd, jinfo, d, info = _both(name)
    modes = tmc.resolve_modes(info, "cpu")
    assert modes == ("off", "plain")
    assert not any(tmc.tier_modes(ti, modes)[1] != "off"
                   for ti in info.tiers)        # every draw stays eager
    tv = _worlds(d, tmc.values_dtype(info), 5, 6)[0]
    jv, jw = jnp.asarray(tv.numpy()), jnp.asarray(d.w_init.numpy())
    for t, ti in enumerate(info.tiers):
        for c in range(info.n_colors):
            ref = jmc.color_logits_mc(jd, jd.tiers[t], jinfo.tiers[t], jv, jw,
                                      c, jinfo, ("off", "off"))
            out = tmc.color_logits_mc(d, d.tiers[t], ti, tv, d.w_init, c,
                                      info, modes)
            assert out.shape == ref.shape
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("name", sorted(SPARSE_GRAPHS))
def test_sparse_comb_wids_match_jax(name):
    jd, _, d, info = _both(name)
    tv = _worlds(d, tmc.values_dtype(info), 7, 8)[0]
    for v in (tv, tv[:, 3]):
        ref = np.asarray(jmc.sparse_comb_wids(jd, jnp.asarray(v.numpy())))
        got = tmc.sparse_comb_wids(d, v)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", sorted(SPARSE_GRAPHS))
@pytest.mark.parametrize("lne", [False, True])
def test_sparse_gradient_matches_jax(name, lne):
    jd, jinfo, d, info = _both(name)
    v_ev, v_free = _worlds(d, tmc.values_dtype(info), 6, 12)
    ref = np.asarray(jmc.mc_weight_gradient_cs(
        jd, jnp.asarray(v_ev.numpy()), jnp.asarray(v_free.numpy()), lne,
        jinfo, ("off", "off")))
    assert ref[-1] == 0.0
    modes = tmc.resolve_modes(info, "cpu")
    W = d.w_init.shape[0]
    assert all(tmc.gradient_route(ti, info, modes, W) == ("records", "plain")
               for ti in info.tiers)
    for m in (modes, ("off", "off")):
        for row_chunk in (None, 1):
            got = tmc.mc_weight_gradient_cs(d, v_ev, v_free, lne, info, m,
                                            row_chunk=row_chunk)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
            assert float(got[-1]) == 0.0
    factors = tmc._mc_weight_gradient_factors(d, v_ev, v_free, lne, info)
    np.testing.assert_allclose(factors.numpy(), ref, rtol=0, atol=1e-4)
    jfactors = np.asarray(jmc._mc_weight_gradient_factors(
        jd, jnp.asarray(v_ev.numpy()), jnp.asarray(v_free.numpy()), lne,
        jinfo))
    np.testing.assert_allclose(factors.numpy(), jfactors, rtol=0, atol=1e-4)
    if lne:
        assert np.abs(ref).max() > 0.05


def _count(monkeypatch, name):
    # the per-tier plain version is called by the route's (ops.grad)
    mod = tgrad if name == "grad_records_plain" else tmc
    calls = []
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1)
                        or orig(*a, **k))
    return calls


@pytest.mark.parametrize("name", sorted(SPARSE_GRAPHS))
def test_sparse_gradient_runs_no_row_chunk(monkeypatch, name):
    """With the fused mode on, a sparse-weight graph's gradient calls
    grad_records_plain once a tier and _phi_streams (the chunked route's
    row chunks) never; the sparse owner records go to the table lookup
    once a tier that has them; with it off, the reverse."""
    _, _, d, info = _both(name)
    v_ev, v_free = _worlds(d, tmc.values_dtype(info), 4, 3)
    records = _count(monkeypatch, "grad_records_plain")
    chunks = _count(monkeypatch, "_phi_streams")
    lookups = _count(monkeypatch, "_sparse_grad_records")
    has_sparse = sum(bool((ts.cs_issparse & ts.cs_gowner).any())
                     for ts in d.tiers)
    assert has_sparse
    for modes, want in ((("off", "plain"), (len(info.tiers), 0, has_sparse)),
                        (("off", "off"), (0, None, 0))):
        for calls in (records, chunks, lookups):
            calls.clear()
        tmc.mc_weight_gradient_cs(d, v_ev, v_free, True, info, modes)
        assert len(records) == want[0] and len(lookups) == want[2]
        assert (len(chunks) == 0) if want[1] == 0 else len(chunks) > 0


@pytest.mark.parametrize("name", ["sparse_categorical", "mixed_sparse_dense",
                                  "three_way"])
@pytest.mark.parametrize("lne", [False, True])
def test_sharded_sparse_gradient_sums_to_jax(name, lne):
    """A graph compiled for two graph shards: the ranks' gradients on the
    default route (each rank's dense owner records through
    grad_records_plain, its sparse ones through the lookup) sum to JAX's
    unsharded gradient within 1e-4."""
    n_graph = 2
    jg = SPARSE_GRAPHS[name](jfx, JaxFactorGraph, jfs)
    jdg, jinfo = jax_compile(jg, align=8 * n_graph, shards=n_graph)
    tdg, info = from_jax(jdg, jinfo)
    d = to_device(tdg, "cpu")
    v_ev, v_free = _worlds(d, tmc.values_dtype(info), 6, 21)
    ref = np.asarray(jmc.mc_weight_gradient_cs(
        jax_to_device(jdg), jnp.asarray(v_ev.numpy()),
        jnp.asarray(v_free.numpy()), lne, jinfo, ("off", "off")))
    modes = tmc.resolve_modes(info, "cpu")
    total = np.zeros_like(ref)
    for g in range(n_graph):
        local = tgs.shard_device_graph(d, info, n_graph, g, "cpu")
        total += tmc.mc_weight_gradient_cs(local, v_ev, v_free, lne, info,
                                           modes, n_graph=n_graph,
                                           g=g).numpy()
    if lne:
        assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(total, ref, rtol=0, atol=1e-4)


ORACLE_GRAPHS = ["sparse_categorical", "evidence_neighbour",
                 "absent_combination", "mixed_sparse_dense", "three_way"]


@pytest.mark.parametrize("name", ORACLE_GRAPHS)
def test_infer_mc_sparse_matches_oracle(name):
    g = SPARSE_GRAPHS[name](fixtures, FactorGraph, fs)
    dg, info = compile_graph(g)
    assert info.has_sparse_cw
    d = to_device(dg, "cpu")
    marg, vals = tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(0),
                              100, 1000, info, 64, device="cpu")
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    mask = g.var_role == 0
    err = np.abs(marg[mask, : exact.shape[1]] - exact[mask]).max()
    assert err < 0.01, err
    card = d.var_card.to(vals.dtype)[:, None]
    assert bool(((vals >= 0) & ((vals < card) | (card <= 1))).all())


def test_absent_combination_oracle_is_closed_form():
    """The oracle the sampler is held to gives w on (1, 1) and 0 on the
    three absent combinations."""
    g = _absent_combination(fixtures, FactorGraph, fs)
    z = 3 + np.exp(1.3)
    np.testing.assert_allclose(oracle.exact_marginals(g)[0],
                               [2 / z, (1 + np.exp(1.3)) / z], atol=1e-12)


def _category_log_odds(w, g):
    counts = np.bincount(g.var_init, minlength=3) / g.n_vars
    want = np.log(counts)
    return w[:3] - w[0], want - want[0]


def test_learn_mc_sparse_recovers_category_log_odds():
    g = fixtures.labeled_categorical_graph(n_obs=400, probs=(0.5, 0.2, 0.3),
                                           seed=2)
    dg, info = compile_graph(g)
    d = to_device(dg, "cpu")
    cfg = LearnConfig(n_epochs=300, stepsize=0.03, diminish=0.995,
                      regularization="none")
    w, _, _ = tmc.learn_mc(d, d.w_init, torch.Generator().manual_seed(0),
                           cfg, info, 8, device="cpu")
    got, want = _category_log_odds(w.numpy(), g)
    np.testing.assert_allclose(got, want, atol=0.15)
    assert float(w[-1]) == 0.0


def test_learn_sparse_recovers_category_log_odds():
    g = fixtures.labeled_categorical_graph(n_obs=400, probs=(0.6, 0.3, 0.1),
                                           seed=1)
    dg, info = compile_graph(g)
    d = to_device(dg, "cpu")
    assert d.w_init.shape[0] == info.n_weights + 1
    cfg = LearnConfig(n_epochs=400, stepsize=0.02, diminish=0.995,
                      regularization="none")
    w, _, _ = learn(d, d.w_init, torch.Generator().manual_seed(0), cfg, info,
                    device="cpu")
    got, want = _category_log_odds(w.numpy(), g)
    np.testing.assert_allclose(got, want, atol=0.15)
    assert float(w[-1]) == 0.0
