"""The port's graph sharding (sampler_tpu_torch.parallel.graph_shard)
against the JAX package's (tests/test_graph_shard.py and
test_sparse_shard.py), each graph compiled once by the JAX package and
carried across with convert.from_jax:

  * halo_plan equals JAX's (None included) on big_ising_grid(64, 64) and
    a banded triple grid at n_graph 2 and 4; check_shardable raises where
    JAX's does, with the same message;
  * each rank's local streams equal JAX's tiers_2d layout cut in n
    contiguous parts on axis 1 where JAX's _dg_specs shards a field, and
    the whole field where it replicates (Ising, hub and sparse graphs);
    _own_rowmask equals JAX's;
  * the port's mc_weight_gradient_cs on each rank's local streams, summed
    over the ranks, is JAX's unsharded gradient within 1e-4 (six graphs,
    hub and sparse among them); the ranks' hub partial sums add up to the
    unsharded ones; the gradient learning applies on a mesh (summed over
    the graph group, averaged over the chains group) is the unsharded
    graph's on the gathered worlds, at (1, 4) under halo, (2, 2) and
    (2, 1);
  * whole runs on CPU ranks over Gloo (one thread each, at most 4 ranks):
    infer_gs against exact enumeration at meshes (2, 2), (1, 4) and
    (4, 1) (|dp| < 0.015, JAX's bound), the all-functions graph with
    evidence, a sparse-weight graph and the fused draws' plain versions;
    learn_gs reaches the labels' log-odds (within 0.15); halo equals
    all-gather bit for bit in inference and learning; a chunked call
    equals a single one and a resumed run an uninterrupted one, bit for
    bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import benchgraphs as jbg
from sampler_tpu import coloring as jax_coloring
from sampler_tpu import fixtures as jfx
from sampler_tpu import format_spec as jfs
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import tiers_2d
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu.parallel import graph_shard as jgs
from sampler_tpu_torch import fixtures, oracle
from sampler_tpu_torch.compile import FLAT_TIER_FIELDS, to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.engine.learn import LearnConfig
from sampler_tpu_torch.parallel import graph_shard as tgs
from sampler_tpu_torch.parallel.comm import make_mesh
from sampler_tpu_torch.parallel.launch import Ranks

KBC = dict(max_arity=3, n_weights=11, seed=3, skew=1.2, evidence_frac=0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labelled(g, every=2):
    g.var_role[::every] = jfs.ROLE_EVIDENCE
    return g


def _graph(name: str, n_graph: int):
    """(JAX graph, JAX DeviceGraph and CompileInfo) of a named case,
    compiled for ``n_graph`` shards."""
    kw = dict(align=8 * n_graph, shards=n_graph)
    band = dict(band_tile=8, band_min_block=1)
    if name == "ising64":
        g, colors = jbg.big_ising_grid(64, 64)
        kw.update(colors=colors, band_tile=128, band_min_block=1)
    elif name == "ising":
        g, colors = jbg.big_ising_grid(32, 32, w_pair=0.3, w_bias=0.2)
        g = _labelled(g)
        kw.update(colors=colors, **band)
    elif name == "triple":
        g, colors = jbg.big_triple_grid(32, 32)
        g = _labelled(g, 3)
        kw.update(colors=colors, band_wmax=512, **band)
    elif name == "potts":
        g, colors = jbg.big_potts_grid(16, 16, card=3)
        g = _labelled(g)
        kw.update(colors=colors, **band)
    elif name == "kbc":
        g = jbg.random_kbc_graph(300, 900, **KBC)
        kw.update(colors=jax_coloring.greedy_coloring(g), hub_cap=8,
                  hub_chunk=4)
    elif name == "sparse":
        g = jfx.sparse_categorical_graph(seed=3, n=6)
        g.var_role[::2] = jfs.ROLE_EVIDENCE
        g.validate()
    elif name == "functions":
        g = jfx.all_functions_graph()
    else:
        raise KeyError(name)
    dgj, infoj = jax_compile(g, **kw)
    return g, dgj, infoj


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("n_graph", [2, 4])
@pytest.mark.parametrize("name", ["ising64", "triple", "ising", "kbc"])
def test_halo_plan_equals_jax(name, n_graph):
    _, dgj, infoj = _graph(name, n_graph)
    dg, info = from_jax(dgj, infoj)
    want = jgs.halo_plan(dgj, infoj, n_graph)
    if name == "ising64" and n_graph == 4:
        assert want is not None         # the case the plan exists for
    assert tgs.halo_plan(dg, info, n_graph) == want
    assert tgs.halo_plan(to_device(dg, "cpu"), info, n_graph) == want


@pytest.mark.parametrize("n_graph,compiled_for", [(3, 1), (4, 2), (8, 4)])
def test_check_shardable_raises_as_jax(n_graph, compiled_for):
    for name in ("ising64", "kbc"):
        _, dgj, infoj = _graph(name, compiled_for)
        _, info = from_jax(dgj, infoj)
        try:
            jgs.check_shardable(infoj, n_graph)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            tgs.check_shardable(info, n_graph)
        else:
            with pytest.raises(ValueError) as got:
                tgs.check_shardable(info, n_graph)
            assert str(got.value) == want
    # a block of 8 rows does not split in 3
    dgj, infoj = jax_compile(jfx.ising_grid(3, 3), align=8)
    with pytest.raises(ValueError, match="not divisible by graph axis 3"):
        tgs.check_shardable(from_jax(dgj, infoj)[1], 3)


# ------------------------------------------------------- local streams

@pytest.mark.parametrize("n_graph", [2, 4])
@pytest.mark.parametrize("name", ["ising", "kbc", "sparse"])
def test_local_streams_equal_jax_split(name, n_graph):
    _, dgj, infoj = _graph(name, n_graph)
    dg, info = from_jax(dgj, infoj)
    two_d = tiers_2d(jax_to_device(dgj), infoj)
    specs = jgs._dg_specs(two_d)
    split = 0
    for g in range(n_graph):
        local = tgs.shard_device_graph(dg, info, n_graph, g, "cpu")
        for t, (ts, tsj, sp) in enumerate(zip(local.tiers, two_d.tiers,
                                               specs.tiers)):
            for f in ts._fields:
                want = np.asarray(getattr(tsj, f))
                if len(getattr(sp, f)) > 1 and getattr(sp, f)[1] == "graph":
                    want = np.split(want, n_graph, axis=1)[g]
                    split += 1
                got = getattr(ts, f).numpy()
                if f in FLAT_TIER_FIELDS:
                    got = got.reshape(info.n_colors, -1)
                assert got.dtype == want.dtype, (t, f)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"tier {t} {f}")
        for f in local._fields:
            if f != "tiers":
                np.testing.assert_array_equal(
                    getattr(local, f).numpy().reshape(-1),
                    np.asarray(getattr(dgj, f)).reshape(-1), err_msg=f)
    assert split > 0


@pytest.mark.parametrize("n_graph", [2, 4])
def test_own_rowmask_equals_jax(n_graph):
    for name in ("ising", "kbc"):
        _, dgj, infoj = _graph(name, n_graph)
        _, info = from_jax(dgj, infoj)
        P = dgj.var_card.shape[0]
        for g in range(n_graph):
            np.testing.assert_array_equal(
                tgs._own_rowmask(info, n_graph, g, P).numpy(),
                np.asarray(jgs._own_rowmask(infoj, n_graph, g, P)))


# --------------------------------------------------------- gradients

GRAD_CASES = [("ising", 2, "plain"), ("ising", 4, "off"),
              ("triple", 2, "plain"), ("potts", 2, "plain"),
              ("kbc", 2, "off"), ("sparse", 2, "off"),
              ("functions", 2, "off")]


def _worlds(dg, info, n_chains: int, seed: int):
    rng = np.random.default_rng(seed)
    card = np.maximum(np.asarray(dg.var_card), 1)[:, None]
    dt = np.int8 if info.max_card <= 127 else np.int32

    def one():
        v = (rng.integers(0, 1 << 20, (card.shape[0], n_chains)) % card)
        return v.astype(dt)

    return one(), one()


@pytest.mark.parametrize("lne", [False, True])
@pytest.mark.parametrize("name,n_graph,band", GRAD_CASES)
def test_sharded_gradient_sums_to_jax(name, n_graph, band, lne):
    """Owner records are disjoint across the ranks: the ranks' gradients
    on their local streams add up to JAX's unsharded gradient."""
    _, dgj, infoj = _graph(name, n_graph)
    dg, info = from_jax(dgj, infoj)
    v_ev, v_free = _worlds(dg, info, 5, 11)
    want = np.asarray(jmc.mc_weight_gradient_cs(
        jax_to_device(dgj), jnp.asarray(v_ev), jnp.asarray(v_free), lne,
        infoj, ("off", "off")))
    total = np.zeros_like(want)
    for g in range(n_graph):
        local = tgs.shard_device_graph(dg, info, n_graph, g, "cpu")
        total += tmc.mc_weight_gradient_cs(
            local, torch.from_numpy(v_ev), torch.from_numpy(v_free), lne,
            info, (band, "off"), n_graph=n_graph, g=g).numpy()
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(total, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["kbc", "kbc_cat"])
def test_hub_partial_sums_add_up(name):
    """The ranks' hub partial sums (delta or logits over the whole hub
    block) add up to the unsharded ones (float sums in another order:
    within 1e-5)."""
    n_graph = 2
    if name == "kbc":
        _, dgj, infoj = _graph("kbc", n_graph)
    else:
        from sampler_tpu.graph import FactorGraph

        g = _star(FactorGraph, 12, 3, 4)
        dgj, infoj = jax_compile(g, align=16, shards=n_graph, hub_cap=5,
                                 hub_chunk=2)
    dg, info = from_jax(dgj, infoj)
    assert info.has_hub
    d = to_device(dg, "cpu")
    v, _ = _worlds(dg, info, 3, 5)
    values = torch.from_numpy(v)
    t = len(info.tiers) - 1
    ti = info.tiers[t]
    folded = tmc.prepare_fold(d, d.w_init, info, ("off", "off"))
    for c in range(info.n_colors):
        whole = tmc.hub_partial(d, d.tiers[t], ti, values, d.w_init, c, info,
                                folded_t=folded and folded[t])
        parts = 0
        for g in range(n_graph):
            local = tgs.shard_device_graph(dg, info, n_graph, g, "cpu")
            fl = tmc.prepare_fold(local, local.w_init, info, ("off", "off"))
            parts = parts + tmc.hub_partial(local, local.tiers[t], ti,
                                            values, local.w_init, c, info,
                                            folded_t=fl and fl[t])
        np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=0,
                                   atol=1e-5)


# ------------------------------------------------------ whole runs

def _port(name, n_graph):
    g, dgj, infoj = _graph(name, n_graph)
    dg, info = from_jax(dgj, infoj)
    return g, dg, info


@pytest.fixture(scope="module")
def ranks():
    """ranks(n_chains, n_graph): CPU ranks of that mesh, kept open for the
    next test that asks for the same shape (a process holds the process
    group of one mesh at a time)."""
    pool = {}

    def get(n_chains, n_graph):
        if (n_chains, n_graph) not in pool:
            for r in pool.values():
                r.close()
            pool.clear()
            pool[n_chains, n_graph] = Ranks(make_mesh(
                n_chains, n_graph, ["cpu"] * (n_chains * n_graph)))
        return pool[n_chains, n_graph]

    yield get
    for r in pool.values():
        r.close()


@pytest.mark.parametrize("shape", [(4, 1), (1, 4), (2, 2)])
def test_graph_sharded_matches_oracle(shape, ranks):
    n_chains, n_graph = shape
    g = jfx.ising_grid(4, 4, w_pair=0.4, w_bias=0.2)
    dgj, infoj = jax_compile(g, align=8 * n_graph)
    dg, info = from_jax(dgj, infoj)
    marg = tgs.infer_gs(dg, dg.w_init, 0, 100, 1000, info, ranks(*shape),
                        max(4, 16 // n_chains))
    err = np.abs(marg[:, :2] - oracle.exact_marginals(
        fixtures.ising_grid(4, 4, w_pair=0.4, w_bias=0.2))).max()
    assert err < 0.015, f"max |dp| = {err:.4f}"


def test_graph_sharded_evidence(ranks):
    g = fixtures.all_functions_graph()
    dgj, infoj = jax_compile(jfx.all_functions_graph(), align=16, shards=2)
    dg, info = from_jax(dgj, infoj)
    marg = tgs.infer_gs(dg, dg.w_init, 1, 100, 1000, info, ranks(2, 2), 4)
    free = g.var_role == 0
    err = np.abs(marg[:, :2] - oracle.exact_marginals(g))[free].max()
    assert err < 0.015, f"max |dp| = {err:.4f}"


def test_graph_sharded_sparse_matches_oracle(ranks):
    g = fixtures.sparse_categorical_graph()
    dgj, infoj = jax_compile(jfx.sparse_categorical_graph(), align=32,
                             shards=4)
    dg, info = from_jax(dgj, infoj)
    assert info.has_sparse_cw
    marg = tgs.infer_gs(dg, dg.w_init, 0, 200, 2000, info, ranks(1, 4), 8)
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    mask = g.var_role == 0
    err = np.abs(marg[mask, :exact.shape[1]] - exact[mask]).max()
    assert err < 0.012, f"max |dp| = {err:.4f}"


def test_graph_sharded_fused_plain_matches_oracle(ranks):
    """The fused draw's plain version, world-write mode at a rank's rows,
    under sharding: an evidence-clamped banded grid against exact
    enumeration."""
    from sampler_tpu_torch.benchgraphs import big_ising_grid

    g, colors = big_ising_grid(16, 16, w_pair=0.3, w_bias=0.2)
    rng = np.random.default_rng(1)
    query = rng.permutation(g.n_vars)[:10]
    g.var_role[:] = jfs.ROLE_EVIDENCE
    g.var_role[query] = jfs.ROLE_QUERY
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    gj, _ = jbg.big_ising_grid(16, 16, w_pair=0.3, w_bias=0.2)
    gj.var_role[:], gj.var_init[:] = g.var_role, g.var_init
    dgj, infoj = jax_compile(gj, colors=colors, align=16, shards=2,
                             band_tile=8, band_min_block=1)
    dg, info = from_jax(dgj, infoj)
    assert info.affine2
    marg = tgs.infer_gs(dg, dg.w_init, 3, 100, 1000, info, ranks(2, 2), 8,
                        modes=("plain", "plain"))
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    err = np.abs(marg[query, :2] - exact[query]).max()
    assert err < 0.015, f"max |dp| = {err:.4f}"


@pytest.mark.parametrize("name,shape", [("ising", (2, 2)),
                                        ("sparse", (1, 4))])
def test_graph_sharded_learning_recovers_log_odds(name, shape, ranks):
    n_graph = shape[1]
    if name == "ising":
        g = jfx.labeled_coin_graph(n_flips=400, p_heads=0.75, seed=2)
        p = g.var_init.mean()
        want = np.array([np.log(p / (1 - p))])
    else:
        probs = (0.5, 0.2, 0.3)
        g = jfx.labeled_categorical_graph(n_obs=400, probs=probs, seed=2)
        freq = np.log(np.bincount(g.var_init, minlength=3) / g.n_vars)
        want = freq - freq[0]
    dgj, infoj = jax_compile(g, align=8 * n_graph, shards=n_graph)
    dg, info = from_jax(dgj, infoj)
    cfg = LearnConfig(n_epochs=300, stepsize=0.03, diminish=0.995,
                      regularization="none")
    w = tgs.learn_gs(dg, dg.w_init, 0, cfg, info, ranks(*shape), 4).numpy()
    if name == "ising":
        got = w[:1]
    else:
        assert float(w[-1]) == 0.0      # the reserved zero slot stays inert
        got = w[:3] - w[0]
    np.testing.assert_allclose(got, want, atol=0.15)


def _halo_grid(labelled: bool):
    g, colors = jbg.big_ising_grid(64, 64)
    if labelled:
        g.var_role[::2] = 1
        g.var_init[::2] = (np.arange((g.n_vars + 1) // 2) % 2).astype(
            np.int32)
    dgj, infoj = jax_compile(g, colors=colors, align=32, shards=4,
                             band_tile=128, band_min_block=1)
    assert jgs.halo_plan(dgj, infoj, 4) is not None
    return from_jax(dgj, infoj)


def _reduced_gradient_body(comm, host, info, n_chains, halo):
    """A rank body: the evidence world after two sweeps (graph-sharded on
    a graph axis), the free world as it starts, the mesh's gradient on
    them as learning reduces it (without and with learn_non_evidence),
    and both worlds gathered whole; rank 0's are returned."""
    from sampler_tpu_torch.engine.rng import chunk_generator
    from sampler_tpu_torch.parallel import chains

    if comm.mesh.n_graph > 1:
        d, modes = tgs._local(comm, host, info, None)
        shard = tgs.Shard(comm, info, halo)
    else:
        d, _, modes = chains._rank_setup(comm, host, host.w_init, info, None)
        shard = None
    gen = chunk_generator(13, "init", 0, comm.device, comm.row)
    v_ev = tmc.init_values_mc(d, gen, n_chains, info)
    v_free = tmc.init_values_mc(d, gen, n_chains, info)
    gen = chunk_generator(13, "sweep", 0, comm.device, comm.row, comm.g)
    folded = tmc.prepare_fold(d, d.w_init, info, modes)
    for _ in range(2):
        tmc.sweep_mc(d, v_ev, d.w_init, gen, False, info, folded, modes,
                     shard)
    grads = [chains.reduced_gradient(comm, d, v_ev, v_free, lne, info,
                                     modes, shard) for lne in (False, True)]
    return (grads, tgs._canonical(comm, v_ev, info, halo),
            tgs._canonical(comm, v_free, info, halo))


@pytest.mark.parametrize("name,shape", [("halo", (1, 4)), ("kbc", (2, 2)),
                                        ("ising", (2, 1))])
def test_reduced_gradient_equals_unsharded(name, shape, ranks):
    """The gradient learning applies on a mesh (each rank's on its local
    streams, summed over the graph group, averaged over the chains group)
    is the unsharded graph's on the chains rows' worlds side by side;
    under halo the gathered worlds and the gradients equal all-gather's
    bit for bit."""
    if name == "halo":
        dg, info = _halo_grid(True)
        halos = [tgs.halo_plan(dg, info, 4), None]
        assert halos[0] is not None
    else:
        _, dg, info = _port(name, shape[1])
        halos = [None]
    host = tgs.host_graph(dg)
    runs = [ranks(*shape).run(_reduced_gradient_body, host, info, 4, h)
            for h in halos]
    grads, ev, free = runs[0]
    assert ev.shape == (host.var_card.shape[0], 4 * shape[0])
    assert not torch.equal(ev, free)
    for lne, grad in zip((False, True), grads):
        want = tmc.mc_weight_gradient_cs(host, ev, free, lne, info,
                                         tmc.resolve_modes(info, "cpu"))
        assert float(want.abs().max()) > 0
        np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    for other in runs[1:]:
        for a, b in zip(grads + [ev, free], other[0] + list(other[1:])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("modes", [None, ("plain", "off"), ("off", "off")])
def test_halo_equals_all_gather(ranks, modes):
    dg, info = _halo_grid(False)
    kw = dict(n_burn=2, n_sweeps=30, info=info, mesh=ranks(1, 4),
              chains_per_device=4, modes=modes)
    m_halo = tgs.infer_gs(dg, dg.w_init, 5, halo="auto", **kw)
    m_full = tgs.infer_gs(dg, dg.w_init, 5, halo=None, **kw)
    np.testing.assert_array_equal(m_halo, m_full)
    assert 0.2 < m_halo[:, 1].mean() < 0.8


def test_halo_learning_equals_all_gather(ranks):
    dg, info = _halo_grid(True)
    cfg = LearnConfig(n_epochs=4, n_sweeps_per_epoch=1, stepsize=0.05,
                      regularization="l2", reg_param=0.01)
    kw = dict(cfg=cfg, info=info, mesh=ranks(1, 4), chains_per_device=4)
    w_halo = tgs.learn_gs(dg, dg.w_init, 5, halo="auto", **kw)
    w_full = tgs.learn_gs(dg, dg.w_init, 5, halo=None, **kw)
    np.testing.assert_array_equal(w_halo.numpy(), w_full.numpy())
    assert not np.array_equal(w_halo.numpy(), dg.w_init)


@pytest.mark.parametrize("halo", ["auto", None])
def test_infer_gs_chunked_and_resumed_match_single_call(ranks, halo):
    dg, info = _halo_grid(False)
    kw = dict(n_burn=4, n_sweeps=8, info=info, mesh=ranks(1, 4),
              chains_per_device=2, halo=halo)
    m1 = tgs.infer_gs(dg, dg.w_init, 3, **kw)
    saved = []
    m2 = tgs.infer_gs(dg, dg.w_init, 3, checkpoint_every=5,
                      on_checkpoint=lambda d, v, c: saved.append((d, v, c)),
                      **kw)
    np.testing.assert_array_equal(m1, m2)
    assert [d for d, _, _ in saved] == [5, 10, 12]
    assert saved[0][1].shape == (dg.var_card.shape[0], 2)
    m3 = tgs.infer_gs(dg, dg.w_init, 3, checkpoint_every=5,
                      resume_state=saved[0], **kw)
    np.testing.assert_array_equal(m1, m3)


def test_learn_gs_chunked_and_resumed_match_single_call(ranks):
    g = jfx.labeled_coin_graph(n_flips=200, p_heads=0.7, seed=3)
    dgj, infoj = jax_compile(g, align=16, shards=2)
    dg, info = from_jax(dgj, infoj)
    cfg = LearnConfig(n_epochs=8, stepsize=0.05, diminish=0.95,
                      regularization="l2", reg_param=0.01)
    kw = dict(cfg=cfg, info=info, mesh=ranks(2, 2), chains_per_device=2)
    w1 = tgs.learn_gs(dg, dg.w_init, 4, **kw)
    saved = []
    w2 = tgs.learn_gs(dg, dg.w_init, 4, checkpoint_every=3,
                      on_checkpoint=lambda *a: saved.append(a), **kw)
    w3 = tgs.learn_gs(dg, dg.w_init, 4, checkpoint_every=3,
                      resume_state=saved[0], **kw)
    assert [d for d, *_ in saved] == [3, 6, 8]
    assert saved[0][2].shape == (dg.var_card.shape[0], 4)
    np.testing.assert_array_equal(w1.numpy(), w2.numpy())
    np.testing.assert_array_equal(w1.numpy(), w3.numpy())


def _star(cls, n_leaves: int, card: int, seed: int):
    """tests/test_hub.py's star, as a ``cls`` graph (the JAX package's or
    the port's): a hub and n_leaves leaves, EQUAL couplings, ISTRUE
    biases."""
    rng = np.random.default_rng(seed)
    V = n_leaves + 1
    factors = [(jfs.FUNC_ISTRUE, 0, 1.0, [(v, True)]) for v in range(V)]
    factors += [(jfs.FUNC_EQUAL, 1, 1.0, [(0, True), (v, True)])
                for v in range(1, V)]
    g = cls.build(var_card=[card] * V, weights=[0.3, 0.4], factors=factors)
    if card > 2:
        g.var_dtype[:] = jfs.DTYPE_CATEGORICAL
        g.e_eqpred[:] = rng.integers(0, card, g.n_edges)
    return g


@pytest.mark.parametrize("card", [2, 3])
def test_hub_graph_sharded_oracle(card, ranks):
    """tests/test_hub.py's hub star at 2 graph ranks: the chunks split
    over the graph group, the partial row sums summed over it (JAX's
    bound, 0.02)."""
    from sampler_tpu.graph import FactorGraph as JaxFactorGraph
    from sampler_tpu_torch import FactorGraph

    gj = _star(JaxFactorGraph, 12, card, 1)
    dgj, infoj = jax_compile(gj, colors=jax_coloring.greedy_coloring(gj),
                             hub_cap=6, hub_chunk=4, align=16, shards=2)
    dg, info = from_jax(dgj, infoj)
    assert info.has_hub and info.tiers[-1].chunks % 2 == 0
    marg = tgs.infer_gs(dg, dg.w_init, 0, 100, 1000, info, ranks(2, 2), 8)
    exact = oracle.exact_marginals(_star(FactorGraph, 12, card, 1))
    err = np.abs(marg[:, :card] - exact).max()
    assert err < 0.02, f"card={card} hub gs marginal error {err}"


def test_hub_graph_sharded_learning(ranks):
    """learn_gs over a hub graph (all evidence): the weights move, stay
    finite and bounded under l2."""
    from sampler_tpu.graph import FactorGraph as JaxFactorGraph

    gj = _star(JaxFactorGraph, 14, 2, 2)
    rng = np.random.default_rng(2)
    gj.var_role[:] = 1
    gj.var_init[:] = rng.integers(0, 2, gj.n_vars)
    dgj, infoj = jax_compile(gj, colors=jax_coloring.greedy_coloring(gj),
                             hub_cap=6, hub_chunk=4, align=16, shards=2)
    dg, info = from_jax(dgj, infoj)
    assert info.has_hub
    cfg = LearnConfig(n_epochs=8, n_sweeps_per_epoch=1, stepsize=0.05,
                      diminish=0.98, regularization="l2", reg_param=0.01)
    w = tgs.learn_gs(dg, dg.w_init, 3, cfg, info, ranks(2, 2), 2).numpy()
    assert np.isfinite(w).all() and w.shape == dg.w_init.shape
    assert np.abs(w).max() < 5.0 and not np.array_equal(w, dg.w_init)
