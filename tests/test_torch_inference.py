"""The port's multi-chain inference against the JAX package and the oracle.

  * color_delta_bool and color_delta_multilin give the JAX package's
    log-odds (within 1e-5) on the same streams and world;
  * infer_mc on the CPU, fused and unfused, matches exact enumeration
    (|Δp| < 0.01) on the biased coin, an Ising chain, every boolean factor
    function with evidence, and an evidence-clamped banded grid;
  * with its default modes it also runs the fusedm graphs (arity 3 and
    multi-window: evidence-clamped triple grids with band_k 1 and 2, and a
    3-colored Ising grid) and matches exact enumeration within 0.01 on
    the fused and the unfused route at the same budget;
  * color_logits_mc gives the JAX package's candidate log-potentials
    (within 1e-5) on categorical, mixed, Potts and card-200 graphs, and
    infer_mc matches exact enumeration on the first, second and last of
    them, with int32 worlds and the band off at card 200;
  * sparse weights and graph sharding, which once raised here, run; a
    shard count that does not divide the card count exits; a hub tier
    beside sparse weights is refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import fixtures as jfx
from sampler_tpu.benchgraphs import big_potts_grid as jax_potts_grid
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu.graph import FactorGraph as JaxFactorGraph
from sampler_tpu_torch import FactorGraph, fixtures, oracle
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch.benchgraphs import big_ising_grid, big_triple_grid
from sampler_tpu_torch.compile import compile_graph, to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc

TOL = 0.01
N_CHAINS = 64
UNFUSED = ("plain", "off")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _evidence(g, n_query, seed):
    """Clamp all but ``n_query`` random variables of ``g`` to random
    labels, so the oracle stays enumerable."""
    rng = np.random.default_rng(seed)
    query = rng.choice(g.n_vars, n_query, replace=False)
    g.var_role[:] = fs.ROLE_EVIDENCE
    g.var_role[query] = fs.ROLE_QUERY
    g.var_init[:] = rng.integers(0, 2, g.n_vars)


def _evidence_grid(n_query=12, seed=1):
    """16x16 Ising grid that bands (band_tile=8), with all but n_query
    variables clamped."""
    g, colors = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    _evidence(g, n_query, seed)
    return g, colors


def _arity3_chain(n=40, seed=0):
    """Boolean chain of arity-1/2/3 factors over every function type that
    admits arity 3, negated literals included."""
    rng = np.random.default_rng(seed)
    funcs3 = [fs.FUNC_AND, fs.FUNC_OR, fs.FUNC_EQUAL, fs.FUNC_IMPLY_MLN,
              fs.FUNC_IMPLY_NATURAL, fs.FUNC_LINEAR, fs.FUNC_RATIO,
              fs.FUNC_LOGICAL]
    factors = [(fs.FUNC_ISTRUE, 0, 1.0, [(v, True)]) for v in range(n)]
    for i in range(n - 2):
        ar = 2 + (i % 2)
        mem = [(i + j, bool((i + j) % 3 != 0)) for j in range(ar)]
        factors.append((int(funcs3[i % len(funcs3)]), 1 + i % 2, 1.0, mem))
    g = FactorGraph.build(var_card=[2] * n, weights=[0.4, 0.3, -0.25],
                          factors=factors)
    g.var_role[:] = rng.random(n) < 0.4
    g.var_init[:] = rng.integers(0, 2, n)
    return g, None


def _triple_grid(rows, cols, n_query=14, seed=1):
    g, colors = big_triple_grid(rows, cols)
    _evidence(g, n_query, seed)
    return g, colors


def _ising_3color(n_query=12, seed=3):
    """32x32 Ising grid colored (r + c) % 3: pairwise, but 3 colors, so
    its tiles need two windows (band_k 2) and the fusedm path."""
    g, _ = big_ising_grid(32, 32, w_pair=0.35, w_bias=0.2)
    _evidence(g, n_query, seed)
    r, c = np.divmod(np.arange(g.n_vars), 32)
    return g, ((r + c) % 3).astype(np.int32)


MW = dict(band_tile=8, band_min_block=1, band_wmax=512)

DELTA_GRAPHS = {
    "evidence_grid": (_evidence_grid, dict(band_tile=8, band_min_block=1)),
    "triple_grid_mw": (lambda: _triple_grid(32, 32, seed=7), MW),
    "ising_3color": (_ising_3color, MW),
    "arity3_chain": (_arity3_chain, {}),
    "all_functions": (lambda: (jfx.all_functions_graph(), None), {}),
}


@pytest.mark.parametrize("name,band", [
    ("evidence_grid", "plain"), ("evidence_grid", "off"),
    ("arity3_chain", "off"), ("all_functions", "off"),
    ("triple_grid_mw", "plain"), ("ising_3color", "plain")])
def test_color_deltas_match_jax(name, band):
    make, kw = DELTA_GRAPHS[name]
    g, colors = make()
    jdg, jinfo = jax_compile(g, colors=colors, **kw)
    jdgd = jax_to_device(jdg)
    tdg, tinfo = from_jax(jdg, jinfo)
    tdg = to_device(tdg, "cpu")
    modes = (band, "off")
    jw = jnp.asarray(jdg.w_init)
    jfold = jmc.prepare_fold(jdgd, jw, jinfo, ("off", "off"))
    tfold = tmc.prepare_fold(tdg, tdg.w_init, tinfo, modes)
    P = jdg.var_card.shape[0]
    vals = np.random.default_rng(4).integers(0, 2, (P, 5)).astype(np.int8)
    tv = torch.from_numpy(vals)
    n_multilin = 0
    for t, ti in enumerate(tinfo.tiers):
        for c in range(tinfo.n_colors):
            ref = jmc.color_delta_bool(jdgd.tiers[t], jinfo.tiers[t],
                                       jnp.asarray(vals), jw, c, jinfo,
                                       ("off", "off"))
            out = tmc.color_delta_bool(tdg.tiers[t], ti, tv, tdg.w_init, c,
                                       tinfo, modes)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                       atol=1e-5)
            if ti.deltam:
                n_multilin += 1
                ref = jmc.color_delta_multilin(
                    jdgd.tiers[t], jinfo.tiers[t], jnp.asarray(vals), c,
                    jinfo, jfold[t], ("off", "off"))
                out = tmc.color_delta_multilin(tdg.tiers[t], ti, tv, c, tinfo,
                                               tfold[t], modes)
                np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                           rtol=0, atol=1e-5)
    assert n_multilin > 0


PARITY_GRAPHS = {
    "biased_coin": (lambda: (fixtures.biased_coin(1.5), None), {}, 2000),
    "ising_chain": (lambda: (fixtures.ising_chain(8, w_pair=0.6,
                                                  w_bias=0.25), None), {},
                    2000),
    "all_functions": (lambda: (fixtures.all_functions_graph(), None), {},
                      1500),
    "evidence_grid": (_evidence_grid, dict(band_tile=8, band_min_block=1),
                      2000),
}


@pytest.mark.parametrize("name", sorted(PARITY_GRAPHS))
@pytest.mark.parametrize("fused", [True, False])
def test_infer_mc_matches_oracle(name, fused):
    make, kw, n_sweeps = PARITY_GRAPHS[name]
    g, colors = make()
    dg, info = compile_graph(g, colors=colors, **kw)
    modes = tmc.resolve_modes(info, "cpu") if fused else UNFUSED
    if name == "evidence_grid":
        assert info.affine2 and modes == (("plain", "plain") if fused
                                          else UNFUSED)
    d = to_device(dg, "cpu")
    gen = torch.Generator().manual_seed(11)
    marg, values = tmc.infer_mc(d, d.w_init, gen, 200, n_sweeps, info,
                                N_CHAINS, modes=modes, device="cpu")
    assert values.shape == (dg.var_card.shape[0], N_CHAINS)
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    free = g.var_role == fs.ROLE_QUERY
    err = np.abs(marg[:, :2] - exact)[free].max()
    assert err < TOL, f"max |Δp| = {err:.4f}"


# name -> (graph maker, compile kwargs, band_k, arity)
FUSEDM_GRAPHS = {
    "triple16_k1": (lambda: _triple_grid(16, 16),
                    dict(band_tile=8, band_min_block=1), 1, 3),
    "triple32_k2": (lambda: _triple_grid(32, 32, n_query=12, seed=7), MW, 2,
                    3),
    "ising3_k2": (_ising_3color, MW, 2, 2),
}
FUSEDM_SWEEPS = 1200


@pytest.mark.parametrize("name", sorted(FUSEDM_GRAPHS))
@pytest.mark.parametrize("fused", [True, False])
def test_infer_mc_fusedm_matches_oracle(name, fused):
    make, kw, band_k, arity = FUSEDM_GRAPHS[name]
    g, colors = make()
    dg, info = compile_graph(g, colors=colors, **kw)
    ti = info.tiers[0]
    assert len(info.tiers) == 1 and ti.fusedm and not ti.affine2
    assert (ti.band_k, ti.arity) == (band_k, arity)
    assert tmc.resolve_modes(info, "cpu") == ("plain", "plain")
    d = to_device(dg, "cpu")
    gen = torch.Generator().manual_seed(3)
    marg, values = tmc.infer_mc(d, d.w_init, gen, 200, FUSEDM_SWEEPS, info,
                                N_CHAINS, modes=None if fused else UNFUSED,
                                device="cpu")
    assert values.shape == (dg.var_card.shape[0], N_CHAINS)
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    free = g.var_role == fs.ROLE_QUERY
    err = np.abs(marg[:, :2] - exact)[free].max()
    assert err < TOL, f"max |Δp| = {err:.4f}"


def test_fusedm_routes_count_no_kernel_launch_on_cpu(monkeypatch):
    """The default modes draw through fused_dm_draw's plain version, the
    unfused modes gather through banded_gather_multi's; the CPU counts no
    launch."""
    from sampler_tpu_torch.ops.banded import banded_gather_multi
    from sampler_tpu_torch.ops.fused import fused_dm_draw

    make, kw, _, _ = FUSEDM_GRAPHS["triple32_k2"]
    g, colors = make()
    dg, info = compile_graph(g, colors=colors, **kw)
    d = to_device(dg, "cpu")
    calls = {"draw": 0, "gather": 0}
    for name, key in (("fused_dm_draw_plain", "draw"),
                      ("banded_gather_multi_plain", "gather")):
        orig = getattr(tmc, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(tmc, name, counted)
    before = (fused_dm_draw.launches, banded_gather_multi.launches)
    C = info.n_colors
    tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(0), 1, 2, info, 4,
                 device="cpu")
    assert calls == {"draw": 3 * C, "gather": 0}
    tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(0), 1, 2, info, 4,
                 modes=UNFUSED, device="cpu")
    assert calls == {"draw": 3 * C, "gather": 3 * C}
    assert (fused_dm_draw.launches, banded_gather_multi.launches) == before


def test_init_values_mc_rows_and_rates(monkeypatch):
    """Evidence rows keep their labels in every chain, query rows are
    uniform over var_card, and the chunked draw covers every row."""
    g, colors = _evidence_grid(n_query=200, seed=2)
    dg, info = compile_graph(g, colors=colors)
    d = to_device(dg, "cpu")
    monkeypatch.setattr(tmc, "INIT_CHUNK_ELEMS", 3 * 256 + 5)  # ragged
    v = tmc.init_values_mc(d, torch.Generator().manual_seed(1), 256, info)
    assert v.dtype == torch.int8 and v.shape == (dg.var_card.shape[0], 256)
    role = torch.from_numpy(np.asarray(dg.var_role))
    card = torch.from_numpy(np.asarray(dg.var_card))
    ev = role == fs.ROLE_EVIDENCE
    labels = torch.from_numpy(np.asarray(dg.var_init)).to(torch.int8)
    assert bool((v[ev] == labels[ev, None]).all())
    q = (role == fs.ROLE_QUERY) & (card == 2)
    assert int(q.sum()) == 200
    assert abs(float(v[q].double().mean()) - 0.5) < 0.01
    # every query row, the last block's included, was drawn
    assert bool((v[q].double().mean(dim=1) > 0.3).all())


def test_fused_path_counts_no_kernel_launch_on_cpu():
    from sampler_tpu_torch.ops.banded import banded_gather
    from sampler_tpu_torch.ops.fused import fused_color_draw

    g, colors = _evidence_grid()
    dg, info = compile_graph(g, colors=colors, band_tile=8, band_min_block=1)
    d = to_device(dg, "cpu")
    before = (fused_color_draw.launches, banded_gather.launches)
    tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(0), 2, 3, info, 4,
                 device="cpu")
    assert (fused_color_draw.launches, banded_gather.launches) == before


def test_cuda_mode_on_cpu_raises():
    g, colors = _evidence_grid()
    dg, info = compile_graph(g, colors=colors, band_tile=8, band_min_block=1)
    d = to_device(dg, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tmc.infer_mc(d, d.w_init, torch.Generator(), 1, 1, info, 4,
                     modes=("cuda", "cuda"), device="cpu")


@pytest.mark.parametrize("make", [
    lambda: fixtures.sparse_categorical_graph(),
], ids=["sparse_categorical"])
def test_outside_slice_raises(make, tmp_path, monkeypatch):
    """Sparse per-combination weights, which raised here before they were
    ported, run, and so does graph sharding (the command line's
    --n_graph_shards above 1), which raised until it was ported; what
    still exits is a shard count that does not divide the card count
    (three cards pretended)."""
    from sampler_tpu_torch import cli
    from sampler_tpu_torch.io import binary, results

    g = make()
    dg, info = compile_graph(g)
    d = to_device(dg, "cpu")
    marg, _ = tmc.infer_mc(d, d.w_init, torch.Generator(), 1, 1, info, 4,
                           device="cpu")
    assert marg.shape == (g.n_vars, info.max_card)
    meta = binary.write_graph(g, str(tmp_path))
    args = ["gibbs", "-w", "-", "-v", "-", "-f", "-", "-m", meta, "-o",
            str(tmp_path / "out"), "--n_graph_shards", "2", "-i", "50",
            "--quiet"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    parsed = results.read_marginals(
        str(tmp_path / "out" / "inference_result.out.text"))
    assert {v for v, _, _ in parsed} == set(range(g.n_vars))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(SystemExit, match="does not divide the 3"):
        cli.main(args)


def test_hub_graph_raises():
    """A star whose centre has more incident factors than hub_cap compiles
    to a hub tier; only sparse per-combination weights beside a hub tier
    raise, as in the JAX package."""
    n = 12
    factors = [(fs.FUNC_EQUAL, 0, 1.0, [(0, True), (v, True)])
               for v in range(1, n)]
    g = FactorGraph.build(var_card=[2] * n, weights=[0.3], factors=factors)
    _, info = compile_graph(g, hub_cap=4)
    assert info.has_hub and info.tiers[-1].hub
    with pytest.raises(ValueError, match="hub"):
        compile_graph(fixtures.sparse_categorical_graph(), hub_cap=0)


def _big_card_graph(graph_cls, card=200):
    """tests/test_large_card.py's graph: 3 variables of cardinality 200, a
    biased unary on v0 and EQUAL couplings, v2 clamped to 150."""
    factors = [
        (fs.FUNC_AND_CATEGORICAL, 0, 1.0, [(0, True, 7)]),
        (fs.FUNC_EQUAL, 1, 1.0, [(0, True, 3), (1, True, 3)]),
        (fs.FUNC_EQUAL, 1, 1.0, [(1, True, 150), (2, True, 150)]),
    ]
    g = graph_cls.build(var_card=[card] * 3, weights=[1.2, 0.8],
                        factors=factors)
    g.var_dtype[:] = fs.DTYPE_CATEGORICAL
    g.var_role[2] = fs.ROLE_EVIDENCE
    g.var_init[2] = 150
    return g, None


def _potts_evidence(make, card=3, n_query=8, seed=5):
    """tests/test_fused_cat.py's 16x16 oracle grid."""
    g, colors = make(16, 16, card=card, seed=seed)
    rng = np.random.default_rng(seed)
    query = rng.choice(g.n_vars, n_query, replace=False)
    g.var_role[:] = fs.ROLE_EVIDENCE
    g.var_role[query] = fs.ROLE_QUERY
    g.var_init[:] = rng.integers(0, card, g.n_vars)
    return g, colors


# name -> (graph maker given the JAX package's fixtures, benchgraphs and
# FactorGraph, compile kwargs)
CAT_GRAPHS = {
    "categorical": (lambda fx, bg, fg: (fx.categorical_graph(n=5, card=3),
                                        None), {}),
    "mixed": (lambda fx, bg, fg: (fx.mixed_graph(), None), {}),
    "potts_grid": (lambda fx, bg, fg: _potts_evidence(bg),
                   dict(band_tile=8, band_min_block=1)),
    "card200": (lambda fx, bg, fg: _big_card_graph(fg), {}),
}


@pytest.mark.parametrize("name", sorted(CAT_GRAPHS))
def test_color_logits_match_jax(name):
    make, kw = CAT_GRAPHS[name]
    g, colors = make(jfx, jax_potts_grid, JaxFactorGraph)
    jdg, jinfo = jax_compile(g, colors=colors, **kw)
    jdgd = jax_to_device(jdg)
    tdg, tinfo = from_jax(jdg, jinfo)
    tdg = to_device(tdg, "cpu")
    assert not tinfo.all_boolean
    modes = (tmc.resolve_modes(tinfo, "cpu")[0], "off")
    assert modes[0] == ("plain" if name == "potts_grid" else "off")
    card = np.asarray(jdg.var_card)
    vals = (np.random.default_rng(6).integers(0, 1 << 20, (card.shape[0], 5))
            % np.maximum(card, 1)[:, None])
    dt = tmc.values_dtype(tinfo)
    assert (dt == torch.int32) == (name == "card200")
    tv = torch.from_numpy(vals).to(dt)
    jv = jnp.asarray(tv.numpy())
    jw = jnp.asarray(jdg.w_init)
    for t, ti in enumerate(tinfo.tiers):
        for c in range(tinfo.n_colors):
            ref = jmc.color_logits_mc(jdgd, jdgd.tiers[t], jinfo.tiers[t], jv,
                                      jw, c, jinfo, ("off", "off"))
            out = tmc.color_logits_mc(tdg, tdg.tiers[t], ti, tv, tdg.w_init,
                                      c, tinfo, modes)
            assert out.shape == ref.shape == (ti.block, tinfo.max_card, 5)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                       atol=1e-5)
            # a row range gives the same rows
            half = ti.block // 2
            part = tmc.color_logits_mc(tdg, tdg.tiers[t], ti, tv, tdg.w_init,
                                       c, tinfo, modes, half,
                                       ti.block - half)
            assert torch.equal(part, out[half:])


# name -> (graph maker, sweeps); the burn-in is 200 sweeps
CAT_PARITY = {
    "categorical": (lambda: (fixtures.categorical_graph(n=5, card=3), None),
                    1500),
    "mixed": (lambda: (fixtures.mixed_graph(), None), 1500),
    "card200": (lambda: _big_card_graph(FactorGraph), 800),
}


@pytest.mark.parametrize("name", sorted(CAT_PARITY))
@pytest.mark.parametrize("fused", [True, False])
def test_infer_mc_categorical_matches_oracle(name, fused):
    """The general candidate path on the CPU (these graphs do not band,
    so the default modes and fused off take it alike)."""
    make, n_sweeps = CAT_PARITY[name]
    g, colors = make()
    dg, info = compile_graph(g, colors=colors)
    modes = tmc.resolve_modes(info, "cpu") if fused else UNFUSED
    assert not info.affinek
    d = to_device(dg, "cpu")
    marg, values = tmc.infer_mc(d, d.w_init,
                                torch.Generator().manual_seed(2), 200,
                                n_sweeps, info, N_CHAINS, modes=modes,
                                device="cpu")
    K = info.max_card
    assert marg.shape == (g.n_vars, K)
    assert values.dtype == (torch.int32 if K > 127 else torch.int8)
    card = d.var_card[:, None]
    assert bool((values >= 0).all() and (values < card).all())
    np.testing.assert_allclose(marg.sum(axis=1), 1.0, atol=1e-5)
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    free = g.var_role == fs.ROLE_QUERY
    err = np.abs(marg[:, :exact.shape[1]] - exact)[free].max()
    assert err < TOL, f"max |Δp| = {err:.4f}"


def test_card200_worlds_are_int32_and_band_off():
    g, _ = _big_card_graph(FactorGraph)
    dg, info = compile_graph(g)
    assert info.max_card == 200
    assert tmc.values_dtype(info) == torch.int32
    assert tmc.resolve_modes(info, "cpu") == ("off", "off")
    d = to_device(dg, "cpu")
    v = tmc.init_values_mc(d, torch.Generator().manual_seed(0), 512, info)
    assert v.dtype == torch.int32
    pos = d.pos_of_vid
    assert int(v[pos[:2]].max()) > 127 and bool((v[pos[2]] == 150).all())


@pytest.mark.parametrize("K,NC", [(3, 5), (16, 7), (17, 3), (200, 9)])
def test_tally_counts_every_value(monkeypatch, K, NC):
    monkeypatch.setattr(tmc, "INIT_CHUNK_ELEMS", 40)        # many blocks
    gen = torch.Generator().manual_seed(K)
    v = torch.randint(0, K, (53, NC), generator=gen,
                      dtype=torch.int8 if K <= 127 else torch.int32)
    counts = torch.ones((K, 53), dtype=torch.int32)
    tmc.tally(counts, v)
    ref = torch.stack([(v == k).sum(dim=1) for k in range(K)]).to(torch.int32)
    assert torch.equal(counts, ref + 1)
