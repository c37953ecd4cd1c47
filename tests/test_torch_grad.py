"""The port's weight gradient against the JAX package's.

  * grad_pair_tile_plain gives, tile by tile, the partials of JAX
    grad_pair_tile in interpret mode on identical streams and worlds;
  * mc_weight_gradient_cs on its kernel route (band "plain"), its chunked
    route (row_chunk) and its band-"off" route, and the per-factor
    _mc_weight_gradient_factors, equal JAX _mc_weight_gradient_factors and
    JAX mc_weight_gradient_cs on its interpret-mode kernel route, on the
    graphs of tests/test_grad_kernel.py and on random arity-3 graphs.
Tolerance 1e-4 absolute: the routes add the same float32 terms in other
orders (the kernel route's moments are exact integers).  The CUDA kernel
is held to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import fixtures as jfx
from sampler_tpu import format_spec as fs
from sampler_tpu.benchgraphs import big_ising_grid
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu.graph import FactorGraph
from sampler_tpu.ops.grad import grad_pair_tile as jax_grad_pair_tile
from sampler_tpu_torch.compile import to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.ops.grad import (GRAD_W_MAX, grad_pair_tile,
                                        grad_pair_tile_plain)

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ising(seed=3):
    g, colors = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    rng = np.random.default_rng(seed)
    g.var_role[:] = rng.random(g.n_vars) < 0.5
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    return g, colors


def _pairwise(funcs, unary, seed):
    """16x16 grid of pairwise factors of the given functions (negated
    literals included) plus one unary factor a variable."""
    rng = np.random.default_rng(seed)
    rows = cols = 16
    V = rows * cols
    factors = [(int(unary[v % len(unary)]), 0, 1.0, [(v, bool(v % 3 != 0))])
               for v in range(V)]
    for r in range(rows):
        for c in range(cols - 1):
            v = r * cols + c
            factors.append((int(funcs[(r + c) % len(funcs)]), 1, 1.0,
                            [(v, bool((r + c) % 3 != 0)), (v + 1, True)]))
    g = FactorGraph.build(var_card=[2] * V, weights=[0.3, 0.5],
                          factors=factors)
    g.var_role[:] = rng.random(V) < 0.5
    g.var_init[:] = rng.integers(0, 2, V)
    return g, np.tile(np.arange(cols) % 2, rows).astype(np.int32)


def _variants():
    return _pairwise([fs.FUNC_IMPLY_MLN, fs.FUNC_IMPLY_NATURAL,
                      fs.FUNC_LINEAR, fs.FUNC_RATIO, fs.FUNC_LOGICAL,
                      fs.FUNC_OR], [fs.FUNC_ISTRUE], seed=4)


def _unary():
    return _pairwise([fs.FUNC_AND], [fs.FUNC_AND, fs.FUNC_OR, fs.FUNC_EQUAL,
                                     fs.FUNC_ISTRUE], seed=11)


BANDED = {"ising": _ising, "imply_linear_variants": _variants,
          "unary_counts": _unary}
GRAPHS = dict(BANDED, **{
    f"random_arity3_seed{s}": (lambda s=s: (jfx.random_boolean_graph(
        40, 90, max_arity=3, seed=s, evidence_frac=0.3), None))
    for s in range(3)})


def _compile(name, device="cpu"):
    g, colors = GRAPHS[name]()
    kw = dict(band_tile=8, band_min_block=1) if name in BANDED else {}
    jdg, jinfo = jax_compile(g, colors=colors, **kw)
    assert jinfo.affine2 == (name in BANDED)
    tdg, tinfo = from_jax(jdg, jinfo)
    return jdg, jinfo, to_device(tdg, device), tinfo


def _worlds(P, NC, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, (P, NC)).astype(np.int8) for _ in range(2)]


@pytest.mark.parametrize("NC", [4, 128])
@pytest.mark.parametrize("coef", ["gd_ctch", "gd_cown"])
def test_plain_partials_match_jax_interpret(NC, coef):
    jdg, jinfo, tdg, tinfo = _compile("ising")
    jts, ti = jdg.tiers[0], jinfo.tiers[0]
    ts = tdg.tiers[0]
    W = jdg.w_init.shape[0]
    v_ev, v_free = _worlds(tdg.var_card.shape[0], NC, seed=NC)
    v_both = jnp.asarray(np.concatenate([v_ev, v_free], axis=1))
    for c in range(jinfo.n_colors):
        own0 = c * jinfo.block_size + ti.off
        ref = np.asarray(jax_grad_pair_tile(
            v_both, jnp.asarray(jts.bd_nbr), jnp.asarray(jts.bd_start[c]),
            jnp.asarray(jts.gd_wid), jnp.asarray(getattr(jts, coef)),
            jnp.asarray(jts.gd_ao), jnp.asarray(jts.gd_an),
            jnp.asarray(jts.gd_ax), c, own0=own0, W=ti.band_w,
            TB=ti.band_tb, D=ti.degree, n_weights=W, interpret=True))
        part = grad_pair_tile_plain(
            torch.from_numpy(v_ev), torch.from_numpy(v_free), ts.bd_nbr,
            ts.bd_start[c], ts.gd_wid, getattr(ts, coef), ts.gd_ao,
            ts.gd_an, ts.gd_ax, c, own0, ti.band_w, ti.band_tb, ti.degree, W)
        assert part.shape == (ref.shape[0], W)
        per_tile = ref.sum(axis=1)
        np.testing.assert_allclose(part.numpy(), per_tile[:, :W], rtol=0,
                                   atol=ATOL)
        assert not per_tile[:, W:].any()
        assert np.abs(per_tile).max() > 1.0       # the moments are not all 0


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    _, _, tdg, tinfo = _compile("ising")
    ts, ti = tdg.tiers[0], tinfo.tiers[0]
    v_ev, v_free = (torch.from_numpy(v) for v in
                    _worlds(tdg.var_card.shape[0], 6, seed=2))
    args = (v_ev, v_free, ts.bd_nbr, ts.bd_start[1], ts.gd_wid, ts.gd_ctch,
            ts.gd_ao, ts.gd_an, ts.gd_ax, 1, tinfo.block_size + ti.off,
            ti.band_w, ti.band_tb, ti.degree, 2)
    before = grad_pair_tile.launches
    assert torch.equal(grad_pair_tile(*args), grad_pair_tile_plain(*args))
    assert grad_pair_tile.launches == before


def test_out_of_contract_shapes_raise():
    _, _, tdg, tinfo = _compile("ising")
    ts, ti = tdg.tiers[0], tinfo.tiers[0]
    v = torch.zeros((tdg.var_card.shape[0], 4), dtype=torch.int8)
    base = [v, v, ts.bd_nbr, ts.bd_start[0], ts.gd_wid, ts.gd_ctch, ts.gd_ao,
            ts.gd_an, ts.gd_ax, 0, ti.off, ti.band_w, ti.band_tb, ti.degree]
    with pytest.raises(ValueError):
        grad_pair_tile(*base, GRAD_W_MAX + 1)
    with pytest.raises(ValueError):                   # own rows past P
        grad_pair_tile(*base[:10], v.shape[0], *base[11:], 2)
    with pytest.raises(ValueError):                   # worlds differ
        grad_pair_tile(v, v[:, :2], *base[2:], 2)


@pytest.mark.parametrize("lne", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_gradient_routes_match_jax(name, lne):
    jdg, jinfo, tdg, tinfo = _compile(name)
    jd = jax_to_device(jdg)
    v_ev, v_free = _worlds(tdg.var_card.shape[0], 4, seed=len(name))
    jv_ev, jv_free = jnp.asarray(v_ev), jnp.asarray(v_free)
    refs = {
        "jax_factors": jmc._mc_weight_gradient_factors(jd, jv_ev, jv_free,
                                                       lne, jinfo),
        "jax_kernel": jmc.mc_weight_gradient_cs(jd, jv_ev, jv_free, lne,
                                                jinfo, ("interpret", "off")),
    }
    t_ev, t_free = torch.from_numpy(v_ev), torch.from_numpy(v_free)
    chunk = max([ti.band_tb for ti in tinfo.tiers] + [1])
    assert all(ti.block % chunk == 0 for ti in tinfo.tiers)
    ours = {
        "kernel": tmc.mc_weight_gradient_cs(tdg, t_ev, t_free, lne, tinfo,
                                            ("plain", "off")),
        "chunked": tmc.mc_weight_gradient_cs(tdg, t_ev, t_free, lne, tinfo,
                                             ("plain", "off"),
                                             row_chunk=chunk),
        "band_off": tmc.mc_weight_gradient_cs(tdg, t_ev, t_free, lne, tinfo,
                                              ("off", "off")),
        "factors": tmc._mc_weight_gradient_factors(tdg, t_ev, t_free, lne,
                                                   tinfo),
    }
    assert float(np.abs(np.asarray(refs["jax_factors"])).max()) > 0.01
    for rname, ref in refs.items():
        for oname, got in ours.items():
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=ATOL,
                                       err_msg=f"{oname} vs {rname}")


def test_kernel_route_engages_only_where_jax_takes_it(monkeypatch):
    """The kernel route runs for an affine2 tier with the band on and no
    row_chunk, and for nothing else."""
    _, _, tdg, tinfo = _compile("ising")
    calls = []
    orig = tmc.grad_pair_tile_plain
    monkeypatch.setattr(tmc, "grad_pair_tile_plain",
                        lambda *a: calls.append(1) or orig(*a))
    v = torch.zeros((tdg.var_card.shape[0], 4), dtype=torch.int8)
    for modes, chunk, n in ((("plain", "off"), None, tinfo.n_colors),
                            (("plain", "off"), 8, 0),
                            (("off", "plain"), None, 0)):
        calls.clear()
        tmc.mc_weight_gradient_cs(tdg, v, v, False, tinfo, modes,
                                  row_chunk=chunk)
        assert len(calls) == n, (modes, chunk)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("NC", [4, 20, 128])
def test_kernel_matches_plain_on_card(cuda_device, NC):
    _, _, tdg, tinfo = _compile("imply_linear_variants", cuda_device)
    ts, ti = tdg.tiers[0], tinfo.tiers[0]
    v_ev, v_free = (torch.from_numpy(v).to(cuda_device) for v in
                    _worlds(tdg.var_card.shape[0], NC, seed=NC))
    for lne in (False, True):
        coef = ts.gd_cown if lne else ts.gd_ctch
        for c in range(tinfo.n_colors):
            args = (v_ev, v_free, ts.bd_nbr, ts.bd_start[c], ts.gd_wid, coef,
                    ts.gd_ao, ts.gd_an, ts.gd_ax, c,
                    c * tinfo.block_size + ti.off, ti.band_w, ti.band_tb,
                    ti.degree, 2)
            got, ref = grad_pair_tile(*args), grad_pair_tile_plain(*args)
            torch.cuda.synchronize()
            scale = max(float(ref.abs().max()), 1.0)
            assert float((got - ref).abs().max()) <= 1e-5 * scale
        g_k = tmc.mc_weight_gradient_cs(tdg, v_ev, v_free, lne, tinfo,
                                        ("cuda", "off"))
        g_f = tmc._mc_weight_gradient_factors(tdg, v_ev, v_free, lne, tinfo)
        assert float((g_k - g_f).abs().max()) <= ATOL
