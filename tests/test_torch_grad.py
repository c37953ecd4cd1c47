"""The port's weight gradient against the JAX package's.

  * grad_pair_tile_plain gives, tile by tile, the partials of JAX
    grad_pair_tile in interpret mode on identical streams and worlds;
  * grad_pair_tile_plain gives a float64 numpy definition of the partials
    on random streams at the shapes the CUDA kernel's variants split on
    (chains a world 256, 512, 48 and 37; D = 1..9; 1, 2 and 64 weights;
    window starts unaligned and clipped to P - W; neighbours below, inside
    and past the window and at or past P; weight ids -1 and >= n_weights),
    to within its one float32 rounding, and the partials of JAX
    grad_pair_tile in interpret mode on such streams inside the JAX
    kernel's contract (starts on the 256 grid, weight ids in range);
  * mc_weight_gradient_cs (grad_pair_tile on the affine2 tiers that
    ``route`` sends there), the records route on every tier
    (grad_records_sum, as under graph sharding) and the per-factor
    _mc_weight_gradient_factors equal JAX _mc_weight_gradient_factors and
    JAX mc_weight_gradient_cs on its interpret-mode kernel route, on the
    graphs of tests/test_grad_kernel.py and on random arity-3 graphs.
Tolerance 1e-4 absolute: the routes add the same float32 terms in other
orders (the kernel route's moments are exact integers).  Against JAX's
float32 kernel on random streams, 1e-5 relative to the largest |partial|.
The CUDA kernel is held to the plain version on the card, every variant
(also streams and worlds off the 16-byte grid, and tiles staged in groups
of rows), within 1e-5 relative, and two launches bit for bit.
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


def _streams(NC, D, n_weights, seed, TB=8, ntiles=6, W=200, P=1000, C=2,
             jax_contract=False):
    """Random streams of an affine2 tier of C colors and two random 0/1
    worlds [P, NC].  By default window starts anywhere in [0, P - W], every
    other one clipped to P - W; neighbours from 40 below the window to 40
    past it (past P where the window is clipped), 5% of them at or past P
    and 5% negative; weight ids in [0, n_weights), 5% of them -1 and 5% in
    [n_weights, n_weights + 3).  With ``jax_contract``, starts on the 256
    grid and weight ids in range only.  Returns (worlds, nbr, starts [C,
    ntiles], wid, coef, ao, an, ax, own0 of each color) as numpy."""
    rng = np.random.default_rng(seed)
    shape = (C, ntiles, D * TB)
    if jax_contract:
        starts = rng.integers(0, (P - W) // 256 + 1, (C, ntiles)) * 256
    else:
        starts = rng.integers(0, P - W + 1, (C, ntiles))
        starts[:, ::2] = P - W
    nbr = starts[:, :, None] + rng.integers(-40, W + 40, shape)
    u = rng.random(shape)
    nbr[u < 0.05] = P + rng.integers(0, 3, shape)[u < 0.05]
    if jax_contract:
        nbr = np.maximum(nbr, 0)
    else:
        nbr[(u >= 0.05) & (u < 0.1)] = -1 - rng.integers(0, 3, shape)[
            (u >= 0.05) & (u < 0.1)]
    wid = rng.integers(0, n_weights, shape)
    if not jax_contract:
        u = rng.random(shape)
        wid[u < 0.05] = -1
        wid[u > 0.95] = n_weights + rng.integers(0, 3, shape)[u > 0.95]
    coef, ao, an, ax = (rng.normal(0, s, shape).astype(np.float32)
                        for s in (1.0, 0.7, 0.5, 0.3))
    worlds = [rng.integers(0, 2, (P, NC)).astype(np.int8) for _ in range(2)]
    own0 = [8 * c * (ntiles * TB // 8 + 1) for c in range(C)]
    assert own0[-1] + ntiles * TB <= P
    return (worlds, nbr.astype(np.int32), starts.astype(np.int32),
            wid.astype(np.int32), coef, ao, an, ax, own0)


def _numpy_partials(v_ev, v_free, nbr, starts, wid, coef, ao, an, ax, c,
                    own0, W, TB, D, n_weights):
    """The partials by their definition, in float64 (moments in int64)."""
    P = v_ev.shape[0]
    nt = starts.shape[0]
    ev, fr = v_ev.astype(np.int64), v_free.astype(np.int64)
    out = np.zeros((nt, n_weights))
    for t in range(nt):
        rows = slice(own0 + t * TB, own0 + (t + 1) * TB)
        So = ev[rows].sum(1) - fr[rows].sum(1)                  # [TB]
        idx = nbr[c, t].reshape(D, TB).astype(np.int64)
        ok = ((idx >= starts[t]) & (idx < starts[t] + W) & (idx >= 0)
              & (idx < P))
        row = np.where(ok, idx, 0)
        ne = np.where(ok[..., None], ev[row], 0)                # [D, TB, NC]
        nf = np.where(ok[..., None], fr[row], 0)
        Sn = ne.sum(-1) - nf.sum(-1)
        Sx = (ev[rows][None] * ne).sum(-1) - (fr[rows][None] * nf).sum(-1)

        def rec(x):
            return x[c, t].reshape(D, TB).astype(np.float64)

        val = rec(coef) * (rec(ao) * So + rec(an) * Sn + rec(ax) * Sx)
        w = wid[c, t].reshape(D, TB)
        keep = (w >= 0) & (w < n_weights)
        np.add.at(out[t], w[keep], val[keep])
    return out


def _plain_on(streams, c, W, TB, D, n_weights, device="cpu"):
    worlds, nbr, starts, wid, coef, ao, an, ax, own0 = streams

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return (T(worlds[0]), T(worlds[1]), T(nbr), T(starts[c]), T(wid),
            T(coef), T(ao), T(an), T(ax), c, own0[c], W, TB, D, n_weights)


@pytest.mark.parametrize("D", range(1, 10))
@pytest.mark.parametrize("NC", [256, 512, 48, 37])
def test_plain_partials_match_numpy_definition(NC, D):
    for k, n_weights in enumerate((1, 2, 64)):
        s = _streams(NC, D, n_weights, seed=100 * D + NC + k)
        assert (s[1] >= 1000).any() and (s[1] < 0).any()
        for c in range(2):
            args = _plain_on(s, c, 200, 8, D, n_weights)
            got = grad_pair_tile_plain(*args).numpy()
            worlds, nbr, starts, *recs, own0 = s
            ref = _numpy_partials(*worlds, nbr, starts[c], *recs, c,
                                  own0[c], 200, 8, D, n_weights)
            scale = float(np.abs(ref).max())
            assert scale > 1.0                # the moments are not all 0
            # one float32 rounding of a float64 sum apart
            np.testing.assert_allclose(got, ref, rtol=1e-6,
                                       atol=1e-12 * scale)


@pytest.mark.parametrize("D,NC,n_weights", [(1, 16, 1), (5, 16, 2),
                                            (9, 48, 64), (4, 37, 2)])
def test_plain_matches_jax_interpret_on_random_streams(D, NC, n_weights):
    W, TB, P = 256, 8, 1024
    s = _streams(NC, D, n_weights, seed=7 * D + NC, TB=TB, ntiles=8, W=W,
                 P=P, jax_contract=True)
    worlds, nbr, starts, wid, coef, ao, an, ax, own0 = s
    v_both = jnp.asarray(np.concatenate(worlds, axis=1))
    for c in range(2):
        ref = np.asarray(jax_grad_pair_tile(
            v_both, jnp.asarray(nbr), jnp.asarray(starts[c]),
            jnp.asarray(wid), jnp.asarray(coef), jnp.asarray(ao),
            jnp.asarray(an), jnp.asarray(ax), c, own0=own0[c], W=W, TB=TB,
            D=D, n_weights=n_weights, interpret=True)).sum(axis=1)
        got = grad_pair_tile_plain(*_plain_on(s, c, W, TB, D,
                                              n_weights)).numpy()
        scale = float(np.abs(ref).max())
        assert scale > 1.0
        np.testing.assert_allclose(got, ref[:, :n_weights], rtol=0,
                                   atol=1e-5 * scale)
        assert not ref[:, n_weights:].any()


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
    every_tier = tmc._record_plan(tdg, tinfo, range(len(tinfo.tiers)), lne,
                                  1, 0)
    ours = {
        "kernel": tmc.mc_weight_gradient_cs(tdg, t_ev, t_free, lne, tinfo),
        "records": tmc.grad_records_sum(t_ev, t_free, every_tier),
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
    """The kernel route runs for a banded affine2 tier, which ``route``
    sends there, one call a color, unsharded, and for nothing else."""
    _, _, tdg, tinfo = _compile("ising")
    assert [tmc.route(ti, tinfo) for ti in tinfo.tiers] == [
        ("color", True, "pair")]
    assert [tmc.route(ti, tinfo, sharded=True) for ti in tinfo.tiers] == [
        ("color", True, "records")]
    calls = []
    orig = tmc.grad_pair_tile
    monkeypatch.setattr(tmc, "grad_pair_tile",
                        lambda *a: calls.append(1) or orig(*a))
    v = torch.zeros((tdg.var_card.shape[0], 4), dtype=torch.int8)
    for n_graph, n in ((1, tinfo.n_colors), (2, 0)):
        calls.clear()
        tmc.mc_weight_gradient_cs(tdg, v, v, False, tinfo, n_graph=n_graph)
        assert len(calls) == n, n_graph


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (NC, D, n_weights, TB, ntiles, world off the 16-byte grid, streams off
# it): every variant of the kernel (16-byte rows in one pass of a warp's
# lanes at 256 and 48 chains, in two at 512; byte rows at 37 and off the
# grid; D unrolled 1..8, chunked at 9 and 24; 4-byte stream copies for TB
# not a multiple of 4 and for streams off the grid; a tile staged in two
# groups of rows at D = 24, TB = 64)
CARD_CASES = ([(nc, d, (1, 2, 64)[d % 3], 8, 6, False, False)
               for nc in (256, 512, 48, 37) for d in range(1, 10)]
              + [(48, 5, 2, 8, 6, True, False),
                 (256, 5, 2, 6, 6, False, False),
                 (256, 5, 64, 8, 6, False, True),
                 (256, 24, 2, 64, 6, False, False)])


def _off_grid(x, nbytes):
    """A contiguous copy of ``x`` whose data starts ``nbytes`` past an
    allocation's start."""
    n = nbytes // x.element_size()
    buf = torch.empty(x.numel() + n, dtype=x.dtype, device=x.device)
    out = buf[n:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("NC", [4, 20, 37, 48, 128, 256, 512])
def test_kernel_matches_plain_on_card(cuda_device, NC):
    for nc, D, n_weights, TB, nt, world_off, streams_off in CARD_CASES:
        if nc != NC:
            continue
        s = _streams(NC, D, n_weights, seed=D + NC, TB=TB, ntiles=nt)
        for c in range(2):
            args = list(_plain_on(s, c, 200, TB, D, n_weights, cuda_device))
            if world_off:
                args[:2] = (_off_grid(v, 1) for v in args[:2])
            if streams_off:
                args[4:9] = (_off_grid(x, 4) for x in args[4:9])
            got = grad_pair_tile(*args)
            again = grad_pair_tile(*args)
            ref = grad_pair_tile_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, again)                # bit for bit
            scale = float(ref.abs().max())
            assert scale > 1.0
            assert float((got - ref).abs().max()) <= 1e-5 * scale, (
                nc, D, n_weights, TB, world_off, streams_off)
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
        g_k = tmc.mc_weight_gradient_cs(tdg, v_ev, v_free, lne, tinfo)
        g_f = tmc._mc_weight_gradient_factors(tdg, v_ev, v_free, lne, tinfo)
        assert float((g_k - g_f).abs().max()) <= ATOL
