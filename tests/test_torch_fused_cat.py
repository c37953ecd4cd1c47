"""The port's K-candidate (categorical) fused color step against the JAX
package's.

On evidence-clamped Potts grids that compile to one affinek tier (the
grids of tests/test_fused_cat.py):

  * fold_affine_cat equals the JAX function within 1e-6;
  * the plain fused_cat_draw draws what JAX fused_cat_draw draws in
    interpret mode (same streams, world and seed words), except where the
    plain version's top two scores lie within 1e-5 of each other;
  * its logits are the port's color_logits_mc + cm_kmask up to a
    per-variable shift (the k-independent terms the analysis drops), within
    1e-4;
  * inference through it, and through the eager candidate path (the
    single-chain engine's draw, at the same chain count), matches exact
    enumeration (|Δp| < 0.01); mixed cardinalities draw only valid
    categories, and one generator seed gives bitwise-equal marginals;
  * with av = bv = 0 the draw is a softmax draw over the kmask-allowed
    candidates, deterministic per seed.
The CUDA kernel is held to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu.benchgraphs import big_potts_grid as jax_potts_grid
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.ops.fused import fold_affine_cat as jax_fold_cat
from sampler_tpu.ops.fused import fused_cat_draw as jax_fused_cat_draw
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch import oracle
from sampler_tpu_torch.benchgraphs import big_potts_grid
from sampler_tpu_torch.compile import compile_graph, to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.ops.fused import (KNUTH, M32, fold_affine_cat,
                                         fused_cat_draw, fused_cat_draw_plain,
                                         hash_bits, tile_seed, u32, uniform24)
from torch_routes import infer_on_route

NC = 16
BAND = dict(band_tile=8, band_min_block=1)
TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _potts_evidence(make, rows=16, cols=16, card=3, n_query=10, seed=0,
                    mixed=False):
    """tests/test_fused_cat.py's grid: all but ``n_query`` variables
    clamped; ``mixed`` demotes every third variable to card 2."""
    g, colors = make(rows, cols, card=card, seed=seed)
    rng = np.random.default_rng(seed)
    query = rng.choice(g.n_vars, n_query, replace=False)
    g.var_role[:] = fs.ROLE_EVIDENCE
    g.var_role[query] = fs.ROLE_QUERY
    g.var_init[:] = rng.integers(0, card, g.n_vars)
    if mixed:
        g.var_card[::3] = 2
        g.var_init[:] = g.var_init % g.var_card
        g.e_eqpred[:] = g.e_eqpred % g.var_card[g.e_vid]
    return g, colors, query


# name -> kwargs of _potts_evidence
GRIDS = {
    "card4": dict(card=4, seed=2),
    "card3": dict(card=3, n_query=8, seed=5),
    "mixed4": dict(card=4, n_query=6, seed=7, mixed=True),
}


def _compile(name, weights=None):
    """The grid compiled by the JAX package, and the same streams in the
    port (on the CPU)."""
    g, colors, _ = _potts_evidence(jax_potts_grid, **GRIDS[name])
    if weights is not None:
        g.w_init[:] = weights
    jdg, jinfo = jax_compile(g, colors=colors, **BAND)
    ti = jinfo.tiers[0]
    assert len(jinfo.tiers) == 1 and ti.affinek and not ti.affine2
    tdg, tinfo = from_jax(jdg, jinfo)
    return jdg, jinfo, to_device(tdg, "cpu"), tinfo


def _world(dg, seed):
    card = np.asarray(dg.var_card)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, (card.shape[0], NC))
            % card[:, None]).astype(np.int8)


def _scores(logits, seed_words, TB):
    """The plain draw's Gumbel scores [rows, K, NC] from its logits."""
    rows, K, nc = logits.shape
    b = torch.arange(rows)[:, None, None] % TB
    t = torch.arange(rows)[:, None, None] // TB
    k = torch.arange(K)[None, :, None]
    cnt = b * nc + torch.arange(nc)[None, None, :]
    kseed = tile_seed(seed_words[1], t) ^ ((KNUTH * (k + 1)) & M32)
    u = uniform24(hash_bits(cnt, u32(seed_words[0]), kseed))
    return logits - torch.log(-torch.log(u))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_fold_affine_cat_matches_jax(name):
    jdg, jinfo, tdg, tinfo = _compile(name)
    w = np.random.default_rng(2).normal(size=jdg.w_init.shape) \
        .astype(np.float32)
    ref = jax_fold_cat(jax_to_device(jdg).tiers[0], jinfo.tiers[0],
                       jinfo.n_colors, jnp.asarray(w))
    got = fold_affine_cat(tdg.tiers[0], tinfo.tiers[0], tinfo.n_colors,
                          torch.from_numpy(w))
    assert len(got) == 3
    for r, o in zip(ref, got):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    assert tuple(got[2].shape[2:]) == (tinfo.tiers[0].band_tb,
                                       tinfo.max_card)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_plain_draw_matches_jax(name):
    jdg, jinfo, tdg, tinfo = _compile(name, weights=[0.6, -0.35])
    jdgd = jax_to_device(jdg)
    jts, ti = jdgd.tiers[0], jinfo.tiers[0]
    K = jinfo.max_card
    jfold = jax_fold_cat(jts, ti, jinfo.n_colors, jnp.asarray(jdg.w_init))
    fold = fold_affine_cat(tdg.tiers[0], tinfo.tiers[0], tinfo.n_colors,
                           tdg.w_init)
    ts = tdg.tiers[0]
    vals = _world(jdg, 3)
    n_diff = n_all = 0
    for c, seed_words in zip(range(jinfo.n_colors),
                             ((7, 11), (-123456789, 2 ** 31 - 1))):
        starts = np.asarray(jdg.tiers[0].bd_start[c])
        ref = np.asarray(jax_fused_cat_draw(
            jnp.asarray(vals), jts.bd_nbr, jnp.asarray(starts), jts.bd_eqo,
            jts.bd_eqn, *jfold, c, jnp.asarray(seed_words, jnp.int32),
            ti.band_w, ti.band_tb, ti.degree, K, interpret=True))
        out, logits = fused_cat_draw_plain(
            torch.from_numpy(vals), ts.bd_nbr, ts.bd_start[c], ts.bd_eqo,
            ts.bd_eqn, *fold, c, torch.tensor(seed_words, dtype=torch.int32),
            ti.band_w, ti.band_tb, ti.degree, K, return_logits=True)
        assert out.dtype == torch.int8 and out.shape == ref.shape
        diff = out.numpy() != ref
        if diff.any():
            top2 = _scores(logits, seed_words, ti.band_tb).topk(2, dim=1)
            gap = (top2.values[:, 0] - top2.values[:, 1])
            assert (gap[torch.from_numpy(diff)] < 1e-5).all()
        n_diff += int(diff.sum())
        n_all += diff.size
    assert n_diff <= 1e-4 * n_all


@pytest.mark.parametrize("name", ["card4", "mixed4"])
def test_fused_logits_match_color_logits_up_to_shift(name):
    """Σ_d (av + bv·e)[k == eqo] + kmask equals color_logits_mc + kmask up
    to a k-independent per-(variable, chain) shift."""
    _, _, d, info = _compile(name, weights=[0.6, -0.35])
    ts, ti = d.tiers[0], info.tiers[0]
    K, B = info.max_card, ti.block
    fold = fold_affine_cat(ts, ti, info.n_colors, d.w_init)
    vals = torch.from_numpy(_world(d, 0))
    seed = torch.tensor([1, 2], dtype=torch.int32)
    for c in range(info.n_colors):
        _, lcat = fused_cat_draw_plain(vals, ts.bd_nbr, ts.bd_start[c],
                                       ts.bd_eqo, ts.bd_eqn, *fold, c, seed,
                                       ti.band_w, ti.band_tb, ti.degree, K,
                                       return_logits=True)
        kmask = ts.cm_kmask.view(info.n_colors, B, K)[c]
        lref = tmc.color_logits_mc(d, ts, ti, vals, d.w_init, c,
                                   info) + kmask[:, :, None]
        card = d.var_card[c * info.block_size:c * info.block_size + B]
        ok = (torch.arange(K)[None, :, None] < card[:, None, None])
        dcat = torch.where(ok, lcat - lcat[:, :1], 0.0)
        dref = torch.where(ok, lref - lref[:, :1], 0.0)
        np.testing.assert_allclose(dcat.numpy(), dref.numpy(), rtol=0,
                                   atol=1e-4)


def _port_grid(name):
    g, colors, query = _potts_evidence(big_potts_grid, **GRIDS[name])
    dg, info = compile_graph(g, colors=colors, **BAND)
    assert info.affinek and len(info.tiers) == 1
    return g, dg, info, query


@pytest.mark.parametrize("fused", [True, False])
def test_potts_grid_matches_oracle(fused):
    """tests/test_fused_cat.py's oracle grid (card 3, 8 query variables)
    through the fused draw (infer_mc's route) and the eager candidate
    path."""
    g, dg, info, query = _port_grid("card3")
    assert tmc.route(info.tiers[0], info) == ("cat", True, "records")
    d = to_device(dg, "cpu")
    gen = torch.Generator().manual_seed(0)
    if fused:
        marg, values = tmc.infer_mc(d, d.w_init, gen, 150, 1500, info, 32,
                                    device="cpu")
    else:
        marg, values = infer_on_route(d, info, gen, 150, 1500, 32)
    assert marg.shape == (g.n_vars, 3) and values.dtype == torch.int8
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    err = np.abs(marg[query] - exact[query]).max()
    assert err < TOL, f"max |Δp| = {err:.4f}"


def test_mixed_cards_valid_and_deterministic():
    g, dg, info, _ = _port_grid("mixed4")
    d = to_device(dg, "cpu")
    card = d.var_card[:, None]
    for infer in (lambda gen: tmc.infer_mc(d, d.w_init, gen, 20, 50, info,
                                           4, device="cpu"),
                  lambda gen: infer_on_route(d, info, gen, 20, 50, 4)):
        runs = [infer(torch.Generator().manual_seed(3)) for _ in range(2)]
        (m1, v1), (m2, _) = runs
        assert np.array_equal(m1, m2)
        assert bool((v1 < card).all() and (v1 >= 0).all())
        # card-2 variables put no mass on categories 2 and 3
        two = np.asarray(g.var_card) == 2
        assert (m1[two, 2:] == 0).all() and (m1[two, :2] > 0).any()


@pytest.mark.parametrize("K", [2, 5, 20])
def test_zero_coefficients_draw_softmax_of_kmask(K):
    """av = bv = 0 and kmask -1e30 above ``card``: every allowed candidate
    is equally likely, no masked one is drawn, and the draw is a function
    of the seed words."""
    ntiles, TB, D, W, P = 4, 8, 3, 128, 256
    card = max(2, K - 1)
    values = torch.zeros((P, NC), dtype=torch.int8)
    R = D * TB
    zeros = torch.zeros((1, ntiles, R))
    idx = torch.zeros((1, ntiles, R), dtype=torch.int32)
    kmask = torch.where(torch.arange(K) < card, 0.0, -1e30).expand(
        1, ntiles, TB, K).contiguous()
    starts = torch.zeros(ntiles, dtype=torch.int32)

    def draw(s):
        return fused_cat_draw(values, idx, starts, idx, idx, zeros, zeros,
                              kmask, 0, torch.tensor([s, s ^ 91],
                                                     dtype=torch.int32),
                              W, TB, D, K)

    outs = torch.stack([draw(s) for s in range(40)]).long()
    assert int(outs.max()) < card
    freq = torch.bincount(outs.reshape(-1), minlength=card).double()
    freq /= freq.sum()
    assert float((freq - 1 / card).abs().max()) < 0.01
    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))


def test_wrapper_on_cpu_is_plain_and_counts_no_launch():
    _, _, d, info = _compile("card4")
    ts, ti = d.tiers[0], info.tiers[0]
    fold = fold_affine_cat(ts, ti, info.n_colors, d.w_init)
    vals = torch.from_numpy(_world(d, 5))
    seed = torch.tensor([1, 2], dtype=torch.int32)
    args = (vals, ts.bd_nbr, ts.bd_start[1], ts.bd_eqo, ts.bd_eqn, *fold, 1,
            seed, ti.band_w, ti.band_tb, ti.degree, info.max_card)
    before = fused_cat_draw.launches
    assert torch.equal(fused_cat_draw(*args), fused_cat_draw_plain(*args))
    assert fused_cat_draw.launches == before


def test_cat_routes_count_no_kernel_launch_on_cpu(monkeypatch):
    """infer_mc draws through fused_cat_draw (its plain version on the
    CPU, one call a color a sweep) and refolds with fold_affine_cat once a
    run; the eager route draws through color_logits_mc; the CPU counts no
    launch."""
    from sampler_tpu_torch.ops.banded import banded_gather

    _, dg, info, _ = _port_grid("card4")
    d = to_device(dg, "cpu")
    calls = {"draw": 0, "fold": 0, "logits": 0}
    for name, key in (("fused_cat_draw", "draw"),
                      ("fold_affine_cat", "fold"),
                      ("color_logits_mc", "logits")):
        orig = getattr(tmc, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(tmc, name, counted)
    before = (fused_cat_draw.launches, banded_gather.launches)
    C = info.n_colors
    tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(0), 1, 2, info, 4,
                 device="cpu")
    assert calls == {"draw": 3 * C, "fold": 2, "logits": 0}
    infer_on_route(d, info, torch.Generator().manual_seed(0), 1, 2, 4)
    assert calls["draw"] == 3 * C and calls["logits"] >= 3 * C
    assert (fused_cat_draw.launches, banded_gather.launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_kernel_matches_plain_on_card(cuda_device, name):
    _, _, d, info = _compile(name, weights=[0.6, -0.35])
    vals = torch.from_numpy(_world(d, 7)).to(cuda_device)
    d = to_device(d, cuda_device)
    ts, ti = d.tiers[0], info.tiers[0]
    fold = fold_affine_cat(ts, ti, info.n_colors, d.w_init)
    seed = torch.tensor([3, -4], dtype=torch.int32, device=cuda_device)
    for c in range(info.n_colors):
        args = (vals, ts.bd_nbr, ts.bd_start[c], ts.bd_eqo, ts.bd_eqn, *fold,
                c, seed, ti.band_w, ti.band_tb, ti.degree, info.max_card)
        before = fused_cat_draw.launches
        out, logits = fused_cat_draw(*args, return_logits=True)
        ref, ref_logits = fused_cat_draw_plain(*args, return_logits=True)
        torch.cuda.synchronize()
        assert fused_cat_draw.launches == before + 1
        assert torch.equal(logits, ref_logits)
        assert int((out != ref).sum()) <= 1e-4 * out.numel()


def _cat_streams(seed, D, K, NC, P=1000, ntiles=8, TB=8, W=256, C=2):
    """Random streams of an affinek tier of C colors: window starts on the
    256 grid, every other one clipped to P - W; neighbours around the
    window (some outside it, some at or past P); eqo in [0, K) with 5%
    matching no candidate; eqn in [0, K) with 5% outside int8's range;
    random coefficients, kmask 0 or (10%) -1e30, and a world of values in
    [0, K)."""
    rng = np.random.default_rng(seed)
    shape = (C, ntiles, D * TB)
    starts = rng.integers(0, P - W, (C, ntiles)) // 256 * 256
    starts[:, ::2] = P - W
    nbr = starts[:, :, None] + rng.integers(-32, W + 32, shape)
    eqo = rng.integers(0, K, shape)
    eqo[rng.random(shape) < 0.05] = K
    eqn = rng.integers(0, K, shape)
    eqn[rng.random(shape) < 0.05] = 300
    kmask = np.where(rng.random((C, ntiles, TB, K)) < 0.1, -1e30, 0.0)
    return dict(
        values=rng.integers(0, K, (P, NC)).astype(np.int8),
        nbr=nbr.astype(np.int32), starts=starts.astype(np.int32),
        eqo=eqo.astype(np.int32), eqn=eqn.astype(np.int32),
        av=rng.normal(0.0, 1.0, shape).astype(np.float32),
        bv=rng.normal(0.0, 1.0, shape).astype(np.float32),
        kmask=kmask.astype(np.float32), W=W, TB=TB)


def _logits_reference(s, c, D, K):
    """l_k [ntiles*TB, K, NC] of color c in float64, from the definition."""
    ntiles, TB, W = s["starts"].shape[1], s["TB"], s["W"]
    P = s["values"].shape[0]

    def tile(x):
        return x[c].reshape(ntiles, D, TB)

    nbr = tile(s["nbr"])
    local = nbr - s["starts"][c][:, None, None]
    valid = (local >= 0) & (local < W) & (nbr >= 0) & (nbr < P)
    v = np.where(valid[..., None], s["values"][np.where(valid, nbr, 0)], 0)
    e = (v.astype(np.int64) == tile(s["eqn"])[..., None]).astype(np.float64)
    contrib = (tile(s["av"]).astype(np.float64)[..., None]
               + tile(s["bv"]).astype(np.float64)[..., None] * e)
    k = np.arange(K)[None, :, None, None, None]
    lk = np.where(tile(s["eqo"])[:, None, :, :, None] == k,
                  contrib[:, None], 0.0).sum(axis=2)       # [nt, K, TB, NC]
    lk = lk + s["kmask"][c].transpose(0, 2, 1)[..., None]
    return lk.transpose(0, 2, 1, 3).reshape(ntiles * TB, K, -1)


# D from 1 to one past the kernel's unrolled 1..8, K from 2 to one past its
# unrolled 2..8 and 20 (card-20 grids), and the chain counts its variants
# split on (16 and 48: 16-byte rows; 37: byte rows)
SHAPES = ([(d, 4, 16) for d in range(1, 10)]
          + [(5, k, 16) for k in (2, 3, 5, 6, 7, 8, 9, 20)]
          + [(5, 4, 37), (5, 4, 48), (9, 20, 37)])


@pytest.mark.parametrize("D,K,NC", SHAPES)
def test_plain_draw_matches_jax_interpret_shapes(D, K, NC):
    """On random streams at the shapes the kernel's variants split on: the
    plain logits match the definition within 1e-5 (where kmask is 0), and
    the plain draws match JAX's interpret-mode kernel except where the top
    two scores lie within 1e-5."""
    s = _cat_streams(300 + 10 * D + K + NC, D, K, NC)
    seed_words = (500 + D, -31 * K - NC)
    t = {k: torch.from_numpy(v) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    n_diff = n_all = 0
    for c in range(s["starts"].shape[0]):
        ref = np.asarray(jax_fused_cat_draw(
            *(jnp.asarray(s[k]) for k in ("values", "nbr")),
            jnp.asarray(s["starts"][c]),
            *(jnp.asarray(s[k]) for k in ("eqo", "eqn", "av", "bv",
                                          "kmask")),
            c, jnp.asarray(seed_words, jnp.int32), s["W"], s["TB"], D, K,
            interpret=True))
        out, logits = fused_cat_draw_plain(
            t["values"], t["nbr"], t["starts"][c], t["eqo"], t["eqn"],
            t["av"], t["bv"], t["kmask"], c,
            torch.tensor(seed_words, dtype=torch.int32), s["W"], s["TB"], D,
            K, return_logits=True)
        assert out.shape == ref.shape == (s["starts"].shape[1] * s["TB"], NC)
        open_k = np.broadcast_to(
            s["kmask"][c].reshape(-1, K)[..., None] == 0, logits.shape)
        np.testing.assert_allclose(logits.numpy()[open_k],
                                   _logits_reference(s, c, D, K)[open_k],
                                   rtol=0, atol=1e-5)
        assert int(out.max()) < K
        diff = out.numpy() != ref
        if diff.any():
            top2 = _scores(logits, seed_words, s["TB"]).topk(2, dim=1)
            gap = top2.values[:, 0] - top2.values[:, 1]
            assert (gap[torch.from_numpy(diff)] < 1e-5).all()
        n_diff += int(diff.sum())
        n_all += diff.size
    assert n_diff <= 1e-4 * n_all


@pytest.mark.gpu
@pytest.mark.parametrize("D,K,NC,misaligned", [
    (1, 4, 16, False), (5, 4, 512, False), (5, 4, 48, False),
    (8, 8, 64, False), (3, 2, 48, False), (9, 4, 48, False),
    (12, 20, 512, False), (5, 20, 48, False), (5, 9, 48, False),
    (5, 4, 37, False), (9, 20, 37, False), (5, 4, 48, True),
    (9, 3, 48, True)])
def test_kernel_variants_match_plain_on_card(cuda_device, D, K, NC,
                                             misaligned):
    """Each variant of the kernel against its plain version: 16-byte rows
    (16, 48, 64 and 512 chains) and byte rows (37 chains, or a values
    pointer off the 16-byte grid), D unrolled (1..8) and chunked (9, 12),
    K unrolled (2..8) and looped (9, 20), with and without the logits.
    The logits are exact; a draw may differ only where the plain top two
    scores lie within 1e-5."""
    s = _cat_streams(700 + 10 * D + K + NC, D, K, NC)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    if misaligned:
        flat = torch.empty(t["values"].numel() + 1, dtype=torch.int8,
                           device=cuda_device)
        t["values"] = flat[1:].view(t["values"].shape)
        t["values"].copy_(torch.from_numpy(s["values"]))
        assert t["values"].data_ptr() % 16 != 0
    seed_words = (D, -K * NC)
    seed = torch.tensor(seed_words, dtype=torch.int32, device=cuda_device)
    for c in range(s["starts"].shape[0]):
        args = (t["values"], t["nbr"], t["starts"][c], t["eqo"], t["eqn"],
                t["av"], t["bv"], t["kmask"], c, seed, s["W"], s["TB"], D, K)
        before = fused_cat_draw.launches
        out, logits = fused_cat_draw(*args, return_logits=True)
        torch.cuda.synchronize()
        assert fused_cat_draw.launches == before + 1
        assert torch.equal(fused_cat_draw(*args), out)
        ref, ref_logits = fused_cat_draw_plain(*args, return_logits=True)
        assert torch.equal(logits, ref_logits)
        diff = out != ref
        if bool(diff.any()):
            top2 = _scores(ref_logits.cpu(), seed_words, s["TB"]).topk(
                2, dim=1)
            gap = top2.values[:, 0] - top2.values[:, 1]
            assert bool((gap[diff.cpu()] < 1e-5).all())
        assert int(diff.sum()) <= 1e-4 * out.numel()
