"""The port's fused multilinear color step against the JAX package's.

On three graphs that compile to fusedm tiers (the 16x16 evidence triple
grid of tests/test_fused_dm.py: band_k 1, arity 3; big_triple_grid(32, 32)
with band_wmax 512: band_k 2, arity 3; a 32x32 Ising grid colored
(r + c) % 3: band_k 2, arity 2):

  * fold_deltam_tiles equals the JAX function exactly;
  * the plain fused_dm_draw's delta is JAX color_delta_multilin's within
    1e-5, and its draws are JAX fused_dm_draw's in interpret mode (same
    streams, world and seed words) except where u lies within 1e-5 of
    sigmoid(delta);
  * with b1 = b2 = bx = 0 the draw is Bernoulli(sigmoid(base)),
    deterministic per seed and decorrelated across tiles, for Kw 1 and 2.
The CUDA kernel is held to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import format_spec as fs
from sampler_tpu.benchgraphs import big_ising_grid, big_triple_grid
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu.ops.fused import fold_deltam_tiles as jax_fold_tiles
from sampler_tpu.ops.fused import fused_dm_draw as jax_fused_dm_draw
from sampler_tpu_torch.compile import to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.ops.fused import (fold_deltam_tiles, fused_dm_draw,
                                         fused_dm_draw_plain, hash_bits,
                                         tile_seed, u32, uniform24)

NC = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _evidence(g, n_query, seed):
    rng = np.random.default_rng(seed)
    query = rng.choice(g.n_vars, n_query, replace=False)
    g.var_role[:] = fs.ROLE_EVIDENCE
    g.var_role[query] = fs.ROLE_QUERY
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    return g


def _ising3(rows=32, cols=32):
    g, _ = big_ising_grid(rows, cols, w_pair=0.35, w_bias=0.2)
    r, c = np.divmod(np.arange(g.n_vars), cols)
    return g, ((r + c) % 3).astype(np.int32)


# name -> (graph maker, compile kwargs, band_k, arity)
GRAPHS = {
    "triple16_k1": (lambda: big_triple_grid(16, 16),
                    dict(band_tile=8, band_min_block=1), 1, 3),
    "triple32_k2": (lambda: big_triple_grid(32, 32),
                    dict(band_tile=8, band_min_block=1, band_wmax=512), 2, 3),
    "ising3_k2": (_ising3,
                  dict(band_tile=8, band_min_block=1, band_wmax=512), 2, 2),
}


def _compile(name, seed=0):
    make, kw, band_k, arity = GRAPHS[name]
    g, colors = make()
    _evidence(g, 14, seed)
    jdg, jinfo = jax_compile(g, colors=colors, **kw)
    ti = jinfo.tiers[0]
    assert len(jinfo.tiers) == 1 and jinfo.fusedm and ti.fusedm
    assert (ti.band_k, ti.arity) == (band_k, arity) and not ti.affine2
    tdg, tinfo = from_jax(jdg, jinfo)
    return jdg, jinfo, to_device(tdg, "cpu"), tinfo


def _world(P, seed):
    return np.random.default_rng(seed).integers(0, 2, (P, NC)).astype(np.int8)


def _torch(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fold_deltam_tiles_matches_jax_exactly(name):
    jdg, jinfo, tdg, tinfo = _compile(name)
    w = np.random.default_rng(2).normal(size=jdg.w_init.shape) \
        .astype(np.float32)
    ref = jax_fold_tiles(jax_to_device(jdg).tiers[0], jinfo.tiers[0],
                         jinfo.n_colors, jnp.asarray(w))
    got = fold_deltam_tiles(tdg.tiers[0], tinfo.tiers[0], tinfo.n_colors,
                            torch.from_numpy(w))
    assert len(got) == 4
    for r, o in zip(ref, got):
        assert (r is None) == (o is None)
        if r is not None:
            assert tuple(o.shape) == r.shape
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    pairwise = tinfo.tiers[0].arity == 2
    assert (got[2] is None) == pairwise


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_draw_matches_jax(name):
    jdg, jinfo, tdg, tinfo = _compile(name, seed=1)
    jdgd = jax_to_device(jdg)
    jts, ti = jdgd.tiers[0], jinfo.tiers[0]
    jw = jnp.asarray(jdg.w_init)
    jfold = jax_fold_tiles(jts, ti, jinfo.n_colors, jw)
    jflat = jmc.prepare_fold(jdgd, jw, jinfo, ("off", "off"))[0]
    fold = tuple(_torch(x) for x in jfold)
    vals = _world(jdg.var_card.shape[0], 3)
    A1 = ti.arity - 1
    dmnbr = torch.from_numpy(np.asarray(jdg.tiers[0].bd_dmnbr))
    n_diff = n_all = 0
    for c, seed_words in zip(range(jinfo.n_colors),
                             ((7, 11), (-123456789, 2 ** 31 - 1), (5, -9))):
        starts = np.asarray(jdg.tiers[0].bd_start[c])
        ref = np.asarray(jax_fused_dm_draw(
            jnp.asarray(vals), jts.bd_dmnbr, jnp.asarray(starts), *jfold, c,
            jnp.asarray(seed_words, jnp.int32), ti.band_w, ti.band_tb,
            ti.degree, A1, ti.band_k, interpret=True))
        out, delta = fused_dm_draw_plain(
            torch.from_numpy(vals), dmnbr, torch.from_numpy(starts), *fold,
            c, torch.tensor(seed_words, dtype=torch.int32), ti.band_w,
            ti.band_tb, ti.degree, A1, ti.band_k, return_delta=True)
        ref_delta = jmc.color_delta_multilin(jts, ti, jnp.asarray(vals), c,
                                             jinfo, jflat, ("off", "off"))
        np.testing.assert_allclose(delta.numpy(), np.asarray(ref_delta),
                                   rtol=0, atol=1e-5)
        diff = out.numpy() != ref
        if diff.any():
            rows, chains = np.nonzero(diff)
            t = torch.from_numpy(rows // ti.band_tb)
            cnt = torch.from_numpy((rows % ti.band_tb) * NC + chains)
            u = uniform24(hash_bits(cnt.to(torch.int64), u32(seed_words[0]),
                                    tile_seed(seed_words[1], t)))
            p = torch.sigmoid(delta[torch.from_numpy(diff)])
            assert (torch.abs(u - p) < 1e-5).all()
        n_diff += int(diff.sum())
        n_all += diff.size
    assert n_diff <= 1e-4 * n_all


@pytest.mark.parametrize("Kw,A1,p", [(1, 2, 0.3), (2, 2, 0.85), (2, 1, 0.6)])
def test_bernoulli_rate_and_determinism(Kw, A1, p):
    """b* = 0, base = logit(p) ⇒ Bernoulli(p); the same seed gives the same
    bits, another seed other bits, tiles other streams."""
    ntiles, TB, D, W, P = 8, 8, 2, 128, 256
    values = torch.zeros((P, NC), dtype=torch.int8)
    R = D * TB
    nbr = torch.zeros((1, ntiles, A1 * R), dtype=torch.int32)
    b1 = b2 = bx = torch.zeros((1, ntiles, R))
    starts = torch.zeros((ntiles,) if Kw == 1 else (ntiles, Kw),
                         dtype=torch.int32)
    base = torch.full((1, ntiles, TB), float(np.log(p / (1 - p))))

    def draw(s):
        return fused_dm_draw(values, nbr, starts, base, b1, b2, bx, 0,
                             torch.tensor([s, s ^ 77], dtype=torch.int32),
                             W, TB, D, A1, Kw)

    outs = torch.stack([draw(s) for s in range(12)]).double()
    assert abs(float(outs.mean()) - p) < 0.02
    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))
    per_tile = outs.reshape(12, ntiles, TB, NC)
    assert not torch.equal(per_tile[:, 0], per_tile[:, 1])


def test_padded_slots_read_zero():
    """Slots at the multi-window sentinel Kw*W, or outside the single
    window, contribute nothing whatever their coefficient."""
    ntiles, TB, D, W, P = 2, 4, 3, 128, 512
    values = torch.ones((P, NC), dtype=torch.int8)
    R = D * TB
    b1 = torch.full((1, ntiles, R), 5.0)
    b2 = torch.full((1, ntiles, R), -3.0)
    bx = torch.full((1, ntiles, R), 7.0)
    base = torch.full((1, ntiles, TB), 0.25)
    seed = torch.tensor([1, 2], dtype=torch.int32)
    for Kw, fill, starts in (
            (2, 2 * W, torch.zeros((ntiles, 2), dtype=torch.int32)),
            (1, W + 3, torch.zeros(ntiles, dtype=torch.int32))):
        nbr = torch.full((1, ntiles, 2 * R), fill, dtype=torch.int32)
        _, delta = fused_dm_draw(values, nbr, starts, base, b1, b2, bx, 0,
                                 seed, W, TB, D, 2, Kw, return_delta=True)
        assert torch.equal(delta, torch.full_like(delta, 0.25))
        nbr[..., :R] = 1                 # slot 0 reads 1, slot 1 still 0
        _, delta = fused_dm_draw(values, nbr, starts, base, b1, b2, bx, 0,
                                 seed, W, TB, D, 2, Kw, return_delta=True)
        assert torch.allclose(delta, torch.full_like(delta, 0.25 + 3 * 5.0))


def test_wrapper_on_cpu_is_plain_and_counts_no_launch():
    _, _, tdg, tinfo = _compile("triple32_k2", seed=4)
    ts, ti = tdg.tiers[0], tinfo.tiers[0]
    fold = fold_deltam_tiles(ts, ti, tinfo.n_colors, tdg.w_init)
    vals = torch.from_numpy(_world(tdg.var_card.shape[0], 5))
    seed = torch.tensor([1, 2], dtype=torch.int32)
    args = (vals, ts.bd_dmnbr, ts.bd_start[1], *fold, 1, seed, ti.band_w,
            ti.band_tb, ti.degree, ti.arity - 1, ti.band_k)
    before = fused_dm_draw.launches
    assert torch.equal(fused_dm_draw(*args), fused_dm_draw_plain(*args))
    assert fused_dm_draw.launches == before


def test_prepare_fold_layout_follows_fused_mode():
    _, _, tdg, tinfo = _compile("triple16_k1")
    fused = tmc.prepare_fold(tdg, tdg.w_init, tinfo, ("plain", "plain"))
    assert fused[0][0].dim() == 3 and fused[0][1].dim() == 3
    unfused = tmc.prepare_fold(tdg, tdg.w_init, tinfo, ("plain", "off"))
    assert unfused[0][0].dim() == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kernel_matches_plain_on_card(cuda_device, name):
    _, _, tdg, tinfo = _compile(name, seed=6)
    tdg = to_device(tdg, cuda_device)
    ts, ti = tdg.tiers[0], tinfo.tiers[0]
    fold = fold_deltam_tiles(ts, ti, tinfo.n_colors, tdg.w_init)
    vals = torch.from_numpy(_world(tdg.var_card.shape[0], 7)).to(cuda_device)
    seed = torch.tensor([3, -4], dtype=torch.int32, device=cuda_device)
    for c in range(tinfo.n_colors):
        args = (vals, ts.bd_dmnbr, ts.bd_start[c], *fold, c, seed,
                ti.band_w, ti.band_tb, ti.degree, ti.arity - 1, ti.band_k)
        before = fused_dm_draw.launches
        out, delta = fused_dm_draw(*args, return_delta=True)
        ref, ref_delta = fused_dm_draw_plain(*args, return_delta=True)
        torch.cuda.synchronize()
        assert fused_dm_draw.launches == before + 1
        assert float((delta - ref_delta).abs().max()) < 1e-5
        assert int((out != ref).sum()) <= 1e-4 * out.numel()


def _dm_streams(seed, D, A1, Kw, NC, P=1000, ntiles=8, TB=8, W=256, C=2):
    """Random streams of a fusedm tier of C colors inside the JAX kernel's
    contract (every window inside [0, P)): Kw == 1, window starts on the
    256 grid, every other one clipped to P - W, and global positions
    around each window (some outside it); Kw >= 2, window starts anywhere
    in [0, P - W] and indices into the Kw windows laid end to end, 5% at
    the sentinel Kw*W.  Random coefficients and a random 0/1 world."""
    rng = np.random.default_rng(seed)
    R = D * TB
    if Kw == 1:
        starts = rng.integers(0, P - W, (C, ntiles)) // 256 * 256
        starts[:, ::2] = P - W
        nbr = starts[:, :, None] + rng.integers(-32, W + 32,
                                                (C, ntiles, A1 * R))
    else:
        starts = rng.integers(0, P - W + 1, (C, ntiles, Kw))
        nbr = rng.integers(0, Kw * W, (C, ntiles, A1 * R))
        nbr[rng.random(nbr.shape) < 0.05] = Kw * W

    def coef(shape):
        return rng.normal(0.0, 0.7, shape).astype(np.float32)

    return dict(values=rng.integers(0, 2, (P, NC)).astype(np.int8),
                nbr=nbr.astype(np.int32), starts=starts.astype(np.int32),
                base=coef((C, ntiles, TB)), b1=coef((C, ntiles, R)),
                b2=coef((C, ntiles, R)) if A1 == 2 else None,
                bx=coef((C, ntiles, R)) if A1 == 2 else None, W=W, TB=TB)


def _delta_reference(s, c, D, A1, Kw):
    """delta [ntiles*TB, NC] of color c in float64, from the definition."""
    ntiles, TB, W = s["nbr"].shape[1], s["TB"], s["W"]
    P = s["values"].shape[0]
    idx = s["nbr"][c].reshape(ntiles, A1, D, TB).astype(np.int64)
    st = s["starts"][c].reshape(ntiles, Kw).astype(np.int64)
    if Kw == 1:
        row = idx
        valid = (idx >= st[:, :1, None, None]) & (idx < st[:, :1, None, None]
                                                  + W)
    else:
        valid = (idx >= 0) & (idx < Kw * W)
        k = np.where(valid, idx // W, 0)
        row = np.take_along_axis(st, k.reshape(ntiles, -1), 1).reshape(
            idx.shape) + idx % W
    valid &= (row >= 0) & (row < P)
    n = np.where(valid[..., None], s["values"][np.where(valid, row, 0)],
                 0).astype(np.float64)                  # [nt, A1, D, TB, NC]

    def coef(x):
        return x[c].reshape(ntiles, D, TB, 1).astype(np.float64)

    terms = coef(s["b1"]) * n[:, 0]
    if A1 == 2:
        terms = terms + coef(s["b2"]) * n[:, 1] + coef(s["bx"]) * (n[:, 0]
                                                                  * n[:, 1])
    delta = terms.sum(axis=1) + s["base"][c][..., None]
    return delta.reshape(ntiles * TB, -1)


# D from 1 to one past the kernel's unrolled 1..8; A1 1 and 2; Kw 1 and 2;
# the chain counts its variants split on (16 and 48: 16-byte rows; 37: byte
# rows)
SHAPES = ([(d, 2, 2, 16) for d in range(1, 10)]
          + [(4, a1, kw, nc) for a1 in (1, 2) for kw in (1, 2)
             for nc in (16, 37, 48) if (a1, kw, nc) != (2, 2, 16)])


@pytest.mark.parametrize("D,A1,Kw,NC", SHAPES)
def test_plain_draw_matches_jax_interpret_shapes(D, A1, Kw, NC):
    """On random streams at the shapes the kernel's variants split on: the
    plain delta matches the definition within 1e-5, and its draws match
    JAX's interpret-mode kernel except where u lies within 1e-5 of
    sigmoid(delta)."""
    s = _dm_streams(400 + 10 * D + 3 * A1 + Kw + NC, D, A1, Kw, NC)
    seed_words = (900 + D, -17 * NC - Kw)
    n_diff = n_all = 0
    for c in range(s["nbr"].shape[0]):
        coefs = [s[k] for k in ("base", "b1", "b2", "bx")]
        ref = np.asarray(jax_fused_dm_draw(
            jnp.asarray(s["values"]), jnp.asarray(s["nbr"]),
            jnp.asarray(s["starts"][c]),
            *(None if x is None else jnp.asarray(x) for x in coefs), c,
            jnp.asarray(seed_words, jnp.int32), s["W"], s["TB"], D, A1, Kw,
            interpret=True))
        out, delta = fused_dm_draw_plain(
            torch.from_numpy(s["values"]), torch.from_numpy(s["nbr"]),
            torch.from_numpy(s["starts"][c]), *(_torch(x) for x in coefs), c,
            torch.tensor(seed_words, dtype=torch.int32), s["W"], s["TB"], D,
            A1, Kw, return_delta=True)
        assert out.shape == ref.shape == (s["nbr"].shape[1] * s["TB"], NC)
        np.testing.assert_allclose(delta.numpy(),
                                   _delta_reference(s, c, D, A1, Kw),
                                   rtol=0, atol=1e-5)
        diff = out.numpy() != ref
        if diff.any():
            rows, chains = np.nonzero(diff)
            t = torch.from_numpy(rows // s["TB"])
            cnt = torch.from_numpy((rows % s["TB"]) * NC + chains)
            u = uniform24(hash_bits(cnt.to(torch.int64), u32(seed_words[0]),
                                    tile_seed(seed_words[1], t)))
            p = torch.sigmoid(delta[torch.from_numpy(diff)])
            assert (torch.abs(u - p) < 1e-5).all()
        n_diff += int(diff.sum())
        n_all += diff.size
    assert n_diff <= 1e-4 * n_all


@pytest.mark.gpu
@pytest.mark.parametrize("D,A1,Kw,NC,misaligned", [
    (1, 2, 2, 16, False), (4, 2, 2, 1024, False), (4, 2, 2, 48, False),
    (4, 1, 2, 512, False), (4, 2, 1, 48, False), (5, 1, 1, 64, False),
    (8, 2, 2, 48, False), (9, 2, 2, 48, False), (12, 1, 2, 512, False),
    (1, 2, 2, 512, False), (8, 1, 1, 1024, False), (5, 2, 2, 512, False),
    (4, 2, 2, 37, False), (9, 1, 1, 37, False), (4, 2, 2, 48, True),
    (9, 2, 1, 48, True)])
def test_kernel_variants_match_plain_on_card(cuda_device, D, A1, Kw, NC,
                                             misaligned):
    """Each variant of the kernel against its plain version: 16-byte rows
    (512 and 1024 chains: a warp's table of sums where A1*D <= 8; 16, 48
    and 64 chains: the selects) and byte rows (37 chains, or a values
    pointer off the 16-byte grid), D unrolled (1..8) and chunked (9, 12),
    A1 1 and 2, Kw 1 and 2, with and without the delta.  The delta is
    exact on 0/1 worlds; a draw may differ only where u lies within 1e-5
    of p."""
    s = _dm_streams(800 + 10 * D + 3 * A1 + Kw + NC, D, A1, Kw, NC)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    if misaligned:
        flat = torch.empty(t["values"].numel() + 1, dtype=torch.int8,
                           device=cuda_device)
        t["values"] = flat[1:].view(t["values"].shape)
        t["values"].copy_(torch.from_numpy(s["values"]))
        assert t["values"].data_ptr() % 16 != 0
    seed = torch.tensor([D + Kw, -NC], dtype=torch.int32, device=cuda_device)
    for c in range(s["nbr"].shape[0]):
        args = (t["values"], t["nbr"], t["starts"][c], t["base"], t["b1"],
                t.get("b2"), t.get("bx"), c, seed, s["W"], s["TB"], D, A1,
                Kw)
        before = fused_dm_draw.launches
        out, delta = fused_dm_draw(*args, return_delta=True)
        torch.cuda.synchronize()
        assert fused_dm_draw.launches == before + 1
        assert torch.equal(fused_dm_draw(*args), out)
        ref, ref_delta = fused_dm_draw_plain(*args, return_delta=True)
        assert torch.equal(delta, ref_delta)
        diff = out != ref
        if bool(diff.any()):
            rows, chains = diff.nonzero(as_tuple=True)
            u = uniform24(hash_bits((rows % s["TB"]) * NC + chains,
                                    u32(seed[0]),
                                    tile_seed(seed[1], rows // s["TB"])))
            assert bool(((u - torch.sigmoid(ref_delta[diff])).abs()
                         < 1e-5).all())
        assert int(diff.sum()) <= 1e-4 * out.numel()
