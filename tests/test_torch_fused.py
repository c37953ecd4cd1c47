"""The port's fused affine color step against the JAX package's.

  * fold_affine + the plain step's log-odds reproduce JAX color_delta_bool;
  * the plain fused_color_draw draws what JAX fused_color_draw draws in
    interpret mode on identical streams and seed words (the JAX interpret
    path splits its product into two bf16 halves, so a draw may differ
    only where u lies within 1e-4 of sigmoid(delta));
  * portable_bits is the JAX counter hash bit for bit;
  * the draw is Bernoulli(sigmoid(base)) when beta = 0.
The CUDA kernel is held to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import format_spec as fs
from sampler_tpu.benchgraphs import big_ising_grid
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine.multichain import color_delta_bool as jax_delta_bool
from sampler_tpu.ops.fused import _portable_bits
from sampler_tpu.ops.fused import fold_affine as jax_fold_affine
from sampler_tpu.ops.fused import fused_color_draw as jax_fused_draw
from sampler_tpu_torch.compile import to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.ops.fused import (fold_affine, fused_color_draw,
                                         fused_color_draw_plain, hash_bits,
                                         portable_bits, tile_seed, u32,
                                         uniform24)

NC = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(seed=0, rows=16, cols=16):
    g, colors = big_ising_grid(rows, cols, w_pair=0.7, w_bias=-0.45)
    rng = np.random.default_rng(seed)
    g.var_role[:] = fs.ROLE_EVIDENCE
    g.var_role[rng.choice(g.n_vars, 12, replace=False)] = fs.ROLE_QUERY
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    jdg, jinfo = jax_compile(g, colors=colors, band_tile=8, band_min_block=1)
    assert jinfo.affine2
    return jdg, jinfo


def _world(P, seed):
    return np.random.default_rng(seed).integers(0, 2, (P, NC)).astype(np.int8)


def _port_streams(jdg, jinfo):
    tdg, tinfo = from_jax(jdg, jinfo)
    return to_device(tdg, "cpu"), tinfo


def test_fold_affine_delta_matches_jax_color_delta_bool():
    jdg, jinfo = _grid(seed=3)
    tdg, tinfo = _port_streams(jdg, jinfo)
    jdgd = jax_to_device(jdg)
    ts, ti = tdg.tiers[0], tinfo.tiers[0]
    beta, base = fold_affine(ts, ti, tinfo.n_colors, tdg.w_init)
    vals = _world(tdg.var_card.shape[0], 1)
    seed = torch.tensor([5, 9], dtype=torch.int32)
    for c in range(tinfo.n_colors):
        _, delta = fused_color_draw_plain(
            torch.from_numpy(vals), ts.bd_nbr, ts.bd_start[c], beta, base, c,
            seed, ti.band_w, ti.band_tb, ti.degree, return_delta=True)
        ref = jax_delta_bool(jdgd.tiers[0], jinfo.tiers[0], jnp.asarray(vals),
                             jnp.asarray(jdg.w_init), c, jinfo, ("off", "off"))
        np.testing.assert_allclose(delta.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("seed_words", [(7, 11), (-123456789, 2 ** 31 - 1)])
def test_plain_draw_matches_jax_interpret(seed_words):
    jdg, jinfo = _grid(seed=1)
    jdgd = jax_to_device(jdg)
    jts, ti = jdgd.tiers[0], jinfo.tiers[0]
    jbeta, jbase = jax_fold_affine(jts, ti, jinfo.n_colors,
                                   jnp.asarray(jdg.w_init))
    beta = torch.from_numpy(np.array(jbeta))
    base = torch.from_numpy(np.array(jbase))
    nbr = torch.from_numpy(np.asarray(jdg.tiers[0].bd_nbr))
    vals = _world(jdg.var_card.shape[0], 2)
    n_diff = n_all = 0
    for c in range(jinfo.n_colors):
        starts = np.asarray(jdg.tiers[0].bd_start[c])
        ref = np.asarray(jax_fused_draw(
            jnp.asarray(vals), jts.bd_nbr, jnp.asarray(starts), jbeta, jbase,
            c, jnp.asarray(seed_words, jnp.int32), ti.band_w, ti.band_tb,
            ti.degree, interpret=True))
        out, delta = fused_color_draw_plain(
            torch.from_numpy(vals), nbr, torch.from_numpy(starts), beta, base,
            c, torch.tensor(seed_words, dtype=torch.int32), ti.band_w,
            ti.band_tb, ti.degree, return_delta=True)
        diff = out.numpy() != ref
        if diff.any():
            rows, chains = np.nonzero(diff)
            t = torch.from_numpy(rows // ti.band_tb)
            cnt = torch.from_numpy((rows % ti.band_tb) * NC + chains)
            u = uniform24(_bits(cnt, seed_words, t))
            p = torch.sigmoid(delta[torch.from_numpy(diff)])
            assert (torch.abs(u - p) < 1e-4).all()
        n_diff += int(diff.sum())
        n_all += diff.size
    assert n_diff <= 1e-3 * n_all


def _streams(seed, D, NC, P=1000, ntiles=8, TB=8, W=256, C=2):
    """Random streams of C colors: window starts on the 256 grid, every
    other one clipped to P - W; neighbours around the window (some
    outside it) with 5% at the dummy slot P - 1; random weights and a
    random boolean world."""
    rng = np.random.default_rng(seed)
    starts = (rng.integers(0, P - W, (C, ntiles)) // 256 * 256)
    starts[:, ::2] = P - W
    off = rng.integers(-32, W + 32, (C, ntiles, D, TB))
    nbr = np.clip(starts[:, :, None, None] + off, 0, P - 1)
    nbr = np.where(rng.random(nbr.shape) < 0.05, P - 1, nbr)
    return dict(
        values=rng.integers(0, 2, (P, NC)).astype(np.int8),
        nbr=nbr.reshape(C, ntiles, D * TB).astype(np.int32),
        starts=starts.astype(np.int32),
        beta=rng.normal(0.0, 0.7, (C, ntiles, D * TB)).astype(np.float32),
        base=rng.normal(0.0, 0.5, (C, ntiles, TB)).astype(np.float32),
        W=W, TB=TB, D=D)


def _delta_reference(s, c):
    """delta [ntiles*TB, NC] of color c in float64, from the definition."""
    ntiles, TB, D = s["starts"].shape[1], s["TB"], s["D"]
    nbr = s["nbr"][c].reshape(ntiles, D, TB)
    local = nbr - s["starts"][c][:, None, None]
    inside = (local >= 0) & (local < s["W"])
    v = s["values"][nbr].astype(np.float64)            # [nt, D, TB, NC]
    beta = s["beta"][c].reshape(ntiles, D, TB, 1).astype(np.float64)
    terms = np.where(inside[..., None], beta * v, 0.0)
    delta = terms.sum(axis=1) + s["base"][c][..., None]
    return delta.reshape(ntiles * TB, -1)


@pytest.mark.parametrize("D,NC", [(d, 16) for d in range(1, 10)]
                         + [(5, 37), (5, 48)])
def test_plain_draw_matches_jax_interpret_shapes(D, NC):
    """D from 1 to one past the kernel's unrolled 1..8 and the chain counts
    its variants split on (16 and 48: 16-byte rows; 37: byte rows), on
    random streams with clipped window starts: the plain delta matches
    the definition within 1e-5, and its draws match JAX's interpret-mode
    kernel except where u lies within 1e-4 of sigmoid(delta)."""
    s = _streams(100 + 10 * D + NC, D, NC)
    seed_words = (1000 + D, -77 * NC)
    t = {k: torch.from_numpy(v) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    n_diff = n_all = 0
    for c in range(s["starts"].shape[0]):
        ref = np.asarray(jax_fused_draw(
            jnp.asarray(s["values"]), jnp.asarray(s["nbr"]),
            jnp.asarray(s["starts"][c]), jnp.asarray(s["beta"]),
            jnp.asarray(s["base"]), c, jnp.asarray(seed_words, jnp.int32),
            s["W"], s["TB"], D, interpret=True))
        out, delta = fused_color_draw_plain(
            t["values"], t["nbr"], t["starts"][c], t["beta"], t["base"], c,
            torch.tensor(seed_words, dtype=torch.int32), s["W"], s["TB"], D,
            return_delta=True)
        assert out.shape == (s["starts"].shape[1] * s["TB"], NC)
        np.testing.assert_allclose(delta.numpy(), _delta_reference(s, c),
                                   rtol=0, atol=1e-5)
        diff = out.numpy() != ref
        if diff.any():
            rows, chains = np.nonzero(diff)
            tt = torch.from_numpy(rows // s["TB"])
            cnt = torch.from_numpy((rows % s["TB"]) * NC + chains)
            u = uniform24(_bits(cnt, seed_words, tt))
            p = torch.sigmoid(delta[torch.from_numpy(diff)])
            assert (torch.abs(u - p) < 1e-4).all()
        n_diff += int(diff.sum())
        n_all += diff.size
    assert n_diff <= 1e-3 * n_all


def _bits(cnt, seed_words, t):
    """The kernel's hash bits at counters ``cnt`` of tiles ``t``."""
    return hash_bits(cnt.to(torch.int64), u32(seed_words[0]),
                     tile_seed(seed_words[1], t))


@pytest.mark.parametrize("s0,s1", [(0, 0), (5, 77), (-1, -2 ** 31),
                                   (2 ** 31 - 1, 123456)])
def test_portable_bits_bit_for_bit(s0, s1):
    ref = np.asarray(_portable_bits((24, 40), jnp.int32(s0), jnp.int32(s1)))
    out = portable_bits((24, 40), s0, s1).numpy()
    np.testing.assert_array_equal(out.astype(np.uint32), ref)


@pytest.mark.parametrize("t", [0, 1, 7, 4095])
def test_tile_seed_matches_jax_wrapping(t):
    knuth = jnp.int32(-1640531535)
    for s1 in (0, 77, -5):
        ref = np.asarray(jnp.int32(s1) ^ (jnp.int32(t) * knuth))
        assert int(tile_seed(s1, t)) == int(ref.astype(np.uint32))


def test_bernoulli_rate_and_determinism():
    """beta = 0, base = logit(p) ⇒ the draw is Bernoulli(p); the same seed
    gives the same bits, another seed other bits, tiles other streams."""
    ntiles, TB, D, W, P = 8, 8, 2, 128, 256
    values = torch.zeros((P, 64), dtype=torch.int8)
    nbr = torch.zeros((1, ntiles, D * TB), dtype=torch.int32)
    starts = torch.zeros(ntiles, dtype=torch.int32)
    beta = torch.zeros((1, ntiles, D * TB))
    for p in (0.25, 0.9):
        base = torch.full((1, ntiles, TB), float(np.log(p / (1 - p))))

        def draw(s):
            return fused_color_draw(values, nbr, starts, beta, base, 0,
                                    torch.tensor([s, s ^ 77],
                                                 dtype=torch.int32),
                                    W, TB, D)

        outs = torch.stack([draw(s) for s in range(12)]).double()
        assert abs(float(outs.mean()) - p) < 0.02
        assert torch.equal(draw(5), draw(5))
        assert not torch.equal(draw(5), draw(6))
        per_tile = outs.reshape(12, ntiles, TB, 64)
        assert not torch.equal(per_tile[:, 0], per_tile[:, 1])


def test_wrapper_on_cpu_is_plain_and_counts_no_launch():
    jdg, jinfo = _grid(seed=4)
    tdg, tinfo = _port_streams(jdg, jinfo)
    ts, ti = tdg.tiers[0], tinfo.tiers[0]
    beta, base = fold_affine(ts, ti, tinfo.n_colors, tdg.w_init)
    vals = torch.from_numpy(_world(tdg.var_card.shape[0], 5))
    seed = torch.tensor([1, 2], dtype=torch.int32)
    args = (vals, ts.bd_nbr, ts.bd_start[1], beta, base, 1, seed,
            ti.band_w, ti.band_tb, ti.degree)
    before = fused_color_draw.launches
    assert torch.equal(fused_color_draw(*args), fused_color_draw_plain(*args))
    assert fused_color_draw.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda_device):
    jdg, jinfo = _grid(seed=6)
    tdg, tinfo = from_jax(jdg, jinfo)
    tdg = to_device(tdg, cuda_device)
    ts, ti = tdg.tiers[0], tinfo.tiers[0]
    beta, base = fold_affine(ts, ti, tinfo.n_colors, tdg.w_init)
    vals = torch.from_numpy(_world(tdg.var_card.shape[0], 7)).to(cuda_device)
    seed = torch.tensor([3, -4], dtype=torch.int32, device=cuda_device)
    for c in range(tinfo.n_colors):
        args = (vals, ts.bd_nbr, ts.bd_start[c], beta, base, c, seed,
                ti.band_w, ti.band_tb, ti.degree)
        out, delta = fused_color_draw(*args, return_delta=True)
        ref, ref_delta = fused_color_draw_plain(*args, return_delta=True)
        torch.cuda.synchronize()
        assert float((delta - ref_delta).abs().max()) < 1e-5
        assert int((out != ref).sum()) <= 1e-4 * out.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("D,NC,misaligned", [
    (1, 16, False), (5, 48, False), (5, 512, False), (8, 64, False),
    (9, 48, False), (12, 512, False), (5, 37, False), (9, 37, False),
    (5, 48, True)])
@pytest.mark.parametrize("return_delta", [False, True])
def test_kernel_variants_match_plain_on_card(cuda_device, D, NC, misaligned,
                                             return_delta):
    """Each variant of the kernel against its plain version: 16-byte rows
    (16, 48, 64 and 512 chains) and byte rows (37 chains, or a values
    pointer off the 16-byte grid), D unrolled (1..8) and generic (9, 12),
    with and without the delta output.  The delta is exact (both round
    each product and sum on their own, in the same order); a draw may
    differ only where u lies within 1e-5 of p."""
    s = _streams(200 + 10 * D + NC, D, NC)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    if misaligned:
        flat = torch.empty(t["values"].numel() + 1, dtype=torch.int8,
                           device=cuda_device)
        t["values"] = flat[1:].view(t["values"].shape)
        t["values"].copy_(torch.from_numpy(s["values"]))
        assert t["values"].data_ptr() % 16 != 0
    seed = torch.tensor([D, -NC], dtype=torch.int32, device=cuda_device)
    for c in range(s["starts"].shape[0]):
        args = (t["values"], t["nbr"], t["starts"][c], t["beta"], t["base"],
                c, seed, s["W"], s["TB"], D)
        before = fused_color_draw.launches
        got = fused_color_draw(*args, return_delta=return_delta)
        torch.cuda.synchronize()
        assert fused_color_draw.launches == before + 1
        ref, ref_delta = fused_color_draw_plain(*args, return_delta=True)
        out = got[0] if return_delta else got
        if return_delta:
            assert torch.equal(got[1], ref_delta)
        diff = out != ref
        if bool(diff.any()):
            rows, chains = diff.nonzero(as_tuple=True)
            u = uniform24(hash_bits((rows % s["TB"]) * NC + chains,
                                    u32(seed[0]),
                                    tile_seed(seed[1], rows // s["TB"])))
            assert bool(((u - torch.sigmoid(ref_delta[diff])).abs()
                         < 1e-5).all())
