"""The port's tallies and the fused draws' world-write mode.

  * ``tally`` (ops.tally's plain version on the CPU) gives the counts of
    the JAX package's ``run_inference_mc`` on the world it returns, exactly
    (K = 2, 4 and 20 on int8 and int32 worlds, and K = 200 on int32; and
    K = 2, 4, 17 and 200 at 1 to 4, 8, 16, 24, 128 and 136 chains, the
    kernel's narrow rows and its tiles of rows under 16 bytes);
  * the wrapper on the CPU gives the plain counts at the kernel's narrow
    and wide rows and launches nothing (the launcher reports the way it
    took, and the card's tests hold ``narrow_launches`` to it);
  * the plain tally counts values outside [0, K) nowhere, at every K
    branch;
  * the world-write mode of each plain fused draw leaves the world bit for
    bit as the output mode followed by the masked block write does (every
    color, the resample and the evidence masks, a block shorter than the
    drawn tiles), and writes no row outside the block's selected rows;
  * ``infer_mc`` through that route matches exact enumeration (|dp| <
    0.01) on the fused Ising, triple and Potts grids.
The CUDA kernels are held to their plain versions on the card.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from sampler_tpu.benchgraphs import big_ising_grid as jax_ising_grid
from sampler_tpu.benchgraphs import big_potts_grid as jax_potts_grid
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch import oracle
from sampler_tpu_torch.benchgraphs import (big_ising_grid, big_potts_grid,
                                           big_triple_grid)
from sampler_tpu_torch.compile import compile_graph, to_device
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.ops.fused import (fold_affine, fold_affine_cat,
                                         fold_deltam_tiles, fused_cat_draw,
                                         fused_cat_draw_plain,
                                         fused_color_draw,
                                         fused_color_draw_plain,
                                         fused_dm_draw, fused_dm_draw_plain,
                                         _write_target)
from sampler_tpu_torch.ops.tally import tally_counts, tally_plain

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


# --------------------------------------------------------------------------
# the tallies against the JAX package's
# --------------------------------------------------------------------------

JAX_GRAPHS = {
    "ising": lambda: jax_ising_grid(8, 8),
    "potts4": lambda: jax_potts_grid(8, 8, card=4, seed=1),
    "potts20": lambda: jax_potts_grid(6, 6, card=20, seed=2),
    "potts200": lambda: jax_potts_grid(4, 4, card=200, seed=3),
}


@functools.lru_cache(maxsize=None)
def _jax_sweep_counts(name):
    """(world after one JAX sweep, JAX's counts of it as [K, P])."""
    g, colors = JAX_GRAPHS[name]()
    dg, info = jax_compile(g, colors=colors)
    d = jax_to_device(dg)
    key = jax.random.PRNGKey(5)
    vals = jmc.init_values_mc(d, key, 24, info)
    vals, counts = jmc.run_inference_mc(d, vals, d.w_init,
                                        jax.random.fold_in(key, 1), 1, False,
                                        info, ("off", "off"))
    K = info.max_card
    return np.asarray(vals), np.asarray(counts).reshape(K, -1)


@pytest.mark.parametrize("name,dtype", [
    ("ising", torch.int8), ("ising", torch.int32), ("potts4", torch.int8),
    ("potts4", torch.int32), ("potts20", torch.int8),
    ("potts20", torch.int32), ("potts200", torch.int32)])
def test_tally_equals_jax_run_inference_counts(name, dtype):
    vals, ref = _jax_sweep_counts(name)
    assert vals.dtype == (np.int32 if name == "potts200" else np.int8)
    counts = torch.zeros(ref.shape, dtype=torch.int32)
    tmc.tally(counts, torch.from_numpy(vals.copy()).to(dtype))
    np.testing.assert_array_equal(counts.numpy(), ref)


@pytest.mark.parametrize("K,NC", [(2, 37), (4, 48), (17, 37), (200, 48)])
def test_tally_plain_skips_values_outside_range(K, NC):
    """Values below 0 and at or past K count nowhere, on every branch (one
    compare a value up to 16, bincount blocks above)."""
    rng = np.random.default_rng(K + NC)
    dt = np.int8 if K <= 16 else np.int32
    hi = K + 3 if dt == np.int32 else min(K + 3, 127)
    v = rng.integers(-3, hi, (57, NC)).astype(dt)
    counts = torch.full((K, 57), 7, dtype=torch.int32)
    tally_plain(counts, torch.from_numpy(v), chunk_elems=100)
    ref = np.stack([(v == k).sum(1) for k in range(K)]) + 7
    np.testing.assert_array_equal(counts.numpy(), ref)


# narrow rows: the kernel's tiles (rows under 16 bytes: 1 to 4 and 8
# chains, at K <= 16), its segments of 1 to 32 lanes a row (16-byte rows of
# 16..128 chains) and its byte rows, every way it counts
NARROW_K = (2, 4, 17, 200)
NARROW_NC = (1, 2, 3, 4, 8, 16, 24, 128, 136)
NARROW_GRAPHS = {
    2: lambda: jax_ising_grid(6, 6),
    4: lambda: jax_potts_grid(6, 6, card=4, seed=1),
    17: lambda: jax_potts_grid(5, 5, card=17, seed=2),
    200: lambda: jax_potts_grid(4, 4, card=200, seed=3),
}


@functools.lru_cache(maxsize=None)
def _jax_counts_at(K, NC):
    """(world of NC chains after one JAX sweep of NARROW_GRAPHS[K], JAX's
    counts of it as [K, P])."""
    g, colors = NARROW_GRAPHS[K]()
    dg, info = jax_compile(g, colors=colors)
    assert info.max_card == K
    d = jax_to_device(dg)
    key = jax.random.PRNGKey(K * 1000 + NC)
    vals = jmc.init_values_mc(d, key, NC, info)
    vals, counts = jmc.run_inference_mc(d, vals, d.w_init,
                                        jax.random.fold_in(key, 1), 1, False,
                                        info, ("off", "off"))
    return np.asarray(vals), np.asarray(counts).reshape(K, -1)


@pytest.mark.parametrize("NC", NARROW_NC)
@pytest.mark.parametrize("K", NARROW_K)
def test_narrow_tally_equals_jax_counts(K, NC):
    """Worlds of 1 to 136 chains: the port's tally gives JAX's
    run_inference_mc counts exactly, and so does the plain version in
    bincount blocks of a few rows."""
    vals, ref = _jax_counts_at(K, NC)
    assert vals.shape[1] == NC
    v = torch.from_numpy(vals.copy())
    counts = torch.zeros(ref.shape, dtype=torch.int32)
    tmc.tally(counts, v)
    np.testing.assert_array_equal(counts.numpy(), ref)
    blocks = torch.zeros(ref.shape, dtype=torch.int32)
    tally_plain(blocks, v, chunk_elems=3 * NC)
    np.testing.assert_array_equal(blocks.numpy(), ref)


@pytest.mark.parametrize("NC,dtype,K", [
    (1, torch.int8, 2), (2, torch.int8, 4), (3, torch.int8, 16),
    (4, torch.int8, 2), (15, torch.int8, 9), (1, torch.int32, 2),
    (3, torch.int32, 16), (1, torch.int8, 17), (3, torch.int32, 200),
    (4, torch.int32, 2), (16, torch.int8, 2), (37, torch.int8, 2)])
def test_tally_counts_wrapper_on_cpu_at_narrow_and_wide_rows(NC, dtype, K):
    """The wrapper on the CPU at the rows the kernel counts in tiles (1-15
    int8 or 1-3 int32 chains at K <= 16) and beside them (K = 17 and up,
    int32 rows of 16 bytes, 16 and 37 chains): the counts of a compare a
    value, values outside [0, K) counted nowhere, and no launch counted."""
    v = torch.randint(-2, K + 2, (29, NC), dtype=dtype,
                      generator=torch.Generator().manual_seed(NC * K))
    before = (tally_counts.launches, tally_counts.narrow_launches)
    counts = torch.ones((K, 29), dtype=torch.int32)
    tally_counts(counts, v)
    assert (tally_counts.launches, tally_counts.narrow_launches) == before
    ref = 1 + torch.stack([(v == k).sum(1) for k in range(K)]).to(
        torch.int32)
    assert torch.equal(counts, ref)


def test_tally_counts_wrapper_on_cpu_counts_no_launch():
    v = torch.randint(0, 3, (11, 16), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0))
    before = (tally_counts.launches, tally_counts.narrow_launches)
    counts = torch.zeros((3, 11), dtype=torch.int32)
    tally_counts(counts, v)
    one = torch.zeros((3, 11), dtype=torch.int32)
    tally_counts(one, v[:, :1].contiguous())
    assert (tally_counts.launches, tally_counts.narrow_launches) == before
    ref = torch.stack([(v == k).sum(1) for k in range(3)]).to(torch.int32)
    assert torch.equal(counts, ref)
    ref = torch.stack([v[:, 0] == k for k in range(3)]).to(torch.int32)
    assert torch.equal(one, ref)


# --------------------------------------------------------------------------
# world-write mode against output + masked write
# --------------------------------------------------------------------------

def _evidence(g, frac, seed, card=2):
    rng = np.random.default_rng(seed)
    g.var_role[:] = rng.random(g.n_vars) < frac
    g.var_init[:] = rng.integers(0, card, g.n_vars)
    return g


def _ising():
    g, colors = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    dg, info = compile_graph(_evidence(g, 0.3, 1), colors=colors, **BAND)
    assert info.affine2
    return dg, info


def _triple():
    g, colors = big_triple_grid(16, 16)
    dg, info = compile_graph(_evidence(g, 0.3, 2), colors=colors, **BAND)
    assert info.fusedm
    return dg, info


def _potts():
    g, colors = big_potts_grid(16, 16, card=3, seed=3)
    dg, info = compile_graph(_evidence(g, 0.3, 3, card=3), colors=colors,
                             **BAND)
    assert info.affinek
    return dg, info


def _draw_args(kind, d, info, c, values, seed):
    ts, ti = d.tiers[0], info.tiers[0]
    C = info.n_colors
    if kind == "ising":
        beta, base = fold_affine(ts, ti, C, d.w_init)
        return (fused_color_draw_plain, fused_color_draw,
                (values, ts.bd_nbr, ts.bd_start[c], beta, base, c, seed,
                 ti.band_w, ti.band_tb, ti.degree))
    if kind == "triple":
        return (fused_dm_draw_plain, fused_dm_draw,
                (values, ts.bd_dmnbr, ts.bd_start[c],
                 *fold_deltam_tiles(ts, ti, C, d.w_init), c, seed, ti.band_w,
                 ti.band_tb, ti.degree, ti.arity - 1, ti.band_k))
    av, bv, kmask = fold_affine_cat(ts, ti, C, d.w_init)
    return (fused_cat_draw_plain, fused_cat_draw,
            (values, ts.bd_nbr, ts.bd_start[c], ts.bd_eqo, ts.bd_eqn, av,
             bv, kmask, c, seed, ti.band_w, ti.band_tb, ti.degree,
             info.max_card))


GRAPHS = {"ising": _ising, "triple": _triple, "potts": _potts}


def _world_write_case(kind, evidence, short, device, use_kernel):
    dg, info = GRAPHS[kind]()
    d = to_device(dg, device)
    ts, ti = d.tiers[0], info.tiers[0]
    B = info.block_size
    P = d.var_card.shape[0]
    K = info.max_card
    gen = torch.Generator(device=device).manual_seed(11)
    for c in range(info.n_colors):
        world = torch.randint(0, K, (P, 48), generator=gen, device=device,
                              dtype=torch.int8)
        seed = torch.tensor([7 + c, -31 * c - 1], dtype=torch.int32,
                            device=device)
        mask = (ts.cm_resample_ev if evidence else ts.cm_resample)[c]
        n = ti.block - 5 if short else ti.block
        mask = mask[:n]
        start = c * B + ti.off
        plain, kernel, args = _draw_args(kind, d, info, c, world.clone(),
                                         seed)
        draw = kernel if use_kernel else plain
        out = draw(*args)
        assert out.shape[0] == ti.block
        ref = world.clone()
        blk = ref[start:start + n]
        blk.copy_(torch.where(mask[:, None], out[:n], blk))
        got = world.clone()
        back = draw(got, *args[1:], write=(start, mask))
        assert back is got
        assert torch.equal(got, ref), (kind, c)
        # nothing outside the block's selected rows moved
        changed = (got != world).any(dim=1).nonzero().flatten()
        rows = changed - start
        assert bool(((rows >= 0) & (rows < n)).all())
        assert bool(mask[rows].all())


@pytest.mark.parametrize("short", [False, True], ids=["block", "short"])
@pytest.mark.parametrize("evidence", [False, True], ids=["query", "ev"])
@pytest.mark.parametrize("kind", ["ising", "triple", "potts"])
def test_world_write_equals_output_and_masked_write(kind, evidence, short):
    _world_write_case(kind, evidence, short, "cpu", use_kernel=False)


def test_world_write_target_checks_the_block():
    """The kernels' world-write target: no delta or logits output, and a
    block inside the world of at most the drawn rows."""
    world = torch.zeros((40, 16), dtype=torch.int8)
    mask = torch.ones(8, dtype=torch.bool)
    target = _write_target("draw", world, (16, mask), 8, None)
    assert target[0] is world and target[3] == 8
    assert target[1] == world.data_ptr() + 16 * 16
    for write, n_rows, extra in (((16, mask), 8, True), ((16, mask), 7, None),
                                 ((33, mask), 8, None), ((-1, mask), 8, None)):
        with pytest.raises(ValueError):
            _write_target("draw", world, write, n_rows, extra)


# --------------------------------------------------------------------------
# inference through the world-write route
# --------------------------------------------------------------------------

def _clamped(g, n_query, seed, card=2):
    rng = np.random.default_rng(seed)
    query = rng.choice(g.n_vars, n_query, replace=False)
    g.var_role[:] = fs.ROLE_EVIDENCE
    g.var_role[query] = fs.ROLE_QUERY
    g.var_init[:] = rng.integers(0, card, g.n_vars)
    return query


@pytest.mark.parametrize("kind", ["ising", "triple", "potts"])
def test_infer_mc_world_write_route_matches_oracle(kind):
    if kind == "ising":
        g, colors = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
        card = 2
    elif kind == "triple":
        g, colors = big_triple_grid(16, 16)
        card = 2
    else:
        g, colors = big_potts_grid(16, 16, card=3, seed=5)
        card = 3
    query = _clamped(g, 10, 4, card)
    dg, info = compile_graph(g, colors=colors, **BAND)
    assert info.affine2 or info.fusedm or info.affinek
    assert all(tmc.route(ti, info).draw in ("color", "dm", "cat")
               for ti in info.tiers)
    d = to_device(dg, "cpu")
    marg, _ = tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(2),
                           100, 1500, info, 32, device="cpu")
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    err = float(np.abs(marg[query, :card] - exact[query]).max())
    assert err < TOL, err


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("K,NC", [(2, 512), (4, 48), (17, 37), (200, 48),
                                  (2000, 16)])
def test_tally_kernel_matches_plain_on_card(cuda_device, K, NC):
    gen = torch.Generator(device=cuda_device).manual_seed(K)
    dt = torch.int8 if K <= 120 else torch.int32
    v = torch.randint(-2, min(K + 4, 127), (1001, NC), generator=gen,
                      device=cuda_device, dtype=dt)
    got = torch.ones((K, 1001), dtype=torch.int32, device=cuda_device)
    ref = got.clone()
    tally_counts(got, v)
    tally_plain(ref, v)
    assert torch.equal(got, ref)


def _narrow_case_on_card(device, K, NC, dt):
    """tally_counts against its plain version, exactly, on a random world of
    10,007 rows (not a multiple of a block's rows or tile, and not of 4, so
    each counts row has its own 16-byte phase), aligned and one element off
    the 16-byte grid."""
    gen = torch.Generator(device=device).manual_seed(K + NC)
    v = torch.randint(-2, min(K + 4, 127), (10_007, NC), generator=gen,
                      device=device, dtype=dt)
    buf = torch.empty(v.numel() + 1, dtype=dt, device=device)
    buf[1:].copy_(v.reshape(-1))
    for world in (v, buf[1:].view(v.shape)):
        got = torch.ones((K, v.shape[0]), dtype=torch.int32, device=device)
        ref = got.clone()
        tally_counts(got, world)
        tally_plain(ref, world)
        assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("NC", NARROW_NC)
@pytest.mark.parametrize("K", NARROW_K)
def test_narrow_tally_kernel_matches_plain_on_card(cuda_device, K, NC):
    """Narrow rows on the card: tiles of consecutive positions (rows under
    16 bytes), a segment of NC/16 lanes a row (U rows a segment), byte
    rows."""
    _narrow_case_on_card(cuda_device, K, NC,
                         torch.int8 if K <= 120 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("NC", (1, 3))
@pytest.mark.parametrize("K", (2, 16))
def test_narrow_int32_tally_kernel_matches_plain_on_card(cuda_device, K, NC):
    """The tile way on int32 worlds (rows of 4 and 12 bytes)."""
    _narrow_case_on_card(cuda_device, K, NC, torch.int32)


@pytest.mark.gpu
def test_narrow_launches_count_the_tile_way_on_card(cuda_device):
    """tally_counts.narrow_launches counts the launches of rows under 16
    bytes at K <= 16, and no other."""
    for K, NC, dt, narrow in ((2, 1, torch.int8, True),
                              (16, 3, torch.int8, True),
                              (2, 3, torch.int32, True),
                              (2, 8, torch.int8, True),
                              (2, 4, torch.int32, False),
                              (2, 16, torch.int8, False),
                              (2, 37, torch.int8, False),
                              (17, 1, torch.int8, False)):
        v = torch.zeros((100, NC), dtype=dt, device=cuda_device)
        counts = torch.zeros((K, 100), dtype=torch.int32, device=cuda_device)
        before = (tally_counts.launches, tally_counts.narrow_launches)
        tally_counts(counts, v)
        assert (tally_counts.launches, tally_counts.narrow_launches) == (
            before[0] + 1, before[1] + narrow), (K, NC, dt)
        assert int(counts[0].sum()) == 100 * NC


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ising", "triple", "potts"])
def test_world_write_kernels_match_on_card(cuda_device, kind):
    for evidence in (False, True):
        for short in (False, True):
            _world_write_case(kind, evidence, short, cuda_device,
                              use_kernel=True)
