"""The port's multi-window banded gather against the JAX package's.

The plain PyTorch version must equal banded_gather_pallas_multi (interpret
mode) and banded_gather_xla_multi exactly: an index remapped into the K
windows laid end to end reads ``values[starts[t, i // W] + i % W]``, the
sentinel K*W reads 0.  On compiled multi-window graphs (a 3-colored
triple grid and a 3-colored Ising grid, band_k 2) it equals the row gather
of cs_nbr, and so does the port's own graph-level gather (_gather_nbr).
The CUDA kernel is held to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu.ops.banded import (banded_gather_pallas_multi,
                                    banded_gather_xla_multi)
from sampler_tpu_torch.benchgraphs import big_ising_grid, big_triple_grid
from sampler_tpu_torch.compile import compile_graph, to_device
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.ops.banded import (banded_gather_multi,
                                          banded_gather_multi_plain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instance(seed, P=4097, NC=16, ntiles=8, R=256, W=512, K=3):
    """Random tiles of K ascending windows; one tile's last window is
    clipped to P - W (unaligned), and 5% of the slots hold the sentinel
    K*W.  Every values row is random, so window semantics are exercised."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, P - W, (ntiles, K)) // 256 * 256,
                     axis=1).astype(np.int32)
    starts[0, -1] = P - W
    rnbr = rng.integers(0, K * W, (ntiles, R))
    rnbr = np.where(rng.random((ntiles, R)) < 0.05, K * W, rnbr)
    vals = rng.integers(-5, 6, (P, NC), dtype=np.int8)
    return vals, rnbr.astype(np.int32), starts, W


def _reference(vals, rnbr, starts, W):
    K = starts.shape[1]
    real = rnbr < K * W
    k = np.where(real, rnbr // W, 0)
    rows = np.take_along_axis(starts, k, axis=1) + rnbr % W
    out = vals[np.where(real, rows, 0).reshape(-1)].copy()
    out[~real.reshape(-1)] = 0
    return out


@pytest.mark.parametrize("seed,K", [(0, 2), (1, 3), (2, 4)])
def test_plain_equals_jax_multi_gathers(seed, K):
    vals, rnbr, starts, W = _instance(seed, K=K)
    assert (starts % 256 != 0).any() and (rnbr == K * W).any()
    args = (jnp.asarray(vals), jnp.asarray(rnbr), jnp.asarray(starts), W, K)
    pallas = np.asarray(banded_gather_pallas_multi(*args, interpret=True))
    xla = np.asarray(banded_gather_xla_multi(*args))
    out = banded_gather_multi_plain(torch.from_numpy(vals),
                                    torch.from_numpy(rnbr),
                                    torch.from_numpy(starts), W).numpy()
    np.testing.assert_array_equal(out, pallas)
    np.testing.assert_array_equal(out, xla)
    np.testing.assert_array_equal(out, _reference(vals, rnbr, starts, W))


def test_rows_past_P_read_zero():
    """A window start moved so that its window runs past P: the rows at or
    past P read 0, the rows before them their values."""
    vals, rnbr, starts, W = _instance(4, K=2)
    P = vals.shape[0]
    starts[:, 1] = P - W // 2
    out = banded_gather_multi_plain(torch.from_numpy(vals),
                                    torch.from_numpy(rnbr),
                                    torch.from_numpy(starts), W).numpy()
    rows = np.take_along_axis(starts, np.minimum(rnbr // W, 1), axis=1) \
        + rnbr % W
    past = ((rnbr < 2 * W) & (rows >= P)).reshape(-1)
    inside = ((rnbr < 2 * W) & (rows < P)).reshape(-1)
    assert past.any() and inside.any()
    assert (out[past] == 0).all()
    np.testing.assert_array_equal(out[inside],
                                  vals[rows.reshape(-1)[inside]])


def _ising3():
    g, _ = big_ising_grid(32, 32)
    r, c = np.divmod(np.arange(g.n_vars), 32)
    return g, ((r + c) % 3).astype(np.int32)


MW_GRAPHS = {
    "triple_grid": (lambda: big_triple_grid(32, 32), 3),
    "ising_3color": (_ising3, 2),
}


def _compiled(name):
    make, arity = MW_GRAPHS[name]
    g, colors = make()
    dg, info = compile_graph(g, colors=colors, band_tile=8,
                             band_min_block=1, band_wmax=512)
    ti = info.tiers[0]
    assert len(info.tiers) == 1 and ti.band_k == 2 and ti.arity == arity
    assert ti.fusedm and not ti.affine2
    return dg, info


@pytest.mark.parametrize("name", sorted(MW_GRAPHS))
def test_compiled_multi_gather_equals_row_gather(name):
    dg, info = _compiled(name)
    ts, ti = dg.tiers[0], info.tiers[0]
    P = dg.var_card.shape[0]
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2, (P, 8), dtype=np.int8)
    vals[P - 1] = 0                      # the dummy row reads 0
    A1 = ti.arity - 1
    for c in range(info.n_colors):
        out = banded_gather_multi_plain(
            torch.from_numpy(vals), torch.from_numpy(ts.bd_rnbr[c]),
            torch.from_numpy(ts.bd_start[c]), ti.band_w).numpy()
        nbr = ts.cs_nbr[c].reshape(-1)
        assert nbr.size == ti.block * ti.degree * A1
        np.testing.assert_array_equal(out, vals[nbr])


@pytest.mark.parametrize("name", sorted(MW_GRAPHS))
def test_gather_nbr_multi_window_rows(name):
    """_gather_nbr's multi-window branch, whole color and a tile-aligned
    row range, equals index_select over cs_nbr."""
    dg, info = _compiled(name)
    d = to_device(dg, "cpu")
    ts, ti = d.tiers[0], info.tiers[0]
    assert tmc.route(ti, info).band and ti.band_k >= 2
    P = dg.var_card.shape[0]
    vals = torch.from_numpy(
        np.random.default_rng(1).integers(0, 2, (P, 8), dtype=np.int8))
    vals[P - 1] = 0
    B, D, A1 = ti.block, ti.degree, ti.arity - 1
    TB = ti.band_tb
    for c in range(info.n_colors):
        nbr = tmc._tc(ts.cs_nbr, c, (B, D, A1))
        for r0, rc in ((0, B), (2 * TB, 3 * TB)):
            part = nbr[r0:r0 + rc]
            got = tmc._gather_nbr(ts, ti, vals, part, c, info, r0)
            ref = vals.index_select(0, part.reshape(-1)).reshape(
                got.shape)
            assert torch.equal(got, ref)


def test_wrapper_on_cpu_is_plain_and_counts_no_launch():
    vals, rnbr, starts, W = _instance(3)
    before = banded_gather_multi.launches
    args = (torch.from_numpy(vals), torch.from_numpy(rnbr),
            torch.from_numpy(starts), W)
    assert torch.equal(banded_gather_multi(*args),
                       banded_gather_multi_plain(*args))
    assert banded_gather_multi.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed,NC", [(0, 160), (1, 1024), (2, 37)])
def test_kernel_equals_plain_on_card(cuda_device, seed, NC):
    vals, rnbr, starts, W = _instance(seed, NC=NC)
    args = (torch.from_numpy(vals).to(cuda_device),
            torch.from_numpy(rnbr).to(cuda_device),
            torch.from_numpy(starts).to(cuda_device), W)
    before = banded_gather_multi.launches
    out = banded_gather_multi(*args)
    torch.cuda.synchronize()
    assert banded_gather_multi.launches == before + 1
    assert torch.equal(out, banded_gather_multi_plain(*args))
