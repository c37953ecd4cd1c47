"""The port's banded gather against the JAX package's Pallas kernel.

The plain PyTorch version must equal banded_gather_pallas (interpret mode)
exactly, window semantics included: an index outside its tile's window
reads 0, and the planner's clipped starts (P - W, not 256-aligned) are
honoured.  The CUDA kernel is held to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu.ops.banded import banded_gather_pallas
from sampler_tpu_torch.benchgraphs import big_ising_grid
from sampler_tpu_torch.compile import compile_graph
from sampler_tpu_torch.ops.banded import banded_gather, banded_gather_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers (measured 5x slower under xdist without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instance(seed, P=4097, NC=16, ntiles=8, R=256, W=512):
    """Random tiles; half the starts are clipped to P - W (unaligned), and
    5% of the indices point at the dummy slot P - 1.  Every values row,
    the dummy's included, is random, so window semantics are exercised."""
    rng = np.random.default_rng(seed)
    starts = (rng.integers(0, P - W, ntiles) // 256 * 256).astype(np.int32)
    starts[::2] = P - W
    off = rng.integers(-64, W + 64, (ntiles, R))
    nbr = np.clip(starts[:, None] + off, 0, P - 1).astype(np.int32)
    nbr = np.where(rng.random((ntiles, R)) < 0.05, P - 1, nbr).astype(np.int32)
    vals = rng.integers(-5, 6, (P, NC), dtype=np.int8)
    return vals, nbr, starts, W


def _reference(vals, nbr, starts, W):
    local = nbr - starts[:, None]
    inside = ((local >= 0) & (local < W)).reshape(-1)
    out = vals[nbr.reshape(-1)].copy()
    out[~inside] = 0
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_equals_pallas_interpret(seed):
    vals, nbr, starts, W = _instance(seed)
    assert (starts % 256 != 0).any()
    jax_out = np.asarray(banded_gather_pallas(
        jnp.asarray(vals), jnp.asarray(nbr), jnp.asarray(starts), W,
        interpret=True))
    out = banded_gather_plain(torch.from_numpy(vals), torch.from_numpy(nbr),
                              torch.from_numpy(starts), W).numpy()
    np.testing.assert_array_equal(out, jax_out)
    np.testing.assert_array_equal(out, _reference(vals, nbr, starts, W))


@pytest.mark.parametrize("NC,R", [(16, 256), (37, 250), (48, 255)])
def test_plain_equals_pallas_interpret_chain_counts(NC, R):
    """The chain counts the kernel's variants split on (16 and 48 take its
    16-byte rows, 37 its byte rows) and R not a multiple of the kernel's
    four rows a thread, against the Pallas kernel in interpret mode."""
    vals, nbr, starts, W = _instance(10 + NC, NC=NC, R=R)
    jax_out = np.asarray(banded_gather_pallas(
        jnp.asarray(vals), jnp.asarray(nbr), jnp.asarray(starts), W,
        interpret=True))
    out = banded_gather_plain(torch.from_numpy(vals), torch.from_numpy(nbr),
                              torch.from_numpy(starts), W).numpy()
    assert out.shape == (nbr.size, NC)
    np.testing.assert_array_equal(out, jax_out)
    np.testing.assert_array_equal(out, _reference(vals, nbr, starts, W))


def test_wrapper_on_cpu_is_plain_and_counts_no_launch():
    vals, nbr, starts, W = _instance(3)
    before = banded_gather.launches
    args = (torch.from_numpy(vals), torch.from_numpy(nbr),
            torch.from_numpy(starts), W)
    assert torch.equal(banded_gather(*args), banded_gather_plain(*args))
    assert banded_gather.launches == before


def test_compiled_grid_gather_equals_row_gather():
    """On a compiled grid every real neighbour lies in its tile's window,
    and the dummy row is 0: the banded gather equals the row gather."""
    g, colors = big_ising_grid(16, 16)
    dg, info = compile_graph(g, colors=colors, band_tile=8,
                             band_min_block=1)
    ti = info.tiers[0]
    assert ti.band_w > 0 and ti.band_k == 1
    P = dg.var_card.shape[0]
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2, (P, 8), dtype=np.int8)
    vals[P - 1] = 0
    for c in range(info.n_colors):
        nbr = dg.cs_nbr[c].reshape(-1, ti.band_tb * ti.degree * 1)
        out = banded_gather_plain(torch.from_numpy(vals),
                                  torch.from_numpy(nbr),
                                  torch.from_numpy(dg.bd_start[c]),
                                  ti.band_w).numpy()
        np.testing.assert_array_equal(out, vals[nbr.reshape(-1)])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_equals_plain_on_card(cuda_device, seed):
    vals, nbr, starts, W = _instance(seed, NC=160)
    args = (torch.from_numpy(vals).to(cuda_device),
            torch.from_numpy(nbr).to(cuda_device),
            torch.from_numpy(starts).to(cuda_device), W)
    before = banded_gather.launches
    out = banded_gather(*args)
    torch.cuda.synchronize()
    assert banded_gather.launches == before + 1
    assert torch.equal(out, banded_gather_plain(*args))


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose data starts one byte past a 16-byte boundary,
    so the kernel cannot take its 16-byte rows."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("NC,R,misaligned", [
    (16, 256, False), (48, 250, False), (512, 640, False), (37, 255, False),
    (48, 256, True)])
def test_kernel_variants_equal_plain_on_card(cuda_device, NC, R, misaligned):
    """Each variant of the kernel: 16-byte rows (16, 48 and 512 chains),
    byte rows (37 chains, or a values pointer off the 16-byte grid), and R
    not a multiple of the four rows a thread."""
    vals, nbr, starts, W = _instance(20 + NC, NC=NC, R=R)
    v = torch.from_numpy(vals).to(cuda_device)
    if misaligned:
        v = _misaligned(v)
    args = (v, torch.from_numpy(nbr).to(cuda_device),
            torch.from_numpy(starts).to(cuda_device), W)
    before = banded_gather.launches
    out = banded_gather(*args)
    torch.cuda.synchronize()
    assert banded_gather.launches == before + 1
    assert torch.equal(out, banded_gather_plain(*args))
