"""The port's chain parallelism (sampler_tpu_torch.parallel.chains), its
mesh and collectives (parallel.comm) and its ranks (parallel.launch), on
CPU ranks over Gloo (tests/test_parallel.py's checks at 4 ranks):

  * infer_sharded against exact enumeration (|dp| < 0.01, JAX's bound) on
    an Ising grid and a categorical graph; learn_sharded reaches the
    labels' log-odds (within 0.2); a chains mesh has one graph column;
  * the collectives: sums and means over both groups, the tiled
    all-gather of rows and the neighbour shift, on a 2 x 2 mesh;
  * make_mesh: a mesh that repeats a card needs backend="gloo", NCCL
    needs distinct cards, the default devices are the cards;
  * a rank that fails makes the call raise with that rank's traceback.
"""
import numpy as np
import pytest
import torch

from sampler_tpu import fixtures as jfx
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu_torch import fixtures, oracle
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine.learn import LearnConfig
from sampler_tpu_torch.parallel import launch
from sampler_tpu_torch.parallel.chains import infer_sharded, learn_sharded
from sampler_tpu_torch.parallel.comm import make_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    """ranks(n_chains, n_graph): CPU ranks of that mesh, kept open for the
    next test that asks for the same shape (a process holds the process
    group of one mesh at a time)."""
    pool = {}

    def get(n_chains, n_graph):
        key = (n_chains, n_graph)
        if key not in pool or pool[key].comm is None:
            for r in pool.values():
                r.close()
            pool.clear()
            pool[key] = launch.Ranks(make_mesh(
                n_chains, n_graph, ["cpu"] * (n_chains * n_graph)))
        return pool[key]

    yield get
    for r in pool.values():
        r.close()


def test_sharded_inference_parity(ranks):
    ranks4 = ranks(4, 1)
    g = fixtures.ising_grid(4, 4, w_pair=0.4, w_bias=0.2)
    dg, info = from_jax(*jax_compile(
        jfx.ising_grid(4, 4, w_pair=0.4, w_bias=0.2)))
    marg, vals = infer_sharded(dg, dg.w_init, 0, 200, 2000, info, ranks4, 4)
    err = np.abs(marg[:, :2] - oracle.exact_marginals(g)).max()
    assert err < 0.01, f"max |dp| = {err:.4f}"
    assert tuple(vals.shape) == (dg.var_card.shape[0], 4)
    assert [r["tally_counts"] for r in ranks4.launches] == [0] * 4  # CPU


def test_sharded_matches_oracle_categorical(ranks):
    ranks4 = ranks(4, 1)
    g = fixtures.categorical_graph(n=5, card=3)
    dg, info = from_jax(*jax_compile(jfx.categorical_graph(n=5, card=3)))
    marg, _ = infer_sharded(dg, dg.w_init, 1, 200, 3000, info, ranks4, 2)
    exact = oracle.exact_marginals(g)
    err = np.abs(marg[:, :exact.shape[1]] - exact).max()
    assert err < 0.01, f"max |dp| = {err:.4f}"


def test_data_parallel_learning(ranks):
    ranks4 = ranks(4, 1)
    gj = jfx.labeled_coin_graph(n_flips=400, p_heads=0.75, seed=2)
    p_hat = gj.var_init.mean()
    w_star = np.log(p_hat / (1 - p_hat))
    dg, info = from_jax(*jax_compile(gj))
    cfg = LearnConfig(n_epochs=150, stepsize=0.05, diminish=0.99,
                      regularization="none")
    w = learn_sharded(dg, dg.w_init, 0, cfg, info, ranks4,
                      chains_per_device=2)
    assert float(w[0]) == pytest.approx(w_star, abs=0.2)
    # the same seed, the same weights; another seed, other draws
    again = learn_sharded(dg, dg.w_init, 0, cfg, info, ranks4, 2)
    other = learn_sharded(dg, dg.w_init, 1, cfg, info, ranks4, 2)
    assert torch.equal(w, again) and not torch.equal(w, other)


def test_chains_mesh_has_one_graph_column():
    dg, info = from_jax(*jax_compile(jfx.biased_coin(), align=16,
                                     shards=2))
    with pytest.raises(ValueError, match="one graph column"):
        infer_sharded(dg, dg.w_init, 0, 1, 1, info,
                      make_mesh(1, 2, ["cpu"] * 2), 4)


def _collectives(comm):
    """Every collective of comm on rank-dependent tensors; returns what
    rank 0 saw (a rank body, importable by the spawned ranks)."""
    r, row, g = comm.rank, comm.row, comm.g
    out = {}
    x = torch.full((3,), float(r))
    out["sum_chains"] = comm.sum_(x.clone(), "chains").tolist()
    out["mean_graph"] = comm.mean_(x.clone(), "graph").tolist()
    rows = torch.zeros((4, 2), dtype=torch.int8)
    rows[2 * g:2 * g + 2] = 10 * row + g + 1
    comm.all_gather_rows(rows, "graph")
    out["gather"] = rows[:, 0].tolist()
    send = torch.full((2,), r + 1, dtype=torch.int32)
    recv = torch.zeros(2, dtype=torch.int32)
    got = comm.shift(send, recv if g >= 1 else None, 1, "graph")
    back = torch.zeros(2, dtype=torch.int32)
    got_back = comm.shift(send, back if g == 0 else None, -1, "graph")
    out["shift"] = (got, recv.tolist(), got_back, back.tolist())
    # every rank checks its own view, so a wrong rank fails the call
    want_gather = [10 * row + 1] * 2 + [10 * row + 2] * 2
    if rows[:, 0].tolist() != want_gather:
        raise AssertionError(f"rank {r}: gather {rows[:, 0].tolist()}")
    return out


def test_collectives_on_a_2x2_mesh(ranks):
    r = ranks(2, 2)
    out = r.run(_collectives)
    assert len(r.launches) == 4
    # rank 0 = (row 0, g 0): chains group {0, 2}, graph group {0, 1}
    assert out["sum_chains"] == [2.0] * 3
    assert out["mean_graph"] == [0.5] * 3
    assert out["gather"] == [1, 1, 2, 2]
    # g 0 has no left neighbour; it receives rank 1's tensor shifted left
    assert out["shift"] == (False, [0, 0], True, [2, 2])


def _fail_on_rank(comm, bad: int):
    if comm.rank == bad:
        raise ValueError(f"rank {bad} failed on purpose")
    t = torch.ones(1)
    comm.sum_(t, "chains")          # waits for the failed rank
    return float(t)


@pytest.mark.parametrize("bad", [1, 0])
def test_failing_rank_fails_the_call(bad, ranks):
    r = ranks(2, 1)
    assert r.run(_fail_on_rank, 5) == 2.0
    with pytest.raises((RuntimeError, ValueError),
                       match=f"rank {bad} failed on purpose"):
        r.run(_fail_on_rank, bad)
    with pytest.raises(RuntimeError, match="closed"):
        r.run(_fail_on_rank, 5)
    # a call on a Mesh starts ranks of its own once none are open
    r.close()
    assert launch.run(make_mesh(2, 1, ["cpu"] * 2), _fail_on_rank, 5) == 2.0


def test_make_mesh_backends():
    m = make_mesh(2, 2, ["cpu"] * 4)
    assert (m.backend, m.size, m.devices) == ("gloo", 4, ("cpu",) * 4)
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        make_mesh(1, 4, ["cuda:0"] * 4)
    shared = make_mesh(1, 4, ["cuda:0"] * 4, backend="gloo")
    assert shared.devices == ("cuda:0",) * 4 and shared.backend == "gloo"
    assert make_mesh(2, 1, ["cuda:0", "cuda:1"]).backend == "nccl"
    with pytest.raises(ValueError, match="distinct card"):
        make_mesh(2, 1, ["cpu", "cpu"], backend="nccl")
    with pytest.raises(ValueError, match="all 'cpu' or all 'cuda'"):
        make_mesh(2, 1, ["cpu", "cuda:0"], backend="gloo")
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(2, 2, ["cpu"] * 3)


def test_default_mesh_is_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, 0"):
        make_mesh(2, 1)
