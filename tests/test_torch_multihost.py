"""The port's entry points in a process group that the test starts itself
(tests/test_multihost.py's checks): four OS processes join one Gloo group
(tests/torch_multihost_worker.py), each running its own rank of
infer_multihost and learn_multihost (the chains mesh of every rank) and
of infer_gs and learn_gs (a 2 x 2 mesh).  The results equal the
single-call API's (ranks it starts itself), bit for bit, on every
process, and meet exact enumeration and the labels' log-odds.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from sampler_tpu import fixtures as jfx
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu_torch import fixtures, oracle
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine.learn import LearnConfig
from sampler_tpu_torch.parallel.chains import infer_sharded, learn_sharded
from sampler_tpu_torch.parallel.comm import make_mesh
from sampler_tpu_torch.parallel.graph_shard import infer_gs, learn_gs
from sampler_tpu_torch.parallel.launch import Ranks

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")
WORLD = 4
COIN_CFG = dict(n_epochs=100, n_sweeps_per_epoch=1, stepsize=0.05,
                diminish=0.99, regularization="none", reg_param=0.0)
COIN_GS_CFG = dict(n_epochs=60, n_sweeps_per_epoch=1, stepsize=0.05,
                   diminish=0.99, regularization="l2", reg_param=0.01)


def _graphs():
    def port(g, **kw):
        return from_jax(*jax_compile(g, **kw))

    return {
        "ising": port(jfx.ising_grid(4, 4, w_pair=0.5, w_bias=0.2)),
        "coin": port(jfx.labeled_coin_graph()),
        "ising_gs": port(jfx.ising_grid(4, 4, w_pair=0.4, w_bias=0.2),
                         align=16, shards=2),
        "coin_gs": port(jfx.labeled_coin_graph(n_flips=200, p_heads=0.7,
                                               seed=3), align=16, shards=2),
        "coin_cfg": COIN_CFG, "coin_gs_cfg": COIN_GS_CFG,
    }


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    """(each process's results, the graphs): the workers run while this
    process makes the single-call results."""
    outdir = str(tmp_path_factory.mktemp("torch_mh"))
    graphs = _graphs()
    with open(os.path.join(outdir, "graphs.pkl"), "wb") as f:
        pickle.dump(graphs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = os.path.join(outdir, "store")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD),
                               store, outdir], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = [{name: np.load(os.path.join(outdir, f"{name}_r{r}.npy"))
                for name in ("marg", "w", "marg_gs", "w_gs")}
               for r in range(WORLD)]
    return results, graphs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chains_multihost_matches_single_call(multihost):
    results, graphs = multihost
    with Ranks(make_mesh(WORLD, 1, ["cpu"] * WORLD)) as ranks:
        dg, info = graphs["ising"]
        marg, _ = infer_sharded(dg, dg.w_init, 7, 50, 400, info, ranks, 8)
        dg, info = graphs["coin"]
        w = learn_sharded(dg, dg.w_init, 11, LearnConfig(**COIN_CFG), info,
                          ranks, 4).numpy()
    for r in range(WORLD):
        np.testing.assert_array_equal(results[r]["marg"], marg)
        np.testing.assert_array_equal(results[r]["w"], w)
    exact = oracle.exact_marginals(
        fixtures.ising_grid(4, 4, w_pair=0.5, w_bias=0.2))
    assert np.abs(marg[:, :2] - exact).max() < 0.05
    g = fixtures.labeled_coin_graph()
    p_hat = g.var_init.mean()
    assert abs(float(w[0]) - np.log(p_hat / (1 - p_hat))) < 0.2


def test_graph_sharded_multihost_matches_single_call(multihost):
    results, graphs = multihost
    with Ranks(make_mesh(2, 2, ["cpu"] * 4)) as ranks:
        dg, info = graphs["ising_gs"]
        marg = infer_gs(dg, dg.w_init, 21, 50, 400, info, ranks, 4)
        dg, info = graphs["coin_gs"]
        w = learn_gs(dg, dg.w_init, 31, LearnConfig(**COIN_GS_CFG), info,
                     ranks, 4).numpy()
    for r in range(WORLD):
        np.testing.assert_array_equal(results[r]["marg_gs"], marg)
        np.testing.assert_array_equal(results[r]["w_gs"], w)
    exact = oracle.exact_marginals(
        fixtures.ising_grid(4, 4, w_pair=0.4, w_bias=0.2))
    assert np.abs(marg[:, :2] - exact).max() < 0.05
    g = fixtures.labeled_coin_graph(n_flips=200, p_heads=0.7, seed=3)
    p_hat = g.var_init.mean()
    assert abs(float(w[0]) - np.log(p_hat / (1 - p_hat))) < 0.25


def test_multihost_needs_a_card_by_default():
    """global_chains_mesh names each process's card unless told the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sampler_tpu_torch.parallel.multihost import global_chains_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        global_chains_mesh()
