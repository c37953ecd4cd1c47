"""The port's command line (sampler_tpu_torch.cli) end to end on the CPU,
mirroring tests/test_cli.py: binary graph files written by the port, then
``gibbs`` with ``--device cpu``.

  * marginals against exact enumeration (|dp| < 0.015, test_cli.py's
    bound), one weight line a weight;
  * learning on a labelled coin reaches the labels' log-odds (within
    0.2), and --profile writes a trace;
  * a run killed by the fault hook (in learning, burn-in or inference)
    and resumed writes the bytes of an uninterrupted checkpointed run,
    whose weight and marginals are held to the log-odds and to exact
    enumeration (the coin, the 3x3 grid and the sparse categorical graph);
    each learning chunk starts at its epoch's step size;
  * the checkpoint keeps the JAX package's .npz layout and the worlds'
    dtype; the chain rounding of the card; a resume from another run's
    checkpoint is refused;
  * --n_graph_shards 2 --device cpu (two CPU ranks over Gloo) against
    exact enumeration, with learning; killed in learning or inference and
    resumed, it writes the bytes of an uninterrupted checkpointed run; a
    shard count that does not divide the card count exits with the JAX
    command's message; the default device raises without a card.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sampler_tpu import checkpoint as jax_checkpoint
from sampler_tpu_torch import checkpoint, compile_graph, fixtures, oracle
from sampler_tpu_torch.cli import chunk_generator, main
from sampler_tpu_torch.engine import multichain
from sampler_tpu_torch.engine.multichain import effective_chains
from sampler_tpu_torch.io import binary, results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(g, d) -> list:
    meta = binary.write_graph(g, str(d))
    return ["-w", str(d / "graph.weights"), "-v", str(d / "graph.variables"),
            "-f", str(d / "graph.factors"), "-m", meta]


def _dw(args, env_extra=None):
    """The command in a child process (the fault hook ends its process)."""
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "sampler_tpu_torch.cli"]
                          + args, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_gibbs_end_to_end(tmp_path):
    g = fixtures.ising_grid(3, 3, w_pair=0.4, w_bias=0.3)
    out = tmp_path / "out"
    assert main(["gibbs", *_files(g, tmp_path), "-o", str(out), "-i", "2000",
                 "-b", "200", "--n_chains", "8", "--device", "cpu",
                 "--quiet"]) == 0
    parsed = results.read_marginals(str(out / "inference_result.out.text"))
    exact = oracle.exact_marginals(g)
    assert len(parsed) == g.n_vars
    assert max(abs(p - exact[v, 1]) for v, _, p in parsed) < 0.015
    wlines = (out / "inference_result.out.weights.text").read_text() \
        .splitlines()
    assert len(wlines) == g.n_weights


def test_gibbs_learning_end_to_end(tmp_path):
    g = fixtures.labeled_coin_graph(n_flips=300, p_heads=0.8, seed=5)
    out, prof = tmp_path / "out", tmp_path / "prof"
    assert main(["gibbs", *_files(g, tmp_path), "-o", str(out), "-l", "300",
                 "-a", "0.02", "-d", "0.995", "-i", "10", "--device", "cpu",
                 "--profile", str(prof), "--quiet"]) == 0
    assert (prof / "trace.json").stat().st_size > 0
    w = float((out / "inference_result.out.weights.text").read_text()
              .split()[1])
    p_hat = g.var_init.mean()
    assert abs(w - np.log(p_hat / (1 - p_hat))) < 0.2


def _learned(out) -> np.ndarray:
    return np.array([float(ln.split()[1]) for ln in
                     (out / "inference_result.out.weights.text")
                     .read_text().splitlines()])


def _oracle_err(g, out, weights=None) -> float:
    """Largest |dp| of the query variables' marginals in ``out`` against
    exact enumeration (at ``weights``, the graph's own by default)."""
    exact = oracle.exact_marginals(g, clamp_evidence=True, weights=weights)
    return max(abs(p - exact[v, 1 if c is None else c]) for v, c, p in
               results.read_marginals(str(out / "inference_result.out.text"))
               if g.var_role[v] == 0)


def _coin_log_odds(g, out) -> float:
    p_hat = g.var_init.mean()
    return abs(_learned(out)[0] - np.log(p_hat / (1 - p_hat)))


RESUME = {
    # graph, arguments, checkpoint saves before the kill, the phase it
    # kills, and the check of the outputs against the truth with its bound
    "coin": (lambda: fixtures.labeled_coin_graph(n_flips=60, p_heads=0.75,
                                                 seed=7),
             ["-l", "100", "-a", "0.02", "-d", "0.97", "-b", "50", "-i",
              "100", "--n_chains", "4", "--checkpoint_every", "25"], 2,
             "learn", _coin_log_odds, 0.2),
    "grid": (lambda: fixtures.ising_grid(3, 3, w_pair=0.4, w_bias=0.3),
             ["-b", "200", "-i", "2000", "--n_chains", "8",
              "--checkpoint_every", "100"], 1, "burn",
             lambda g, out: _oracle_err(g, out), 0.015),
    "sparse": (lambda: fixtures.sparse_categorical_graph(n=5),
               ["-l", "3", "-a", "0.05", "-b", "100", "-i", "1000",
                "--n_chains", "64", "--checkpoint_every", "250",
                "--learn_non_evidence"], 3, "infer",
               lambda g, out: _oracle_err(g, out, _learned(out)), 0.01),
}


@pytest.mark.parametrize("name", sorted(RESUME))
def test_checkpoint_kill_and_resume(name, tmp_path):
    """A run killed after some checkpoint saves (in learning, burn-in or
    inference) and then --resume'd writes EXACTLY the outputs of an
    uninterrupted run with the same --checkpoint_every: each chunk's
    generator comes from the absolute epoch or sweep index.  Both are held
    to the truth: the coin's learned weight to the labels' log-odds, the
    marginals to exact enumeration (the sparse graph's at the weights it
    learned)."""
    make, args, kill_after, phase, check, bound = RESUME[name]
    g = make()
    base = ["gibbs", *_files(g, tmp_path), *args, "--device", "cpu",
            "--quiet"]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    r = _dw(base + ["-o", str(out_a)])
    assert r.returncode == 0, r.stderr
    r = _dw(base + ["-o", str(out_b)],
            {"SAMPLER_TPU_FAULT_AFTER": str(kill_after)})
    assert r.returncode == 3, (r.returncode, r.stderr)
    assert (out_b / "checkpoint.npz").exists()
    assert not (out_b / "inference_result.out.text").exists()
    state = checkpoint.load(str(out_b / "checkpoint.npz"))
    assert state.meta["phase"] == phase and state.values.dtype == np.int8
    r = _dw(base + ["-o", str(out_b), "--resume"])
    assert r.returncode == 0, r.stderr
    for fname in ["inference_result.out.text",
                  "inference_result.out.weights.text"]:
        assert (out_a / fname).read_bytes() == (out_b / fname).read_bytes(), \
            fname
    err = check(g, out_b)
    assert err < bound, (name, err)


def test_chunked_learning_steps(monkeypatch, tmp_path):
    """Each learning chunk starts at its absolute epoch's step size
    (stepsize * diminish ** epoch) from the worlds the last chunk left;
    without checkpoints the phase is one chunk."""
    calls = []
    learn_mc = multichain.learn_mc

    def spy(d, w, gen, cfg, info, n_chains, v_ev=None, v_free=None,
            alpha=None, device="cuda"):
        calls.append((cfg.n_epochs, alpha, v_ev is None))
        return learn_mc(d, w, gen, cfg, info, n_chains, v_ev=v_ev,
                        v_free=v_free, alpha=alpha, device=device)

    monkeypatch.setattr(multichain, "learn_mc", spy)
    g = fixtures.labeled_coin_graph(n_flips=20, seed=1)
    base = ["gibbs", *_files(g, tmp_path), "-l", "10", "-a", "0.1", "-d",
            "0.9", "-i", "2", "--n_chains", "2", "--device", "cpu",
            "--quiet"]
    assert main(base + ["-o", str(tmp_path / "a"), "--checkpoint_every",
                        "4"]) == 0
    assert [(n, first) for n, _, first in calls] == [(4, True), (4, False),
                                                     (2, False)]
    np.testing.assert_allclose([a for _, a, _ in calls],
                               [0.1, 0.1 * 0.9 ** 4, 0.1 * 0.9 ** 8],
                               rtol=1e-12)
    calls.clear()
    assert main(base + ["-o", str(tmp_path / "b")]) == 0
    assert calls == [(10, 0.1, True)]


@pytest.mark.parametrize("every", [0, 5])
def test_worlds_leave_the_device_only_for_checkpoints(every, monkeypatch,
                                                      tmp_path):
    """Without --checkpoint_every no world is copied to the host (only
    the counts, the position map and the weights are); with it, every
    save copies them."""
    import sampler_tpu_torch.cli as cli_mod

    host = cli_mod._host
    shapes = []

    def spy(t):
        shapes.append(tuple(t.shape))
        return host(t)

    monkeypatch.setattr(cli_mod, "_host", spy)
    g = fixtures.labeled_coin_graph(n_flips=20, seed=1)
    assert main(["gibbs", *_files(g, tmp_path), "-o", str(tmp_path / "o"),
                 "-l", "10", "-b", "5", "-i", "10", "--n_chains", "3",
                 "--checkpoint_every", str(every), "--device", "cpu",
                 "--quiet"]) == 0
    worlds = [s for s in shapes if len(s) == 2 and s[1] == 3]
    assert len(worlds) == (0 if not every else 2 * 2 + 1 + 2)


def test_resume_from_another_run_is_refused(tmp_path):
    g = fixtures.labeled_coin_graph(n_flips=20, seed=1)
    base = ["gibbs", *_files(g, tmp_path), "-o", str(tmp_path / "o"), "-l",
            "2", "-i", "10", "--n_chains", "2", "--checkpoint_every", "5",
            "--device", "cpu", "--quiet"]
    assert main(base) == 0
    with pytest.raises(SystemExit, match="different run"):
        main(base + ["--resume", "--seed", "9"])


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_checkpoint_layout_and_dtype(dtype, tmp_path):
    """The .npz layout is the JAX package's: each package loads what the
    other saved, worlds in their dtype (int32 above card 127)."""
    rng = np.random.default_rng(0)
    values = rng.integers(0, 100, (11, 2, 5)).astype(dtype)
    state = checkpoint.SamplerState(
        values=values, weights=rng.normal(size=4).astype(np.float32),
        rng_key=np.array([7, 0], np.uint32),
        counts=rng.integers(0, 9, (11, 3)), sweep=40, epoch=3,
        meta={"phase": "learn", "n_chains": 5})
    for save, load in ((checkpoint.save, jax_checkpoint.load),
                       (jax_checkpoint.save, checkpoint.load)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(state, path)
        back = load(path)
        assert back.values.dtype == dtype
        for f in ("values", "weights", "rng_key", "counts"):
            assert np.array_equal(getattr(back, f), getattr(state, f)), f
        assert (back.sweep, back.epoch, back.meta) == (40, 3, state.meta)


def test_chain_rounding_and_generators(monkeypatch):
    _, info = compile_graph(fixtures.biased_coin())
    assert effective_chains(info, "cuda", 1, 1000) == 16
    assert effective_chains(info, "cuda", 37, 1000, n_worlds=2) == 48
    assert effective_chains(info, "cuda", 64, 1000) == 64
    assert effective_chains(info, "cpu", 1, 1000) == 1
    monkeypatch.setattr(multichain, "AUTOCHAIN_BYTES", 1000)
    assert effective_chains(info, "cuda", 3, 1000) == 3
    a, b = (chunk_generator(0, "burn", 25, "cpu") for _ in range(2))
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    c = chunk_generator(0, "burn", 50, "cpu")
    assert not torch.equal(torch.rand(5, generator=c),
                           torch.rand(5, generator=b))


def test_graph_sharding_exits_with_message(tmp_path, monkeypatch):
    """A shard count that does not divide the card count exits with the
    JAX command's message, before anything is loaded (three cards
    pretended; nothing reaches them)."""
    g = fixtures.ising_grid(2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(SystemExit, match="--n_graph_shards 2 does not "
                       "divide the 3 available devices"):
        main(["gibbs", *_files(g, tmp_path), "-o", str(tmp_path / "o"),
              "--n_graph_shards", "2"])
    assert not (tmp_path / "o").exists()


def test_graph_sharded_gibbs_matches_oracle(tmp_path):
    g = fixtures.ising_grid(3, 3, w_pair=0.4, w_bias=0.3)
    out = tmp_path / "out"
    assert main(["gibbs", *_files(g, tmp_path), "-o", str(out), "-i", "2000",
                 "-b", "200", "-l", "2", "-a", "0.001", "--n_chains", "8",
                 "--n_graph_shards", "2", "--device", "cpu",
                 "--quiet"]) == 0
    learned = _learned(out)
    assert len(learned) == g.n_weights
    assert _oracle_err(g, out, learned) < 0.015


SHARDED_RESUME = {
    # arguments, checkpoint saves before the kill, the phase it kills
    "learn": (["-l", "40", "-a", "0.02", "-d", "0.97", "-b", "20", "-i",
               "60", "--checkpoint_every", "15"], 1, "gs_learn"),
    "infer": (["-b", "20", "-i", "60", "--checkpoint_every", "15"], 2,
              "gs_infer"),
}


@pytest.mark.parametrize("name", sorted(SHARDED_RESUME))
def test_graph_sharded_kill_and_resume(name, tmp_path):
    """--n_graph_shards 2 killed by the fault hook (rank 0 ends its
    process; the other rank ends with it) and resumed writes the bytes of
    an uninterrupted checkpointed run."""
    args, kill_after, phase = SHARDED_RESUME[name]
    g = fixtures.labeled_coin_graph(n_flips=60, p_heads=0.75, seed=7)
    base = ["gibbs", *_files(g, tmp_path), *args, "--n_chains", "4",
            "--n_graph_shards", "2", "--device", "cpu", "--quiet"]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    r = _dw(base + ["-o", str(out_a)])
    assert r.returncode == 0, r.stderr
    r = _dw(base + ["-o", str(out_b)],
            {"SAMPLER_TPU_FAULT_AFTER": str(kill_after)})
    assert r.returncode == 3, (r.returncode, r.stderr)
    state = checkpoint.load(str(out_b / "checkpoint.npz"))
    assert state.meta["phase"] == phase and state.meta["n_graph"] == 2
    assert not (out_b / "inference_result.out.text").exists()
    r = _dw(base + ["-o", str(out_b), "--resume"])
    assert r.returncode == 0, r.stderr
    for fname in ["inference_result.out.text",
                  "inference_result.out.weights.text"]:
        assert (out_a / fname).read_bytes() == (out_b / fname).read_bytes(), \
            fname


def test_default_device_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = fixtures.ising_grid(2, 2)
    r = _dw(["gibbs", *_files(g, tmp_path), "-o", str(tmp_path / "o")])
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert not (tmp_path / "o").exists()
