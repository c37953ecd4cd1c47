"""DeepDive's spouse example grounded (the benchmark's generator
``gpubench/generators/spouse_kbc.py``, 2 to 50 sentences) through the
port's plain mechanism, against the benchmark's float64 reference
(``gpubench/reference.py``) and exact enumeration:

  * every color's conditional log-odds, from the fold and dm_gather_draw's
    delta mode on seeded worlds, equal the reference's;
  * one learning epoch's weight change is the step times the reference's
    gradient of the epoch's worlds;
  * a 2-sentence graph's marginals from many chains match exact
    enumeration (|dp| < 0.01);
  * a one-marriage factor that holds its variable in both slots adds
    nothing to that variable's log-odds;
  * ``compile.sorted_unique`` is ``np.unique``;
  * dm_gather_draw's plan hands every launch its packed rows: every
    planned row at 16 chains, none at 1024.
"""
import copy

import numpy as np
import pytest
import torch

from gpubench import graphs, harness, reference as ref
from sampler_tpu_torch import FactorGraph, oracle
from sampler_tpu_torch.coloring import greedy_coloring
from sampler_tpu_torch.compile import compile_graph, sorted_unique, to_device
from sampler_tpu_torch.engine import multichain as mc
from sampler_tpu_torch.engine.learn import LearnConfig
from sampler_tpu_torch.ops.fused import dm_gather_draw_plain

# float32 against float64: a log-odds sums at most about 60 terms of
# |w| <= 3, each rounded to float32 (2^-24 relative), so the port's sums
# lie within about 1e-5 of the reference's; 1e-4 leaves room for the
# order of the sum and is far below a bfloat16 evaluation's error (1e-2)
LOGODDS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spouse(n_sentences, seed=7, labels=None, **graph):
    cfg = copy.deepcopy(harness.load_json("configs", "kbc-spouse.json"))
    cfg["graph"].update(n_sentences=n_sentences, **graph)
    return graphs.make(cfg, seed, labels)[0]


def compiled(g):
    fg = FactorGraph(**g)
    colors = greedy_coloring(fg)
    dg, info = compile_graph(fg, colors=colors)
    return fg, colors, dg, info, to_device(dg, "cpu")


def port_logodds(d, info, weights, world_pos) -> torch.Tensor:
    """Each position's conditional log-odds [P, NC] from the fold and
    dm_gather_draw's delta mode, color by color, tier by tier."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    folded = mc.prepare_fold(d, w, info, sharded=True)
    out = torch.zeros(world_pos.shape, dtype=torch.float32)
    for c in range(info.n_colors):
        for t, (ts, ti) in enumerate(zip(d.tiers, info.tiers)):
            assert ti.deltam and not ti.hub
            delta = dm_gather_draw_plain(
                world_pos, *mc._dm_streams(ts, ti, c, info, folded[t]), None)
            start = c * info.block_size + ti.off
            out[start:start + ti.block] = delta
    return out


def vid_world(dg, world_pos):
    return world_pos[torch.as_tensor(np.asarray(dg.pos_of_vid),
                                     dtype=torch.int64)]


@pytest.mark.parametrize("n_sentences,seed",
                         [(2, 3), (12, 5), (50, 2 ** 33 + 9)])
def test_color_logodds_match_the_reference(n_sentences, seed):
    g = spouse(n_sentences, seed)
    fg, colors, dg, info, d = compiled(g)
    fa = ref.Factors(g, "cpu")
    gen = torch.Generator().manual_seed(seed & 0xFFFF)
    world = mc.init_values_mc(d, gen, 16, info)
    got = vid_world(dg, port_logodds(d, info, dg.w_init[:-1], world))
    x = vid_world(dg, world)
    want = ref.logodds(fa, g["w_init"], x, x, colors)
    assert info.n_colors >= 2
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=LOGODDS_TOL)


def test_one_epoch_gradient_matches_the_reference():
    g = spouse(30, 11, labels="evidence")
    fg, colors, dg, info, d = compiled(g)
    fa = ref.Factors(g, "cpu")
    cfg = LearnConfig(n_epochs=1, n_sweeps_per_epoch=1, stepsize=0.01,
                      diminish=0.95, regularization="none", reg_param=0.0)
    gen = torch.Generator().manual_seed(3)
    w0 = d.w_init
    w1, ev, free = mc.learn_mc(d, w0, gen, cfg, info, 16, device="cpu")
    step = float(np.float32(cfg.stepsize))
    want = step * ref.gradient(fa, vid_world(dg, ev), vid_world(dg, free))
    change = (w1 - w0)[:fa.W].double()
    assert float(want.abs().max()) > 1e-3
    # w1 = w0 + step * grad in float32: within a half ulp of |w| <= 3
    # (1.2e-7) beside the float32 gradient's own rounding
    np.testing.assert_allclose(change.numpy(), want.numpy(), rtol=1e-5,
                               atol=5e-7)


def test_two_sentences_match_exact_enumeration():
    g = spouse(2, 4, person_shares={"3": 1.0})
    fg, colors, dg, info, d = compiled(g)
    assert fg.n_vars == 12
    gen = torch.Generator().manual_seed(0)
    marg, _ = mc.infer_mc(d, d.w_init, gen, 100, 1500, info, 256,
                          device="cpu")
    exact = oracle.exact_marginals(fg)
    assert np.abs(marg[:, 1] - exact[:, 1]).max() < 0.01


def test_a_factor_holding_its_variable_twice_adds_nothing():
    """A two-person sentence grounds (0, 1) and (1, 0): each one-marriage
    factor's head is its own body, so the variable's log-odds are its
    features' weights plus the two symmetry factors' w (y - 1) + w y."""
    g = spouse(1, 6, person_shares={"2": 1.0})
    w_sym = g["w_init"][-2]
    one = np.nonzero(g["f_wid"] == len(g["w_init"]) - 1)[0]
    pairs = g["e_vid"][g["f_ptr"][one][:, None] + np.arange(2)]
    assert len(one) == 2 and (pairs[:, 0] == pairs[:, 1]).all()
    fg, colors, dg, info, d = compiled(g)
    fa = ref.Factors(g, "cpu")
    feat = np.zeros(2)
    unary = np.diff(g["f_ptr"]) == 1
    np.add.at(feat, g["e_vid"][g["f_ptr"][:-1][unary]],
              g["w_init"][g["f_wid"][unary]])
    x = torch.tensor([[0, 1, 0, 1], [0, 0, 1, 1]], dtype=torch.int8)
    pos = torch.zeros((d.var_card.shape[0], 4), dtype=torch.int8)
    pos[torch.as_tensor(np.asarray(dg.pos_of_vid), dtype=torch.int64)] = x
    got = vid_world(dg, port_logodds(d, info, dg.w_init[:-1], pos)).double()
    hand = torch.as_tensor(feat)[:, None] + w_sym * (2 * x.flip(0) - 1)
    want = ref.logodds(fa, g["w_init"], x, x, colors)
    np.testing.assert_allclose(want.numpy(), hand.numpy(), atol=1e-12)
    np.testing.assert_allclose(got.numpy(), hand.numpy(), atol=LOGODDS_TOL)


@pytest.mark.parametrize("n", [0, 1, 7, 5000])
def test_sorted_unique_is_np_unique(n):
    a = np.random.default_rng(n).integers(-50, 2 ** 40, n)
    a = np.concatenate([a, a[: n // 3]])
    got = sorted_unique(a)
    np.testing.assert_array_equal(got, np.unique(a))
    assert got.dtype == a.dtype


@pytest.mark.parametrize("n_chains,packed", [(16, True), (1024, False)])
def test_plan_counts_the_packed_rows_of_each_launch(monkeypatch, n_chains,
                                                    packed):
    """The spouse graph's tiers hold 17 to 53 records a row: at 16 chains
    the packed deep-row layout takes every planned row, at 1024 none.  The
    plan counts a launch table's packed rows once and hands each launch
    its count (its tables are built off the card too)."""
    _, _, _, info, d = compiled(spouse(300))
    fold = mc.prepare_fold(d, d.w_init, info)
    plan = fold.dm
    plan.use_tables(d, info, fold)
    assert plan.tiers == list(range(len(info.tiers)))
    calls = []
    monkeypatch.setattr(mc, "dm_gather_draw_table",
                        lambda values, table, seeds, n: calls.append(n))
    values = torch.zeros((d.var_card.shape[0], n_chains), dtype=torch.int8)
    for ev in (False, True):
        for c in range(info.n_colors):
            plan.draw(values, c, ev, torch.Generator().manual_seed(c))
    rows = sum(ti.block for ti in info.tiers)
    assert calls == [rows if packed else 0] * (2 * info.n_colors)
    assert len(plan.counts) == 1
