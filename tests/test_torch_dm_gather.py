"""The port's multilinear gather-draw (dm_gather_draw) of the deltam tiers
without a banded plan, against the JAX package and the oracle.

  * the plain version's delta equals JAX color_delta_multilin's within
    1e-5 on the pairwise and arity-3 deltam tiers of six graphs (KBC
    graphs with a hub tier among them, an Ising and a triple grid that do
    not band, the boolean hub star), in the delta mode on the hub tiers'
    chunks, and on random streams of 600 records a row (rows cut into
    several segments, the last one ragged);
  * the plain hub draw's row sums (each hub row's chunks as one deep row)
    equal JAX hub_color_draw's segment sum within 1e-5 on three hub
    graphs, compiled for one and for two graph shards, and the ranks'
    partial sums add up to it;
  * its delta equals a float32 evaluation in the kernel's fixed order
    (segments of DM_SEGMENT records in the order of d, then the segments
    in order) exactly, and its draws equal a direct evaluation of the
    counter hash and u < sigmoid(delta), bit for bit, over several tiles
    of rows and in chunks of any size;
  * the world-write mode changes only the rows its mask selects;
  * one launch a color over every planned tier draws what the tiers drawn
    one by one draw, given the same seeds;
  * ``route`` sends every deltam tier of a KBC graph, its hub tier
    included, to dm_gather_draw: one call a color (no eager
    color_delta_bool, no hub_color_draw left; the single-chain engine,
    which folds nothing, the reverse), and infer_mc with the one launch a
    color and with a tier at a time (the hub through hub_color_draw and
    the delta mode, as under graph sharding) both match exact enumeration
    (|dp| < 0.01; 0.012 on the hub star, whose hub mixes slowly); two
    runs from one seed write the same bytes;
  * KBC learning on the new route is deterministic for a seed;
  * a run on a device its graph is not on raises, and so do a device with
    no kernel, shapes that disagree and hub chunk offsets that decrease
    or leave [0, M];
  * a fold and its plan free their streams without the cycle collector,
    and the plan's launch tables point into the streams of the graph it
    was folded on.
The CUDA kernel is held to the plain version on the card (gpu marker).
"""
import gc
import weakref
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu.benchgraphs import big_ising_grid as jax_ising_grid
from sampler_tpu.benchgraphs import big_triple_grid as jax_triple_grid
from sampler_tpu.benchgraphs import random_kbc_graph as jax_kbc_graph
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu.graph import FactorGraph as JaxFactorGraph
from sampler_tpu_torch import FactorGraph, oracle
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch.benchgraphs import random_kbc_graph
from sampler_tpu_torch.coloring import greedy_coloring
from sampler_tpu_torch.compile import compile_graph, to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.engine.gibbs import run_sweeps
from sampler_tpu_torch.engine.learn import LearnConfig
from sampler_tpu_torch.ops import fused as tfused
from sampler_tpu_torch.ops.fused import (DM_MAX_TIERS, DM_SEGMENT,
                                         DM_TILE_ROWS, DmTier,
                                         dm_gather_draw,
                                         dm_gather_draw_plain,
                                         dm_gather_draw_tiers,
                                         dm_gather_draw_tiers_plain,
                                         dm_packed_lanes, dm_packed_rows,
                                         dm_tier_table, hash_bits, tile_seed, u32,
                                         uniform24)
from sampler_tpu_torch.parallel import graph_shard as tgs
from torch_routes import WholeShard, infer_on_route

NC = 24
TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _star(graph_cls, n_leaves=14, seed=0):
    """tests/test_hub.py's boolean star: one hub and n_leaves leaves,
    hub-leaf EQUAL couplings (0.4) and ISTRUE biases (0.3)."""
    V = n_leaves + 1
    factors = [(fs.FUNC_ISTRUE, 0, 1.0, [(v, True)]) for v in range(V)]
    factors += [(fs.FUNC_EQUAL, 1, 1.0, [(0, True), (v, True)])
                for v in range(1, V)]
    return graph_cls.build(var_card=[2] * V, weights=[0.3, 0.4],
                           factors=factors)


KBC = dict(max_arity=3, n_weights=11, seed=3, skew=1.2, evidence_frac=0.3)
KBC3K = dict(max_arity=3, n_weights=50, seed=0, skew=1.1, window=500)
KBC_PAIR = dict(max_arity=2, n_weights=30, seed=2, skew=1.2, window=300)

# name -> (graph maker given the JAX package's generators or the port's,
# compile kwargs); none of these tiers bands
GRAPHS = {
    "kbc3000_hub": (lambda kbc, grid, tri, cls: kbc(3000, 9000, **KBC3K),
                    dict(hub_cap=16, hub_chunk=8)),
    "kbc300_hub": (lambda kbc, grid, tri, cls: kbc(300, 900, **KBC),
                   dict(hub_cap=8, hub_chunk=4)),
    "kbc_pairwise_hub": (lambda kbc, grid, tri, cls: kbc(2000, 5000,
                                                         **KBC_PAIR),
                         dict(hub_cap=12, hub_chunk=4)),
    "ising16": (lambda kbc, grid, tri, cls: grid(16, 16, w_pair=0.35,
                                                 w_bias=0.2)[0], {}),
    "triple16": (lambda kbc, grid, tri, cls: tri(16, 16)[0], {}),
    "star_bool": (lambda kbc, grid, tri, cls: _star(cls),
                  dict(hub_cap=6, hub_chunk=4)),
}


def _jax_graph(name, shards=1):
    make, kw = GRAPHS[name]
    g = make(jax_kbc_graph, jax_ising_grid, jax_triple_grid, JaxFactorGraph)
    colors = greedy_coloring(g)
    if shards > 1:
        kw = dict(kw, align=8 * shards, shards=shards)
    jdg, jinfo = jax_compile(g, colors=colors, **kw)
    assert jinfo.band_w == 0 and any(ti.deltam for ti in jinfo.tiers)
    tdg, tinfo = from_jax(jdg, jinfo)
    return jdg, jinfo, to_device(tdg, "cpu"), tinfo


def _world(P, n, seed):
    return np.random.default_rng(seed).integers(0, 2, (P, n)).astype(np.int8)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_delta_matches_jax_multilin(name):
    """Every deltam tier, every color: the delta mode's and the draw's
    deltas equal each other exactly and JAX color_delta_multilin's within
    1e-5 (hub tiers: the chunks' deltas)."""
    jdg, jinfo, d, info = _jax_graph(name)
    jdgd = jax_to_device(jdg)
    jw = jnp.asarray(jdg.w_init)
    jfold = jmc.prepare_fold(jdgd, jw, jinfo, ("off", "off"))
    fold = tmc.prepare_fold(d, d.w_init, info)
    vals = _world(jdg.var_card.shape[0], NC, 4)
    tv = torch.from_numpy(vals)
    arities = set()
    for t, ti in enumerate(info.tiers):
        if not ti.deltam:
            continue
        assert tmc.route(ti, info) == ("gather", False, "records")
        arities.add((ti.arity, ti.hub))
        for c in range(info.n_colors):
            ref = np.asarray(jmc.color_delta_multilin(
                jdgd.tiers[t], jinfo.tiers[t], jnp.asarray(vals), c, jinfo,
                jfold[t], ("off", "off")))
            streams = tmc._dm_streams(d.tiers[t], ti, c, info, fold[t])
            delta = dm_gather_draw_plain(tv, *streams, None)
            assert delta.shape == ref.shape and delta.dtype == torch.float32
            np.testing.assert_allclose(delta.numpy(), ref, rtol=0, atol=1e-5)
            seed = torch.tensor([c, -c - 1], dtype=torch.int32)
            _, delta2 = dm_gather_draw_plain(tv, *streams, seed,
                                             return_delta=True)
            assert torch.equal(delta, delta2)
    assert arities
    if name.endswith("_hub"):
        assert any(hub for _, hub in arities)


@pytest.mark.parametrize("name", ["kbc3000_hub", "kbc_pairwise_hub",
                                  "star_bool"])
def test_hub_chunk_deltas_match_jax(name):
    """hub_partial given the fold (dm_gather_draw's delta mode, then
    index_add_) equals JAX's chunk deltas summed onto their rows, and the
    port's eager route without a fold (color_delta_bool, the single-chain
    engine's), within 1e-5."""
    jdg, jinfo, d, info = _jax_graph(name)
    jdgd = jax_to_device(jdg)
    jfold = jmc.prepare_fold(jdgd, jnp.asarray(jdg.w_init), jinfo,
                             ("off", "off"))
    t = len(info.tiers) - 1
    ti, ts = info.tiers[t], d.tiers[t]
    assert ti.hub and ti.deltam
    fold = tmc.prepare_fold(d, d.w_init, info)
    vals = _world(jdg.var_card.shape[0], NC, 5)
    tv = torch.from_numpy(vals)
    for c in range(info.n_colors):
        dchunk = np.asarray(jmc.color_delta_multilin(
            jdgd.tiers[t], jinfo.tiers[t], jnp.asarray(vals), c, jinfo,
            jfold[t], ("off", "off")))
        ref = np.zeros((ti.block + 1, NC), np.float32)
        np.add.at(ref, np.asarray(jdg.tiers[t].hb_row[c]), dchunk)
        got = tmc.hub_partial(d, ts, ti, tv, d.w_init, c, info, fold[t])
        eager = tmc.hub_partial(d, ts, ti, tv, d.w_init, c, info)
        np.testing.assert_allclose(got.numpy(), ref[:ti.block], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=0,
                                   atol=1e-5)


HUB_GRAPHS = ["kbc3000_hub", "kbc300_hub", "kbc_pairwise_hub"]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("name", HUB_GRAPHS)
def test_hub_row_sums_match_jax_segment_sum(name, shards):
    """The plain hub draw's log-odds (each row's chunks as one deep row in
    the kernel's order, through hub_rows) equal JAX hub_color_draw's
    segment_sum of the chunk deltas within 1e-5; on a graph compiled for
    two graph shards, so do the ranks' partial sums (hub_partial on each
    rank's run of chunks, the sharded route) added up."""
    jdg, jinfo, d, info = _jax_graph(name, shards)
    jdgd = jax_to_device(jdg)
    jfold = jmc.prepare_fold(jdgd, jnp.asarray(jdg.w_init), jinfo,
                             ("off", "off"))
    t = len(info.tiers) - 1
    ti, ts = info.tiers[t], d.tiers[t]
    assert ti.hub and ti.deltam
    fold = tmc.prepare_fold(d, d.w_init, info)
    vals = _world(jdg.var_card.shape[0], NC, 6)
    tv = torch.from_numpy(vals)
    ranks = []
    for g in range(shards if shards > 1 else 0):
        local = tgs.shard_device_graph(d, info, shards, g, "cpu")
        ranks.append((local, tmc.prepare_fold(local, local.w_init, info,
                                              sharded=True)))
    deep = 0
    for c in range(info.n_colors):
        dchunk = jmc.color_delta_multilin(
            jdgd.tiers[t], jinfo.tiers[t], jnp.asarray(vals), c, jinfo,
            jfold[t], ("off", "off"))
        ref = np.asarray(jax.ops.segment_sum(
            dchunk, jnp.asarray(jdg.tiers[t].hb_row[c]),
            num_segments=ti.block + 1))[:ti.block]
        rows = tmc.hub_rows(ts, ti, c)
        deep += int((rows[1:] - rows[:-1]).max()) * ti.chunk_g > DM_SEGMENT
        got = dm_gather_draw_plain(tv, *tmc._dm_streams(ts, ti, c, info,
                                                        fold[t]), None,
                                   rows=rows)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
        if ranks:
            parts = sum(tmc.hub_partial(local, local.tiers[t], ti, tv,
                                        local.w_init, c, info, lfold[t])
                        for local, lfold in ranks)
            np.testing.assert_allclose(parts.numpy(), ref, rtol=0,
                                       atol=1e-5)
    assert deep                     # some row spans several segments


@pytest.mark.parametrize("name", HUB_GRAPHS + ["star_bool"])
def test_hub_rows_are_the_chunk_offsets(name):
    """hub_rows: a color's hub rows own consecutive chunks in row order,
    the pad chunks (hb_row = block) last."""
    jdg, _, d, info = _jax_graph(name)
    t = len(info.tiers) - 1
    ti = info.tiers[t]
    hb = jdg.tiers[t].hb_row
    for c in range(info.n_colors):
        rows = tmc.hub_rows(d.tiers[t], ti, c).numpy()
        real = hb[c][hb[c] < ti.block]
        assert rows[0] == 0 and rows[-1] == real.size
        np.testing.assert_array_equal(
            np.diff(rows), np.bincount(real, minlength=ti.block))
        assert (np.diff(real) >= 0).all()
        assert (hb[c][real.size:] == ti.block).all()


def _streams(B, D, A1, P, n, seed):
    """Random streams of one tier color: neighbour positions in [-2, P + 2)
    (a few outside the world, which read 0, and some at its last row), a
    0/1 world and coefficients; as torch tensors."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-2, P + 2, (B, D, A1)).astype(np.int32)
    nbr[rng.random(nbr.shape) < 0.05] = P - 1
    f = np.float32
    s = dict(values=rng.integers(0, 2, (P, n)).astype(np.int8), nbr=nbr,
             base=rng.normal(0, 0.5, B).astype(f),
             b1=rng.normal(0, 0.7, (B, D)).astype(f),
             b2=rng.normal(0, 0.7, (B, D)).astype(f) if A1 == 2 else None,
             bx=rng.normal(0, 0.7, (B, D)).astype(f) if A1 == 2 else None)
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in s.items()}


def _numpy_delta(s):
    """delta in float32, one operation at a time, summed in the kernel's
    order: segments of DM_SEGMENT records in the order of d, then the
    segments in order, then base."""
    v = s["values"].numpy()
    nbr = s["nbr"].numpy()
    P = v.shape[0]
    B, D, A1 = nbr.shape

    def read(a, d):
        j = nbr[:, d, a]
        ok = (j >= 0) & (j < P)
        return np.where(ok[:, None], v[np.where(ok, j, 0)], 0) \
            .astype(np.float32)

    total = None
    for d0 in range(0, D, DM_SEGMENT):
        acc = None
        for d in range(d0, min(D, d0 + DM_SEGMENT)):
            n1 = read(0, d)
            x = s["b1"].numpy()[:, d, None] * n1
            if A1 == 2:
                n2 = read(1, d)
                x = (x + s["b2"].numpy()[:, d, None] * n2) \
                    + s["bx"].numpy()[:, d, None] * (n1 * n2)
            acc = x if acc is None else acc + x
        total = acc if total is None else total + acc
    return total + s["base"].numpy()[:, None]


def _hash_draws(delta, seed, NCh):
    B = delta.shape[0]
    rows = torch.arange(B, dtype=torch.int64)[:, None]
    cnt = (rows % DM_TILE_ROWS) * NCh + torch.arange(NCh, dtype=torch.int64)
    u = uniform24(hash_bits(cnt, u32(seed[0]),
                            tile_seed(seed[1], rows // DM_TILE_ROWS)))
    return (u < torch.sigmoid(delta)).to(torch.int8)


@pytest.mark.parametrize("B,D,A1,n", [(300, 5, 2, 24), (300, 1, 1, 37),
                                      (150, 9, 2, 16), (40, 256, 2, 16),
                                      (260, 3, 1, 16), (20, 600, 2, 8),
                                      (30, 37, 1, 8)])
@pytest.mark.parametrize("chunk", [None, 1000])
def test_plain_draws_equal_the_hash_bit_for_bit(monkeypatch, B, D, A1, n,
                                                chunk):
    """Over several tiles of DM_TILE_ROWS rows and any chunk of rows: the
    delta equals a float32 evaluation in the order of d exactly, and the
    draws equal u < sigmoid(delta) with u from the counter hash."""
    if chunk is not None:
        monkeypatch.setattr(tfused, "PLAIN_CHUNK_ELEMS", chunk)
    s = _streams(B, D, A1, 200, n, 100 * D + B + A1)
    seed = torch.tensor([123456789, -987654321], dtype=torch.int32)
    args = (s["values"], s["nbr"], s["base"], s["b1"], s["b2"], s["bx"])
    out, delta = dm_gather_draw_plain(*args, seed, return_delta=True)
    np.testing.assert_array_equal(delta.numpy(), _numpy_delta(s))
    assert torch.equal(out, _hash_draws(delta, seed, n))
    assert torch.equal(dm_gather_draw(*args, seed), out)
    assert torch.equal(dm_gather_draw_plain(*args, None), delta)
    other = dm_gather_draw_plain(*args, torch.tensor([1, 2],
                                                     dtype=torch.int32))
    assert not torch.equal(other, out)
    assert 0.2 < float(out.double().mean()) < 0.8


def _jax_multilin_streams(s):
    """JAX color_delta_multilin on the random streams ``s`` as one color of
    a deltam tier without a banded plan."""
    B, D, A1 = s["nbr"].shape
    ts = SimpleNamespace(cs_nbr=jnp.asarray(s["nbr"].numpy().reshape(-1)),
                         cs_type=np.zeros(B * D, np.int8))
    ti = SimpleNamespace(hub=False, degree=D, arity=A1 + 1, band_w=0,
                         band_k=0, band_tb=0, affine2=False, affinek=False,
                         fusedm=False, deltam=True)
    fold = tuple(None if x is None else jnp.asarray(x.numpy().reshape(-1))
                 for x in (s["base"], s["b1"], s["b2"], s["bx"]))
    return np.asarray(jmc.color_delta_multilin(
        ts, ti, jnp.asarray(s["values"].numpy()), 0,
        SimpleNamespace(n_colors=1), fold, ("off", "off")))


@pytest.mark.parametrize("D,A1", [(600, 2), (600, 1), (40, 2)])
def test_segmented_plain_delta_matches_jax_multilin(D, A1):
    """Rows of D records (several segments, the last one ragged): the
    plain delta equals JAX color_delta_multilin's within 1e-5.  The
    coefficients are multiples of 1/64 below 2 in magnitude, so every
    partial sum is exact in float32 and the two orders of summation give
    the same numbers: a record missed or counted twice would show."""
    P = 300
    s = _streams(12, D, A1, P, NC, 600 + D + A1)
    s["nbr"] = s["nbr"].clamp(0, P - 1)
    for k in ("base", "b1", "b2", "bx"):
        if s[k] is not None:
            s[k] = torch.round(s[k].clamp(-1.9, 1.9) * 64) / 64
    delta = dm_gather_draw_plain(s["values"], s["nbr"], s["base"], s["b1"],
                                 s["b2"], s["bx"], None)
    np.testing.assert_allclose(delta.numpy(), _jax_multilin_streams(s),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(delta.numpy(), _numpy_delta(s))
    assert float(delta.abs().max()) > 1.0


@pytest.mark.parametrize("short", [0, 37])
def test_world_write_changes_only_masked_rows(short):
    """Draws straight into the world's block rows the mask selects: the
    world equals the output mode's draws written under the mask, and
    every other row, the block's unselected rows and those past a short
    mask included, stays as it was."""
    B, D, P, row0 = 200, 4, 1000, 600
    s = _streams(B, D, 2, P, NC, 9)
    s["nbr"] = s["nbr"].remainder(row0)     # no neighbour in the block
    world = s["values"]
    mask = torch.from_numpy(np.random.default_rng(3).random(B - short)
                            < 0.6)
    seed = torch.tensor([5, 6], dtype=torch.int32)
    args = (s["nbr"], s["base"], s["b1"], s["b2"], s["bx"], seed)
    drawn = dm_gather_draw_plain(world, *args)
    want = world.clone()
    blk = want[row0:row0 + B - short]
    blk.copy_(torch.where(mask[:, None], drawn[:B - short], blk))
    got = world.clone()
    assert dm_gather_draw(got, *args, write=(row0, mask)) is got
    assert torch.equal(got, want)
    changed = (got != world).any(dim=1).nonzero().flatten()
    assert len(changed) > 0
    assert bool(((changed >= row0) & (changed < row0 + B - short)).all())
    assert bool(mask[changed - row0].all())


def _kbc_port(cap=8, chunk=4):
    g = random_kbc_graph(300, 900, **KBC)
    dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=cap,
                             hub_chunk=chunk)
    return g, dg, info


def test_a_shard_never_draws_through_the_plan():
    """A graph shard draws a tier at a time even when its fold carries
    dm_gather_draw's plan (the plan's launches address the whole graph's
    rows): sweeps with an unsharded fold and with a sharded one, on a
    shard that is the whole graph, give the same worlds bit for bit."""
    _, dg, info = _kbc_port()
    d = to_device(dg, "cpu")
    with_plan = tmc.prepare_fold(d, d.w_init, info)
    assert with_plan.dm is not None
    worlds = []
    for fold in (with_plan, tmc.prepare_fold(d, d.w_init, info,
                                             sharded=True)):
        gen = torch.Generator().manual_seed(3)
        v = tmc.init_values_mc(d, gen, 8, info)
        for _ in range(3):
            tmc.sweep_mc(d, v, d.w_init, gen, False, info, fold,
                         WholeShard())
        worlds.append(v)
    assert torch.equal(worlds[0], worlds[1])


def test_one_launch_a_color_draws_as_tier_by_tier():
    """dm_gather_draw_tiers over every planned tier of a color (the dense
    deltam tiers and the hub, world-write mode, both masks) draws what
    the tiers drawn one by one with the same seeds draw, and its output
    mode what each tier's output mode draws."""
    _, dg, info = _kbc_port()
    d = to_device(dg, "cpu")
    fold = tmc.prepare_fold(d, d.w_init, info)
    plan = fold.dm
    assert plan.tiers == [t for t, ti in enumerate(info.tiers) if ti.deltam]
    assert info.tiers[plan.tiers[-1]].hub
    assert plan.tables is None and len(plan.tiers) <= DM_MAX_TIERS
    v0 = tmc.init_values_mc(d, torch.Generator().manual_seed(3), 16, info)
    for c in range(info.n_colors):
        for ev in (False, True):
            tiers = plan.lists[c, ev]
            assert tiers[-1].rows is not None
            seeds = torch.randint(-(1 << 31), 1 << 31, (len(tiers), 2),
                                  generator=torch.Generator().manual_seed(c),
                                  dtype=torch.int32)
            a, b = v0.clone(), v0.clone()
            assert all(x is a for x in dm_gather_draw_tiers(a, tiers, seeds))
            for t, tier in enumerate(tiers):
                dm_gather_draw_plain(b, tier.nbr, tier.base, tier.b1,
                                     tier.b2, tier.bx, seeds[t],
                                     write=tier.write, rows=tier.rows)
            assert torch.equal(a, b) and not torch.equal(a, v0)
            outs = dm_gather_draw_tiers_plain(
                v0, [x._replace(write=None) for x in tiers], seeds)
            for t, tier in enumerate(tiers):
                one = dm_gather_draw_plain(v0, tier.nbr, tier.base, tier.b1,
                                           tier.b2, tier.bx, seeds[t],
                                           rows=tier.rows)
                assert torch.equal(outs[t], one)
                row0, mask = tier.write
                blk = a[row0:row0 + mask.shape[0]]
                assert torch.equal(blk[mask], one[:mask.shape[0]][mask])


def test_hub_graph_runs_repeat_bytes():
    """Two infer_mc runs on a hub graph from one seed: equal worlds and
    marginals, byte for byte (no unordered sum left on the route)."""
    _, dg, info = _kbc_port()
    d = to_device(dg, "cpu")
    runs = [tmc.infer_mc(d, d.w_init, torch.Generator().manual_seed(7), 5,
                         30, info, 16, device="cpu") for _ in range(2)]
    assert runs[0][0].tobytes() == runs[1][0].tobytes()
    assert torch.equal(runs[0][1], runs[1][1])


def test_default_modes_route_every_deltam_tier_to_the_kernel(monkeypatch):
    """On a KBC graph ``route`` sends every deltam tier, the hub tier
    included, to dm_gather_draw; a sweep then calls its plain version (on
    the CPU) once a color for all of them, and the eager color_delta_bool
    only for the other tiers, never hub_color_draw (its index_add_); the
    single-chain engine, which folds nothing, the reverse: the eager
    arithmetic once a tier and color, the hub's in hub_color_draw."""
    _, dg, info = _kbc_port()
    assert info.has_hub and info.band_w == 0
    assert all(tmc.route(ti, info).draw == ("gather" if ti.deltam
                                            else "eager")
               for ti in info.tiers)
    # a graph shard draws the hub in hub_color_draw; without a fold every
    # tier but the hub draws eagerly
    assert all(tmc.route(ti, info, sharded=True).draw
               == ("hub" if ti.hub else "gather" if ti.deltam else "eager")
               for ti in info.tiers)
    assert all(tmc.route(ti, info, folded=False).draw
               == ("hub" if ti.hub else "eager") for ti in info.tiers)
    d = to_device(dg, "cpu")
    calls = {"plain": 0, "eager": 0, "hub": 0}
    plain, eager = tmc.dm_gather_draw_tiers_plain, tmc.color_delta_bool
    hub = tmc.hub_color_draw

    def count(key, fn):
        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(tmc, "dm_gather_draw_tiers_plain",
                        count("plain", plain))
    monkeypatch.setattr(tmc, "color_delta_bool", count("eager", eager))
    monkeypatch.setattr(tmc, "hub_color_draw", count("hub", hub))
    n_dm = sum(ti.deltam for ti in info.tiers)
    n_hub = sum(ti.hub for ti in info.tiers)
    assert n_hub == 1
    v = tmc.init_values_mc(d, torch.Generator().manual_seed(0), 8, info)
    tmc.run_sweeps_mc(d, v, d.w_init, torch.Generator().manual_seed(1), 2,
                      False, info, device="cpu")
    n_eager = len(info.tiers) - n_dm
    assert calls == {"plain": 2 * info.n_colors,
                     "eager": 2 * info.n_colors * n_eager, "hub": 0}
    calls.update(plain=0, eager=0, hub=0)
    run_sweeps(d, v[:, 0], d.w_init, torch.Generator().manual_seed(1), 2,
               False, info, device="cpu")
    assert calls == {"plain": 0, "eager": 2 * info.n_colors * len(info.tiers),
                     "hub": 2 * info.n_colors * n_hub}


def _labelled(g, n_query, seed):
    """All but ``n_query`` random variables clamped to random labels, so
    the oracle stays enumerable."""
    rng = np.random.default_rng(seed)
    query = rng.choice(g.n_vars, n_query, replace=False)
    g.var_role[:] = fs.ROLE_EVIDENCE
    g.var_role[query] = fs.ROLE_QUERY
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    return g


# name -> (graph maker, compile kwargs, bound); small enough to enumerate
ORACLE = {
    "star_bool": (lambda: _star(FactorGraph), dict(hub_cap=6, hub_chunk=4),
                  0.012),
    "kbc300_hub": (lambda: _labelled(random_kbc_graph(300, 900, **KBC), 12,
                                     1), dict(hub_cap=8, hub_chunk=4), TOL),
    "kbc_pairwise_hub": (lambda: _labelled(random_kbc_graph(
        400, 1000, **KBC_PAIR), 12, 2), dict(hub_cap=12, hub_chunk=4), TOL),
}


@pytest.mark.parametrize("name", sorted(ORACLE))
@pytest.mark.parametrize("fused", ["plan", "tiers"])
def test_infer_mc_kbc_matches_oracle(name, fused):
    make, kw, bound = ORACLE[name]
    g = make()
    dg, info = compile_graph(g, colors=greedy_coloring(g), **kw)
    assert info.has_hub and info.band_w == 0
    d = to_device(dg, "cpu")
    if fused == "plan":
        marg, values = tmc.infer_mc(d, d.w_init,
                                    torch.Generator().manual_seed(5), 200,
                                    2000, info, 32, device="cpu")
    else:
        marg, values = infer_on_route(d, info,
                                      torch.Generator().manual_seed(5), 200,
                                      2000, 32, "tiers")
    assert bool(((values == 0) | (values == 1)).all())
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    free = g.var_role == fs.ROLE_QUERY
    err = np.abs(marg[:, :2] - exact)[free].max()
    assert err < bound, f"max |dp| = {err:.4f} (bound {bound})"


def test_kbc_learning_is_deterministic_on_the_new_route(monkeypatch):
    g = random_kbc_graph(300, 900, **KBC)
    rng = np.random.default_rng(2)
    lab = rng.random(g.n_vars) < 0.5
    g.var_role[:] = np.where(lab, fs.ROLE_EVIDENCE, fs.ROLE_QUERY)
    g.var_init[:] = rng.integers(0, 2, g.n_vars)
    dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=8,
                             hub_chunk=4)
    assert info.has_hub
    d = to_device(dg, "cpu")
    plain = tmc.dm_gather_draw_tiers_plain
    calls = []
    monkeypatch.setattr(tmc, "dm_gather_draw_tiers_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    cfg = LearnConfig(n_epochs=4, n_sweeps_per_epoch=2, stepsize=0.05,
                      diminish=0.97, regularization="l2", reg_param=0.01)
    runs = [tmc.learn_mc(d, d.w_init, torch.Generator().manual_seed(0), cfg,
                         info, 8, device="cpu") for _ in range(2)]
    assert calls
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    w = runs[0][0]
    assert bool(torch.isfinite(w).all()) and not torch.equal(w, d.w_init)


def test_cuda_mode_on_the_cpu_raises():
    _, dg, info = _kbc_port()
    d = to_device(dg, "cpu")
    with pytest.raises(ValueError, match="to_device"):
        tmc.infer_mc(d, d.w_init, torch.Generator(), 1, 1, info, 4,
                     device="meta")
    s = _streams(10, 3, 2, 50, 16, 1)
    meta = s["values"].to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        dm_gather_draw(meta, s["nbr"], s["base"], s["b1"], s["b2"], s["bx"],
                       None)


def test_disagreeing_shapes_raise():
    s = _streams(10, 3, 2, 50, 16, 1)
    seed = torch.tensor([1, 2], dtype=torch.int32)
    bad = [dict(b2=None), dict(base=s["base"][:5]), dict(b1=s["b1"][:, :2])]
    for change in bad:
        a = dict(s, **change)
        with pytest.raises(ValueError, match="dm_gather_draw"):
            dm_gather_draw_plain(a["values"], a["nbr"], a["base"], a["b1"],
                                 a["b2"], a["bx"], seed)
    with pytest.raises(ValueError, match="dm_gather_draw"):
        dm_gather_draw_plain(s["values"], s["nbr"], s["base"], s["b1"],
                             s["b2"], s["bx"], None,
                             write=(0, torch.ones(10, dtype=torch.bool)))


BAD_HUB_ROWS = {"decreasing": [0, 3, 2, 5], "negative": [-1, 2, 4, 5],
                "past_the_chunks": [0, 2, 4, 9], "empty": []}


@pytest.mark.parametrize("bad", sorted(BAD_HUB_ROWS))
def test_bad_hub_offsets_raise(bad):
    """Hub chunk offsets that decrease or leave [0, M] raise, in the plain
    version and where the kernel's launch table is built (the kernel reads
    a row's chunks unchecked)."""
    s = _streams(8, 4, 2, 50, 16, 3)
    rows = torch.tensor(BAD_HUB_ROWS[bad], dtype=torch.int32)
    seed = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="dm_gather_draw"):
        dm_gather_draw_plain(s["values"], s["nbr"], s["base"], s["b1"],
                             s["b2"], s["bx"], seed, rows=rows)
    with pytest.raises(ValueError, match="dm_gather_draw"):
        dm_tier_table([DmTier(s["nbr"], s["base"], s["b1"], s["b2"],
                              s["bx"], rows=rows)])


def test_fold_frees_without_the_cycle_collector():
    """prepare_fold's Folded and its dm_gather_draw plan form no reference
    cycle: a fold's coefficient streams are freed when the fold is
    dropped, with the cycle collector off (on the card they are tens of
    MB a fold)."""
    _, dg, info = _kbc_port()
    d = to_device(dg, "cpu")
    for tables in (False, True):
        fold = tmc.prepare_fold(d, d.w_init, info)
        assert fold.dm is not None and fold.dm.lists is not None
        ref = weakref.ref(fold[fold.dm.tiers[0]][1])
        if tables:                    # as on the card
            fold.dm.use_tables(d, info, fold)
        gc.disable()
        try:
            del fold
            assert ref() is None
        finally:
            gc.enable()


def test_launch_tables_follow_the_graphs_streams():
    """The plan's launch tables point into the streams of the graph it was
    folded on: a graph whose tiers' streams were replaced (the same
    var_card) gets tables of its own streams, and a second fold of one
    graph the same table but its own coefficients."""
    _, dg, info = _kbc_port()
    d = to_device(dg, "cpu")
    d2 = d._replace(tiers=tuple(
        ts._replace(cs_nbr=ts.cs_nbr.clone(),
                    cm_resample=ts.cm_resample.clone())
        for ts in d.tiers))
    folds = [tmc.prepare_fold(x, x.w_init, info) for x in (d, d2, d)]
    for fold, x in zip(folds, (d, d2, d)):
        fold.dm.use_tables(x, info, fold)       # as on the card
    tables = [fold.dm.tables for fold in folds]
    for fold, tab, x in zip(folds, tables, (d, d2, d)):
        for i, t in enumerate(fold.dm.tiers):
            assert tab[0, 0, i, 0] == x.tiers[t].cs_nbr.data_ptr()
            assert tab[0, 0, i, 8] == x.tiers[t].cm_resample.data_ptr()
            assert tab[0, 0, i, 1] == fold[t][1].data_ptr()
    same = [0, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15]
    assert np.array_equal(tables[0][..., same], tables[2][..., same])


# (records a row, chains, chains a load, lanes a row of the packed layout;
# 0: another layout)
PACKED_RULE = (
    [(d, 16, 16, 2) for d in (17, 24, 29, 32)]      # 2 segments x 1 group
    + [(d, 16, 16, 4) for d in (33, 35, 48, 53, 64)]  # 3-4 segments
    + [(65, 16, 16, 8), (512, 16, 16, 32), (24, 32, 16, 4), (24, 48, 16, 8),
       (40, 8, 1, 32),                                # byte rows: 3 x 8
       (16, 16, 16, 0), (5, 1024, 16, 0),             # one segment
       (513, 16, 16, 0), (24, 512, 16, 0),            # past a warp
       (256, 1024, 16, 0),                            # phase 15's 88 x 256
       (600, 48, 16, 0), (600, 37, 1, 0), (40, 37, 1, 0)])


@pytest.mark.parametrize("D,n,vec,lanes", PACKED_RULE)
def test_packed_layout_rule(D, n, vec, lanes):
    """The packed deep-row layout takes a dense tier's rows of 2 or more
    segments where segments x chain groups fit a warp: the spouse graph's
    rows of 24-53 records at 16 chains, 2 to 4 lanes a row; not 256 records
    at 1024 chains, 600 at 48 or rows of one segment."""
    assert dm_packed_lanes(D, n, vec) == lanes


@pytest.mark.parametrize("n,packed", [(16, 300 + 40), (8, 300 + 40),
                                      (1024, 0)])
def test_packed_rows_count_dense_deep_tiers_only(n, packed):
    """A launch table's packed rows (dm_packed_rows, what a launch adds to
    dm_gather_draw.packed_rows): the dense deep tiers' rows where the rule
    holds; no shallow tier's and no hub tier's, whatever its chunks."""
    vec = 16 if n % 16 == 0 else 1
    tiers = []
    for B, D, A1 in ((300, 24, 1), (40, 48, 2), (300, 9, 2)):
        s = _streams(B, D, A1, 50, n, D)
        tiers.append(DmTier(s["nbr"], s["base"], s["b1"], s["b2"], s["bx"]))
    for G in (17, 24, 512):
        s = _streams(6, G, 2, 50, n, G)
        tiers.append(DmTier(s["nbr"], s["base"], s["b1"], s["b2"], s["bx"],
                            rows=torch.tensor([0, 2, 6], dtype=torch.int32)))
    assert dm_packed_rows(dm_tier_table(tiers), n, vec) == packed


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,D,A1,n,misaligned", [
    (300, 5, 2, 1024, False), (300, 9, 2, 48, False), (88, 256, 2, 64, False),
    (300, 4, 1, 37, False), (300, 16, 1, 512, False), (200, 3, 2, 48, True),
    (40, 600, 2, 1024, False), (30, 600, 1, 37, False)]
    + [(300, d, a1, 16, False) for d in (17, 24, 33, 48, 64) for a1 in (1, 2)]
    + [(300, 40, 1, 8, False), (300, 40, 2, 8, False)])
def test_kernel_matches_plain_on_card(cuda_device, B, D, A1, n, misaligned):
    """The kernel against its plain version: the delta exact, the draws
    equal but where u lies within 1e-5 of sigmoid(delta), the delta mode
    and the world-write mode as the plain version's; at 16 chains (D 17 to
    64) and in byte rows at 8 chains (D 40) the packed deep-row layout."""
    s = {k: None if v is None else v.to(cuda_device)
         for k, v in _streams(B, D, A1, 500, n, 7 * D + n).items()}
    if misaligned:
        flat = torch.empty(s["values"].numel() + 1, dtype=torch.int8,
                           device=cuda_device)
        moved = flat[1:].view(s["values"].shape)
        moved.copy_(s["values"])
        s["values"] = moved
    seed = torch.tensor([D, -n], dtype=torch.int32, device=cuda_device)
    args = (s["values"], s["nbr"], s["base"], s["b1"], s["b2"], s["bx"])
    before = dm_gather_draw.launches
    out, delta = dm_gather_draw(*args, seed, return_delta=True)
    torch.cuda.synchronize()
    assert dm_gather_draw.launches == before + 1
    ref, ref_delta = dm_gather_draw_plain(*args, seed, return_delta=True)
    assert torch.equal(delta, ref_delta)
    assert torch.equal(dm_gather_draw(*args, None), ref_delta)
    diff = out != ref
    if bool(diff.any()):
        rows, chains = diff.nonzero(as_tuple=True)
        u = uniform24(hash_bits((rows % DM_TILE_ROWS) * n + chains,
                                u32(seed[0]),
                                tile_seed(seed[1], rows // DM_TILE_ROWS)))
        assert bool(((u - torch.sigmoid(ref_delta[diff])).abs()
                     < 1e-5).all())
    mask = torch.arange(B, device=cuda_device) % 3 != 0
    s["nbr"] = s["nbr"].remainder(100)      # no neighbour in the block
    args = (s["values"], s["nbr"], s["base"], s["b1"], s["b2"], s["bx"])
    out = dm_gather_draw(*args, seed)
    ref = dm_gather_draw_plain(*args, seed)
    got = s["values"].clone()
    dm_gather_draw(got, *args[1:], seed, write=(100, mask))
    want = s["values"].clone()
    dm_gather_draw_plain(want, *args[1:], seed, write=(100, mask))
    assert int((got != want).sum()) <= int((out != ref).sum())
    assert torch.equal(got[:100], s["values"][:100])


@pytest.mark.gpu
def test_hub_kernel_matches_plain_on_card(cuda_device):
    """One launch a color over a KBC graph's planned tiers, the hub's deep
    rows among them: deltas exactly the plain version's, the draws equal
    but at a few near-ties."""
    _, dg, info = _kbc_port()
    d = to_device(dg, cuda_device)
    fold = tmc.prepare_fold(d, d.w_init, info)
    v0 = tmc.init_values_mc(d, torch.Generator(cuda_device).manual_seed(3),
                            64, info)
    for c in range(info.n_colors):
        tiers = tmc._dm_tier_list(d, info, fold.dm.tiers, fold, c, False)
        seeds = torch.tensor([[c, t] for t in range(len(tiers))],
                             dtype=torch.int32, device=cuda_device)
        outs = [x._replace(write=None) for x in tiers]
        got = dm_gather_draw_tiers(v0, outs, seeds, return_delta=True)
        ref = dm_gather_draw_tiers_plain(v0, outs, seeds, return_delta=True)
        for (o, dl), (ro, rdl) in zip(got, ref):
            assert torch.equal(dl, rdl)
            assert int((o != ro).sum()) <= 1e-4 * o.numel() + 1


@pytest.mark.gpu
@pytest.mark.parametrize("bad", sorted(BAD_HUB_ROWS))
def test_bad_hub_offsets_raise_on_card(cuda_device, bad):
    """Malformed hub chunk offsets raise on the card before any launch."""
    s = {k: None if v is None else v.to(cuda_device)
         for k, v in _streams(8, 4, 2, 50, 16, 3).items()}
    rows = torch.tensor(BAD_HUB_ROWS[bad], dtype=torch.int32,
                        device=cuda_device)
    seed = torch.tensor([1, 2], dtype=torch.int32, device=cuda_device)
    before = dm_gather_draw.launches
    with pytest.raises(ValueError, match="dm_gather_draw"):
        dm_gather_draw(s["values"], s["nbr"], s["base"], s["b1"], s["b2"],
                       s["bx"], seed, rows=rows)
    assert dm_gather_draw.launches == before


@pytest.mark.gpu
def test_spouse_shaped_rows_match_plain_on_card(cuda_device):
    """One launch over tiers shaped like the spouse graph's at 16 chains
    (rows of 24 to 53 records, about 85% of them folded unary features
    that name an all-zero row): the packed layout takes every row, the
    deltas exactly the plain version's, the draws equal but at near-ties."""
    n, P, zero = 16, 4000, 3999
    gen = np.random.default_rng(24)
    values = torch.from_numpy(gen.integers(0, 2, (P, n)).astype(np.int8))
    values[zero] = 0
    tiers = []
    for i, D in enumerate((24, 29, 35, 48, 53)):
        s = _streams(400, D, 1, P, n, D)
        nbr = s["nbr"].clamp(2000, P - 1)       # no neighbour in a block
        nbr[torch.from_numpy(gen.random(nbr.shape) < 0.85)] = zero
        tiers.append(DmTier(nbr.to(cuda_device), *(
            None if x is None else x.to(cuda_device)
            for x in (s["base"], s["b1"], s["b2"], s["bx"]))))
    values = values.to(cuda_device)
    seeds = torch.tensor([[24, -i] for i in range(len(tiers))],
                         dtype=torch.int32, device=cuda_device)
    before = dm_gather_draw.packed_rows
    got = dm_gather_draw_tiers(values, tiers, seeds, return_delta=True)
    torch.cuda.synchronize()
    assert dm_gather_draw.packed_rows == before + 400 * len(tiers)
    ref = dm_gather_draw_tiers_plain(values, tiers, seeds, return_delta=True)
    for (o, dl), (ro, rdl) in zip(got, ref):
        assert torch.equal(dl, rdl)
        assert int((o != ro).sum()) <= 1e-4 * o.numel() + 1
