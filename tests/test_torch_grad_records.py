"""The port's per-record gradient (ops.grad.grad_records, the kernel of the
chunked cs-stream gradient) against the JAX package and the chunked route.

  * on a KBC graph with a hub tier, a triple grid with band_k 2, card-3
    and card-4 Potts grids, an Ising grid with more weights than
    grad_pair_tile takes, mixed_graph, a card-200 graph (int32 worlds) and
    a graph of every boolean factor type (RATIO and LINEAR among them),
    with learn_non_evidence both ways: the port's gradient with the modes
    ("plain", "plain") (grad_records_plain on every tier that
    grad_pair_tile does not take) and with ("off", "off") (the chunked
    route) equal JAX
    mc_weight_gradient_cs within 1e-4 (its XLA route, and its
    grad_pair_tile route in interpret mode where it takes that);
  * a 2-way graph shard: the two ranks' gradients on the new route add up
    to the unsharded gradient and JAX's;
  * grad_records_plain's per-record output equals the chunked route's
    (records_diff over _phi_streams, through the banded gathers where a
    tier bands) exactly, on every tier and color of those graphs;
  * the wrapper on CPU tensors runs the plain version and counts no
    launch; out-of-contract inputs raise;
  * the route engages where the fused mode says (one call a tier of each
    tier gradient_route sends there), not with the fused mode off, and
    not on a graph with sparse per-combination weights;
  * the port's engine package exports the JAX package's engine names.
The CUDA kernel is held to its plain version on the card (gpu marker).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sampler_tpu import fixtures as jfx
from sampler_tpu import format_spec as jfs
from sampler_tpu.benchgraphs import big_ising_grid as jax_ising_grid
from sampler_tpu.benchgraphs import big_potts_grid as jax_potts_grid
from sampler_tpu.benchgraphs import big_triple_grid as jax_triple_grid
from sampler_tpu.benchgraphs import random_kbc_graph as jax_kbc_graph
from sampler_tpu.compile import compile_graph as jax_compile
from sampler_tpu.compile import to_device as jax_to_device
from sampler_tpu.engine import multichain as jmc
from sampler_tpu.graph import FactorGraph as JaxFactorGraph
from sampler_tpu_torch import format_spec as fs
from sampler_tpu_torch.coloring import greedy_coloring
from sampler_tpu_torch.compile import tier_geom, to_device
from sampler_tpu_torch.convert import from_jax
from sampler_tpu_torch.engine import multichain as tmc
from sampler_tpu_torch.ops import grad as tgrad
from sampler_tpu_torch.ops.grad import (GRAD_W_MAX, grad_records,
                                        grad_records_plain)
from sampler_tpu_torch.ops.weights import segment_reduce
from sampler_tpu_torch.parallel import graph_shard as tgs

ATOL = 1e-4
NC = 6
PLAIN = ("plain", "plain")
OFF = ("off", "off")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These shapes are tiny: torch's intra-op threads only contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labelled(g, seed, frac=0.5):
    rng = np.random.default_rng(seed)
    card = np.maximum(np.asarray(g.var_card), 1)
    g.var_role[:] = rng.random(g.n_vars) < frac
    g.var_init[:] = rng.integers(0, 1 << 20, g.n_vars) % card
    return g


def _kbc():
    g = jax_kbc_graph(1000, 3000, max_arity=3, n_weights=40, seed=2,
                      skew=1.2, window=300, evidence_frac=0.3)
    return g, dict(colors=greedy_coloring(g), hub_cap=12, hub_chunk=4)


def _triple():
    g, colors = jax_triple_grid(32, 32)
    return _labelled(g, 1, 1 / 3), dict(colors=colors, band_tile=8,
                                        band_min_block=1, band_wmax=512)


def _potts(card):
    g, colors = jax_potts_grid(16, 16, card=card, seed=11)
    return _labelled(g, card), dict(colors=colors, band_tile=8,
                                    band_min_block=1)


def _ising_many_weights():
    """A banded Ising grid (one affine2 tier) whose pair factors take more
    weights than grad_pair_tile accumulates: its tier takes grad_records."""
    g, colors = jax_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    g = _labelled(g, 3)
    n_w = GRAD_W_MAX + 16
    rng = np.random.default_rng(4)
    g = JaxFactorGraph.build(
        var_card=[2] * g.n_vars, weights=rng.normal(0, 0.5, n_w),
        factors=[(int(g.f_type[f]), int(f % n_w), 1.0,
                  [(int(g.e_vid[e]), bool(g.e_ispos[e]))
                   for e in range(g.f_ptr[f], g.f_ptr[f + 1])])
                 for f in range(g.n_factors)],
        var_role=g.var_role, var_init=g.var_init)
    return g, dict(colors=colors, band_tile=8, band_min_block=1)


def _card200():
    """A chain of card-200 variables: EQUAL pairs and categorical unaries
    on a few predicates (int32 worlds)."""
    V = 12
    preds = (0, 3, 7, 150)
    factors = [(jfs.FUNC_AND_CATEGORICAL, 0, 1.0, [(v, True,
                                                   preds[v % 4])])
               for v in range(V)]
    factors += [(jfs.FUNC_EQUAL, 1 + v % 2, 1.0,
                 [(v, bool(v % 3), preds[(v + 1) % 4]),
                  (v + 1, True, preds[(v + 1) % 4])]) for v in range(V - 1)]
    g = JaxFactorGraph.build(var_card=[200] * V, weights=[1.2, 0.8, -0.5],
                             factors=factors)
    g.var_dtype[:] = jfs.DTYPE_CATEGORICAL
    g.var_role[::3] = jfs.ROLE_EVIDENCE
    g.var_init[::3] = 7
    return g, {}


FUNCS = (jfs.FUNC_IMPLY_NATURAL, jfs.FUNC_OR, jfs.FUNC_AND, jfs.FUNC_EQUAL,
         jfs.FUNC_ISTRUE, jfs.FUNC_LINEAR, jfs.FUNC_RATIO, jfs.FUNC_LOGICAL,
         jfs.FUNC_IMPLY_MLN)


def _functions():
    """Every boolean factor type at arities 1-3, negated literals
    included, half the variables labelled."""
    rng = np.random.default_rng(8)
    V, F = 60, 240
    factors = []
    for f in range(F):
        t = FUNCS[f % len(FUNCS)]
        arity = 1 if f % 7 == 0 else int(rng.integers(2, 4))
        vids = rng.choice(V, size=arity, replace=False)
        factors.append((int(t), int(f % 18), float(rng.choice([0.5, 1, 2])),
                        [(int(v), bool(rng.integers(2))) for v in vids]))
    g = JaxFactorGraph.build(var_card=[2] * V,
                             weights=rng.normal(0, 0.5, 18), factors=factors)
    return _labelled(g, 9), {}


GRAPHS = {
    "kbc_hub": _kbc,
    "triple_band2": _triple,
    "potts3": lambda: _potts(3),
    "potts4": lambda: _potts(4),
    "ising_many_weights": _ising_many_weights,
    "mixed": lambda: (_labelled(jfx.mixed_graph(), 6), {}),
    "card200": _card200,
    "functions": _functions,
}
_CACHE = {}


def _compiled(name, **extra):
    key = (name, tuple(sorted(extra.items())))
    if key not in _CACHE:
        g, kw = GRAPHS[name]()
        jdg, jinfo = jax_compile(g, **kw, **extra)
        tdg, tinfo = from_jax(jdg, jinfo)
        _CACHE[key] = (jdg, jinfo, tdg, tinfo)
    return _CACHE[key]


def _worlds(dg, info, n, seed, card200=False):
    rng = np.random.default_rng(seed)
    card = np.maximum(np.asarray(dg.var_card), 1)[:, None]
    dt = np.int8 if info.max_card <= 127 else np.int32
    # card 200: values from the predicates' own categories, so that the
    # literals vary between the worlds
    pick = np.array([0, 3, 7, 150]) if card200 else np.arange(1 << 10)

    def one():
        v = pick[rng.integers(0, pick.size, (card.shape[0], n))] % card
        return v.astype(dt)

    return one(), one()


def _engaged(tinfo, modes, W, n_graph=1):
    """The tiers that take grad_records under ``modes``."""
    return [t for t, ti in enumerate(tinfo.tiers)
            if tmc.gradient_route(ti, tinfo, modes, W,
                                  n_graph=n_graph)[0] == "records"]


def test_graphs_cover_the_classes():
    """The graphs below take the new route where the chunked route's
    classes live: KBC dense and hub tiers, a band_k 2 fusedm tier, affinek
    tiers, an affine2 tier past GRAD_W_MAX, every boolean type, and every
    tier of mixed and card 200, whose tiers have no fused draw."""
    def tiers(name):
        jdg, _, tdg, tinfo = _compiled(name)
        return tinfo, _engaged(tinfo, PLAIN, tdg.w_init.shape[0])

    info, on = tiers("kbc_hub")
    assert any(info.tiers[t].hub for t in on)
    assert any(not info.tiers[t].hub for t in on)
    info, on = tiers("triple_band2")
    assert on and all(info.tiers[t].fusedm and info.tiers[t].band_k == 2
                      for t in on)
    for name in ("potts3", "potts4"):
        info, on = tiers(name)
        assert on and all(info.tiers[t].affinek for t in on)
    info, on = tiers("ising_many_weights")
    assert on and all(info.tiers[t].affine2 for t in on)
    info, on = tiers("functions")
    assert on and set(FUNCS) <= set(info.present_funcs)
    for name in ("mixed", "card200"):
        info, on = tiers(name)
        assert on == list(range(len(info.tiers)))
        assert not any(tmc.tier_modes(ti, PLAIN)[1] != "off"
                       for ti in info.tiers)
    assert tiers("card200")[0].max_card == 200


@pytest.mark.parametrize("lne", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gradient_routes_match_jax(name, lne):
    jdg, jinfo, tdg, tinfo = _compiled(name)
    jd = jax_to_device(jdg)
    d = to_device(tdg, "cpu")
    v_ev, v_free = _worlds(tdg, tinfo, NC, 5 + len(name),
                           card200=name == "card200")
    jv_ev, jv_free = jnp.asarray(v_ev), jnp.asarray(v_free)
    refs = {"jax_xla": jmc.mc_weight_gradient_cs(jd, jv_ev, jv_free, lne,
                                                 jinfo, OFF)}
    if jinfo.affine2:
        refs["jax_kernel"] = jmc.mc_weight_gradient_cs(
            jd, jv_ev, jv_free, lne, jinfo, ("interpret", "off"))
    t_ev, t_free = torch.from_numpy(v_ev), torch.from_numpy(v_free)
    ours = {"plain": tmc.mc_weight_gradient_cs(d, t_ev, t_free, lne, tinfo,
                                               PLAIN),
            "chunked": tmc.mc_weight_gradient_cs(d, t_ev, t_free, lne, tinfo,
                                                 OFF)}
    assert float(np.abs(np.asarray(refs["jax_xla"])).max()) > 0.01
    for rname, ref in refs.items():
        for oname, got in ours.items():
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=ATOL,
                                       err_msg=f"{oname} vs {rname}")


def _per_record_chunked(monkeypatch, d, tinfo, v_ev, v_free, lne, modes):
    """The chunked route's records_diff outputs, [B, D] a (tier, color),
    in the loop's order."""
    seen = []
    orig = tmc.records_diff

    def spy(phi, feat, gsel):
        out = orig(phi, feat, gsel)
        seen.append(out)
        return out

    monkeypatch.setattr(tmc, "records_diff", spy)
    tmc.mc_weight_gradient_cs(d, v_ev, v_free, lne, tinfo, modes)
    monkeypatch.setattr(tmc, "records_diff", orig)
    C = tinfo.n_colors
    got, k = {}, 0
    for t, (ts, ti) in enumerate(zip(d.tiers, tinfo.tiers)):
        B, D, A = tier_geom(ts, ti, C)
        rc = tmc._row_chunk(ti, B, D, A, 2 * v_ev.shape[1])
        for c in range(C):
            n = B // rc
            got[t, c] = torch.cat(seen[k:k + n])
            k += n
    assert k == len(seen)
    return got


@pytest.mark.parametrize("lne", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_records_equal_chunked_exactly(monkeypatch, name, lne):
    """grad_records_plain's output equals the chunked route's per-record
    diff bit for bit, on every tier and color (the chunked route through
    the banded gathers where a tier bands)."""
    _, _, tdg, tinfo = _compiled(name)
    d = to_device(tdg, "cpu")
    v_ev, v_free = (torch.from_numpy(v) for v in _worlds(
        tdg, tinfo, NC, 3, card200=name == "card200"))
    # band "plain": the chunked route gathers as the unfused draw does
    chunked = _per_record_chunked(monkeypatch, d, tinfo, v_ev, v_free, lne,
                                  ("plain", "off"))
    gB, C = tinfo.block_size, tinfo.n_colors
    nonzero = 0
    for t, (ts, ti) in enumerate(zip(d.tiers, tinfo.tiers)):
        gsrc = ts.cs_gowner if lne else ts.cs_gtouch
        present = ti.present_funcs or tinfo.present_funcs
        args = (v_ev, v_free, *tmc._record_streams(
            ts, ti, C, gB, gsrc, 1, 0, tinfo.all_boolean), present,
            tinfo.all_boolean)
        for row_chunk in (None, 1):
            out = grad_records_plain(*args, row_chunk=row_chunk)
            assert out.dtype == torch.float32
            for c in range(C):
                assert torch.equal(out[c].view(torch.int32),
                                   chunked[t, c].view(torch.int32)), (t, c)
        nonzero += int((out != 0).sum())
    assert nonzero > 0


@pytest.mark.parametrize("name", ["kbc_hub", "triple_band2", "potts3",
                                  "functions"])
def test_sharded_gradient_sums_to_unsharded(name):
    """A 2-way graph shard on the new route: the ranks' gradients (each on
    its local streams, the worlds whole) add up to the unsharded gradient
    and to JAX's."""
    jdg, jinfo, tdg, tinfo = _compiled(name, align=16, shards=2)
    d = to_device(tdg, "cpu")
    v_ev, v_free = _worlds(tdg, tinfo, NC, 21)
    t_ev, t_free = torch.from_numpy(v_ev), torch.from_numpy(v_free)
    for lne in (False, True):
        want = np.asarray(jmc.mc_weight_gradient_cs(
            jax_to_device(jdg), jnp.asarray(v_ev), jnp.asarray(v_free), lne,
            jinfo, OFF))
        whole = tmc.mc_weight_gradient_cs(d, t_ev, t_free, lne, tinfo,
                                          PLAIN).numpy()
        total = np.zeros_like(want)
        for g in range(2):
            local = tgs.shard_device_graph(tdg, tinfo, 2, g, "cpu")
            assert _engaged(tinfo, PLAIN, local.w_init.shape[0], 2)
            total += tmc.mc_weight_gradient_cs(
                local, t_ev, t_free, lne, tinfo, PLAIN, n_graph=2,
                g=g).numpy()
        assert np.abs(want).max() > 0.01
        np.testing.assert_allclose(total, whole, rtol=0, atol=ATOL)
        np.testing.assert_allclose(total, want, rtol=0, atol=ATOL)


def _count(monkeypatch, name):
    # the per-tier plain version is called by the route's (ops.grad)
    mod = tgrad if name == "grad_records_plain" else tmc
    calls = []
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1)
                        or orig(*a, **k))
    return calls


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_route_engages_where_the_fused_mode_says(monkeypatch, name):
    """One grad_records_plain call a tier of each tier that gradient_route
    sends there while the fused mode is on ("plain"), none with it off;
    the chunked route's _phi_streams runs only for the tiers it sends
    there."""
    _, _, tdg, tinfo = _compiled(name)
    d = to_device(tdg, "cpu")
    W = d.w_init.shape[0]
    v = torch.zeros((d.var_card.shape[0], 4), dtype=tmc.values_dtype(tinfo))
    calls = _count(monkeypatch, "grad_records_plain")
    chunks = _count(monkeypatch, "_phi_streams")
    for modes in (PLAIN, ("off", "plain"), OFF, ("plain", "off")):
        calls.clear()
        chunks.clear()
        tmc.mc_weight_gradient_cs(d, v, v, False, tinfo, modes)
        on = _engaged(tinfo, modes, W)
        assert len(calls) == len(on), modes
        rest = [t for t, ti in enumerate(tinfo.tiers)
                if tmc.gradient_route(ti, tinfo, modes, W)[0] == "chunked"]
        assert bool(chunks) == bool(rest), modes
        if modes[1] == "off":
            assert not calls
        else:
            assert not rest and not chunks, modes


def test_route_stays_off_under_sparse_weights(monkeypatch):
    """On a graph with sparse per-combination weights the chunked route
    stays only with the fused mode off; with it on every tier takes
    grad_records on its dense owner records (no row chunk), the sparse
    ones the table lookup beside it.  Both equal JAX's gradient."""
    g = jfx.sparse_categorical_graph(seed=3, n=6)
    g.var_role[::2] = jfs.ROLE_EVIDENCE
    jdg, jinfo = jax_compile(g)
    tdg, tinfo = from_jax(jdg, jinfo)
    assert tinfo.has_sparse_cw
    d = to_device(tdg, "cpu")
    calls = _count(monkeypatch, "grad_records_plain")
    chunks = _count(monkeypatch, "_phi_streams")
    v_ev, v_free = _worlds(tdg, tinfo, NC, 13)
    for modes in (OFF, ("off", "plain")):
        calls.clear()
        chunks.clear()
        for lne in (False, True):
            got = tmc.mc_weight_gradient_cs(d, torch.from_numpy(v_ev),
                                            torch.from_numpy(v_free), lne,
                                            tinfo, modes)
            ref = jmc.mc_weight_gradient_cs(jax_to_device(jdg),
                                            jnp.asarray(v_ev),
                                            jnp.asarray(v_free), lne, jinfo,
                                            OFF)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=ATOL)
        if modes == OFF:
            assert not calls and chunks
        else:
            assert len(calls) == 2 * len(tinfo.tiers) and not chunks


def _tier_args(name, t=0):
    _, _, tdg, tinfo = _compiled(name)
    d = to_device(tdg, "cpu")
    ts, ti = d.tiers[t], tinfo.tiers[t]
    v_ev, v_free = (torch.from_numpy(v) for v in _worlds(tdg, tinfo, NC, 2))
    args = [v_ev, v_free, *tmc._record_streams(
        ts, ti, tinfo.n_colors, tinfo.block_size, ts.cs_gtouch, 1, 0,
        tinfo.all_boolean), ti.present_funcs or tinfo.present_funcs,
        tinfo.all_boolean]
    return args


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    for name in ("kbc_hub", "potts4", "functions"):
        args = _tier_args(name)
        before = grad_records.launches
        got = grad_records(*args)
        assert grad_records.launches == before
        assert torch.equal(got, grad_records_plain(*args))
        buf = torch.full(got.shape, float("nan"))
        assert grad_records(*args, out=buf) is buf      # written in place
        assert torch.equal(buf, got)


@pytest.mark.parametrize("hub", [False, True])
def test_plain_colors_equal_one_color_at_a_time(hub):
    """The tier-wide call (a color's own rows color_stride apart, or
    through own_idx [C, B]) equals one call a color, each with its own
    rows' base."""
    args = list(random_record_streams("cpu", 40, 3, 3, 5, 1, C=3,
                                      types=FUNCS, hub=hub, P=400))
    whole = grad_records_plain(*args)
    assert whole.shape == (3, 40, 3) and bool((whole != 0).any())
    own_base, stride, own_idx = args[12], args[13], args[14]
    for c in range(3):
        one = [a[c:c + 1] if isinstance(a, torch.Tensor) and i >= 2 else a
               for i, a in enumerate(args[:12])]
        one += [own_base + c * stride, 0,
                None if own_idx is None else own_idx[c:c + 1], *args[15:]]
        assert torch.equal(grad_records_plain(*one)[0], whole[c]), c


def test_out_of_contract_inputs_raise():
    args = _tier_args("potts4")        # not all-boolean: eq is given
    bool_args = _tier_args("kbc_hub")
    names = ("v_ev", "v_free", "nbr", "pos", "ismine", "mask", "hmask", "eq",
             "typ", "arity", "feat", "gsel", "own_base", "color_stride",
             "own_idx", "present", "all_boolean")

    def bad(base, **kw):
        a = list(base)
        for k, v in kw.items():
            a[names.index(k)] = v
        with pytest.raises((ValueError, TypeError)):
            grad_records(*a)

    v_ev, v_free = args[0], args[1]
    P = v_ev.shape[0]
    bad(args, v_free=v_free[:, :2])                   # worlds differ
    bad(args, v_free=v_free.to(torch.int32))
    bad(args, v_ev=v_ev.to(torch.int16), v_free=v_free.to(torch.int16))
    C, B = args[3].shape[:2]
    assert C > 1
    bad(args, nbr=args[2][..., :0])                   # nbr slots
    bad(args, pos=args[3][:, :-1])                    # slot streams
    bad(args, pos=args[3][0])                         # no color axis
    bad(args, feat=args[10][..., :1])                 # record streams
    bad(args, eq=None)                                # eq missing
    bad(args, own_base=P)                             # own rows past P
    bad(args, own_base=-1)
    bad(args, own_base=P - B)                         # the last color's
    bad(args, color_stride=-1)
    bad(args, own_idx=torch.zeros(3, dtype=torch.int32))
    bad(args, own_idx=torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError):                   # out's shape
        grad_records(*args, out=torch.empty(3, 3))
    with pytest.raises(ValueError):
        grad_records(*args, out=torch.empty(B, args[10].shape[2]))
    bad(args, present=())
    bad(args, present=(5,))                           # no such type
    bad(bool_args, eq=bool_args[3].to(torch.int16))   # eq on all-boolean
    bad(bool_args, v_ev=bool_args[0].to(torch.int32),
        v_free=bool_args[1].to(torch.int32))
    with pytest.raises(ValueError):                   # no kernel on CPU
        tmc.check_modes(("off", "cuda"), "cpu")


def test_engine_exports_equal_jax():
    """The port's engine package re-exports the JAX package's engine names,
    each a function or class of the port."""
    import sampler_tpu.engine as jengine
    import sampler_tpu_torch.engine as tengine

    assert tengine.__all__ == jengine.__all__
    for name in tengine.__all__:
        obj = getattr(tengine, name)
        assert callable(obj), name
        assert obj.__module__.startswith("sampler_tpu_torch."), name


# --------------------------------------------- the records route's plan

def _plan(name, lne, d=None, tinfo=None, n_graph=1, g=0):
    if d is None:
        _, _, tdg, tinfo = _compiled(name)
        d = to_device(tdg, "cpu")
    tiers = _engaged(tinfo, PLAIN, d.w_init.shape[0], n_graph)
    return d, tinfo, tmc._record_plan(d, tinfo, tiers, lne, n_graph, g)


def _lanes_then_butterfly(vals: np.ndarray) -> np.float64:
    """A warp's float64 sum as the reduction kernels take it: lane l sums
    vals[l::32] in order, then a butterfly over the 32 lanes."""
    s = np.zeros(32, np.float64)
    for i, x in enumerate(vals):
        s[i % 32] += x
    for off in (16, 8, 4, 2, 1):
        s = s + s[np.arange(32) ^ off]
    return s[0]


def _emulate(plan, v_ev, v_free):
    """The kernels' arithmetic read from the packed plan, on the CPU:
    (each tier's owner terms f32 [n], the gradient f32 [W] summed in the
    kernels' order).  A term's chain sum is an integer below 2^24 off
    RATIO, so its order does not matter there."""
    from sampler_tpu_torch.engine.potentials import _phi_from_counts

    NC = v_ev.shape[1]
    terms = []
    for head, flags, nbr, eq in plan.packed:
        A = flags.shape[1]
        word = head[:, 3].to(torch.int64) & 0xFFFFFFFF
        assert torch.equal(
            torch.stack([(word >> 8 * a) & 0xFF for a in range(min(A, 4))],
                        1), flags[:, :4].to(torch.int64))
        ty = ((head[:, 1] & 0xFF) ^ 0x80) - 0x80
        n = (head[:, 1] >> 8)[:, None]
        feat = head[:, 2].view(torch.float32)
        fl = flags.to(torch.int32)
        phis = []
        for v in (v_ev, v_free):
            own = tgrad._rows_or_zero(v, head[:, 0].to(torch.int64)).to(
                torch.int32)
            nl = torch.zeros(own.shape, dtype=torch.int32)
            hd = torch.zeros(own.shape, dtype=torch.bool)
            for a in range(A):
                f = fl[:, a, None]
                x = own
                if a < A - 1:
                    x = torch.where((f & tgrad.FLAG_OWN) != 0, own,
                                    tgrad._rows_or_zero(
                                        v, nbr[:, a].to(torch.int64)).to(
                                        torch.int32))
                tgt = 1 if eq is None else eq[:, a, None]
                lit = (x == tgt) == ((f & tgrad.FLAG_POS) != 0)
                nl += (lit & ((f & tgrad.FLAG_CNT) != 0)).to(torch.int32)
                hd |= lit & ((f & tgrad.FLAG_HEAD) != 0)
            phis.append(_phi_from_counts(nl, hd, n, ty[:, None],
                                         fs.ALL_FACTOR_FUNCS))
        s = (phis[0] - phis[1]).sum(dim=1)
        terms.append(s * tgrad.inv_chains(NC) * feat)
    flat = torch.cat(terms).numpy().astype(np.float64)
    perm = plan.perm.numpy()
    ps = plan.piece_start.numpy()
    part = np.array([_lanes_then_butterfly(flat[perm[ps[p]:ps[p + 1]]])
                     for p in range(len(ps) - 1)])
    wp = plan.weight_piece.numpy()
    grad = np.array([_lanes_then_butterfly(part[wp[w]:wp[w + 1]])
                     for w in range(plan.W)], np.float64)
    return terms, torch.from_numpy(grad.astype(np.float32))


def _owner_terms(plan, v_ev, v_free):
    """Each tier's owner terms by the per-record plain version."""
    out = []
    for t in plan.tiers:
        rec = t.gsel.reshape(-1).nonzero().flatten()
        out.append(grad_records_plain(v_ev, v_free, *t[:14],
                                      plan.all_boolean)
                   .reshape(-1).index_select(0, rec))
    return out


def _within_ulp(got, want):
    """Each weight within one float32 ulp of ``want``."""
    r = want.abs()
    ulp = torch.nextafter(r, torch.full_like(r, float("inf"))) - r
    return bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("lne", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_lists_each_owner_record_once(name, lne):
    """The plan holds each record of the owner mask exactly once, in record
    order, with its own row, and nothing else (no non-owner, no hub pad
    chunk); its permutation sorts the terms by weight id, each weight's
    run in record order; its pieces cut each run into at most
    RECORD_PIECE terms, a weight's pieces consecutive."""
    d, tinfo, plan = _plan(name, lne)
    C, gB = tinfo.n_colors, tinfo.block_size
    tiers = _engaged(tinfo, PLAIN, d.w_init.shape[0])
    assert len(plan.tiers) == len(tiers) > 0
    wids = []
    for t, rt, (head, flags, nbr, eq) in zip(tiers, plan.tiers, plan.packed):
        ts, ti = d.tiers[t], tinfo.tiers[t]
        gsrc = ts.cs_gowner if lne else ts.cs_gtouch
        assert rt.gsel.data_ptr() == gsrc.data_ptr()
        rec = gsrc.nonzero().flatten()
        assert head.shape == (rec.numel(), 4) and rec.numel() > 0
        B, D, A = tier_geom(ts, ti, C)
        row = rec // D
        if ti.hub:
            hrow = ts.hb_row.reshape(-1)[row].to(torch.int64)
            assert bool((hrow < ti.block).all())        # no pad chunk
            own = (row // B) * gB + ti.off + hrow
        else:
            own = (row // B) * gB + ti.off + row % B
        assert torch.equal(head[:, 0].to(torch.int64), own)
        assert torch.equal(head[:, 2].view(torch.float32),
                           ts.cs_feat.reshape(-1)[rec])
        assert flags.shape == (rec.numel(), A)
        assert (nbr is None) == (A == 1)
        assert (eq is None) == tinfo.all_boolean
        if nbr is not None:
            assert torch.equal(nbr, ts.cs_nbr.view(-1, A - 1)[rec])
        wids.append(ts.cs_wid.reshape(-1)[rec].to(torch.int64))
    wid = torch.cat(wids)
    perm = plan.perm.to(torch.int64)
    assert torch.equal(torch.sort(perm)[0], torch.arange(wid.numel()))
    w = wid[perm]
    assert bool((w[1:] >= w[:-1]).all())
    same = w[1:] == w[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())
    ps, wp = plan.piece_start.to(torch.int64), plan.weight_piece
    assert int(ps[0]) == 0 and int(ps[-1]) == wid.numel()
    size = ps[1:] - ps[:-1]
    assert bool(((size > 0) & (size <= tgrad.RECORD_PIECE)).all())
    for k in range(plan.W):
        p0, p1 = int(wp[k]), int(wp[k + 1])
        assert bool((w[ps[p0]:ps[p1]] == k).all())
        assert int(ps[p1] - ps[p0]) == int((wid == k).sum())


def test_plan_holds_no_sparse_owner():
    """On a graph with sparse per-combination weights the plan lists the
    dense owner records alone; the sparse ones stay with the table
    lookup."""
    g = jfx.sparse_categorical_graph(seed=3, n=6)
    g.var_role[::2] = jfs.ROLE_EVIDENCE
    jdg, jinfo = jax_compile(g)
    tdg, tinfo = from_jax(jdg, jinfo)
    d = to_device(tdg, "cpu")
    sparse = 0
    for lne in (False, True):
        _, _, plan = _plan(None, lne, d, tinfo)
        for t, (head, *_) in zip(_engaged(tinfo, PLAIN, d.w_init.shape[0]),
                                 plan.packed):
            ts = d.tiers[t]
            gsrc = (ts.cs_gowner if lne else ts.cs_gtouch).reshape(-1)
            issp = ts.cs_issparse.reshape(-1)
            assert head.shape[0] == int((gsrc & ~issp).sum())
            sparse += int((gsrc & issp).sum())
    assert sparse > 0


@pytest.mark.parametrize("lne", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_records_sum_plain_matches_jax(name, lne):
    """The records route's plain version (grad_records_sum on CPU tensors)
    over every tier the route takes equals JAX mc_weight_gradient_cs."""
    jdg, jinfo, tdg, tinfo = _compiled(name)
    d, tinfo, plan = _plan(name, lne)
    assert len(plan.tiers) == len(tinfo.tiers)      # every tier: records
    v_ev, v_free = _worlds(tdg, tinfo, NC, 5 + len(name),
                           card200=name == "card200")
    ref = np.asarray(jmc.mc_weight_gradient_cs(
        jax_to_device(jdg), jnp.asarray(v_ev), jnp.asarray(v_free), lne,
        jinfo, OFF))
    got = tgrad.grad_records_sum(torch.from_numpy(v_ev),
                                 torch.from_numpy(v_free), plan)
    assert np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("lne", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_records_sum_equals_old_composition(name, lne):
    """The new plain version (one float64 sum over all tiers, rounded
    once) equals the route before it (per-record terms and a float64
    segment sum a tier, the tiers added in float32) within one float32
    ulp a tier of the weight's largest tier sum or running sum (the old
    route rounds each; where the tiers cancel, that is more than an ulp
    of the weight itself); and the kernels' arithmetic read from the
    packed plan gives the per-record plain version's owner terms bit for
    bit (RATIO: within 1e-6 of the largest) and the plain sums within one
    ulp."""
    d, tinfo, plan = _plan(name, lne)
    v_ev, v_free = (torch.from_numpy(v) for v in _worlds(
        d, tinfo, NC, 7, card200=name == "card200"))
    new = tgrad.grad_records_sum_plain(v_ev, v_free, plan)
    old = torch.zeros(plan.W)
    big = new.abs()
    for t in plan.tiers:
        part = segment_reduce(grad_records_plain(
            v_ev, v_free, *t[:14], plan.all_boolean), t.wid, plan.W)
        old = old + part
        big = torch.maximum(big, torch.maximum(part.abs(), old.abs()))
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    assert bool(((old - new).abs() <= len(plan.tiers) * ulp).all())
    terms, grad = _emulate(plan, v_ev, v_free)
    for got, want in zip(terms, _owner_terms(plan, v_ev, v_free)):
        if jfs.FUNC_RATIO in tinfo.present_funcs:
            assert float((got - want).abs().max()) <= 1e-6 * max(
                1.0, float(want.abs().max()))
        else:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ratio = jfs.FUNC_RATIO in tinfo.present_funcs
    assert _within_ulp(grad, new) or (
        ratio and float((grad - new).abs().max()) <= 1e-5)


@pytest.mark.parametrize("name", ["kbc_hub", "triple_band2", "potts3",
                                  "functions"])
def test_sharded_plans_sum_to_unsharded(name):
    """A 2-way graph shard: each rank's plan (its local owner records, own
    rows at its slice of each tier block, a hub chunk's from hb_row)
    through the kernels' arithmetic gives gradients that add up to the
    unsharded plan's and to JAX's."""
    jdg, jinfo, tdg, tinfo = _compiled(name, align=16, shards=2)
    d = to_device(tdg, "cpu")
    v_ev, v_free = _worlds(tdg, tinfo, NC, 23)
    t_ev, t_free = torch.from_numpy(v_ev), torch.from_numpy(v_free)
    for lne in (False, True):
        want = np.asarray(jmc.mc_weight_gradient_cs(
            jax_to_device(jdg), jnp.asarray(v_ev), jnp.asarray(v_free), lne,
            jinfo, OFF))
        whole = _emulate(_plan(None, lne, d, tinfo)[2], t_ev, t_free)[1]
        total = np.zeros_like(want)
        for g in range(2):
            local = tgs.shard_device_graph(tdg, tinfo, 2, g, "cpu")
            plan = _plan(None, lne, local, tinfo, 2, g)[2]
            total += _emulate(plan, t_ev, t_free)[1].numpy()
        assert np.abs(want).max() > 0.01
        np.testing.assert_allclose(total, whole.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(total, want, rtol=0, atol=ATOL)


def test_records_sum_wrapper_on_cpu_runs_plain_and_counts_nothing():
    d, tinfo, plan = _plan("kbc_hub", False)
    v_ev, v_free = (torch.from_numpy(v) for v in _worlds(d, tinfo, NC, 2))
    before = tgrad.grad_records_sum.launches
    got = tgrad.grad_records_sum(v_ev, v_free, plan)
    assert tgrad.grad_records_sum.launches == before
    assert torch.equal(got, tgrad.grad_records_sum_plain(v_ev, v_free, plan))
    assert tgrad.record_launches(plan) == 3
    with pytest.raises(ValueError):
        tgrad.record_plan([], plan.W, True)
    tier = plan.tiers[0]
    for bad in (tier._replace(wid=torch.full_like(tier.wid, plan.W)),
                tier._replace(wid=tier.wid[:, :1]),
                tier._replace(pos=tier.pos[:, :1])):
        with pytest.raises(ValueError):
            tgrad.record_plan([bad], plan.W, True)


# ------------------------------------------------------------- the card

def random_record_streams(dev, B, D, A, NC, seed, *, C=2, card=2,
                          types=FUNCS, int32=False, hub=False,
                          off_grid=False, P=3000):
    """Random streams of ``grad_records`` for C colors in compile's
    invariants: the ismine slots a non-empty suffix of the masked slots
    (slot A-1 always own), one head slot among the masked ones, arity the
    masked count; neighbour positions in [0, P); a color's own rows B
    apart, the last ending at P; hub=True gives them through an index
    array."""
    rng = np.random.default_rng(seed)
    S = (C, B, D)
    mask = rng.random(S + (A,)) < 0.8
    n_own = rng.integers(1, A + 1, S)
    ismine = np.arange(A) >= (A - n_own)[..., None]
    mask |= ismine
    arity = mask.sum(-1).astype(np.int16)
    # one head slot a record, a masked one (a record without a head
    # would give RATIO log1p(-1))
    head = np.where(mask, rng.random(S + (A,)), -1.0).argmax(-1)
    hmask = np.arange(A) == head[..., None]
    pos = rng.random(S + (A,)) < 0.6
    eq = None if card == 2 else rng.integers(0, card, S + (A,)).astype(
        np.int16)
    nbr = rng.integers(0, P, S + (A - 1,)).astype(np.int32)
    typ = np.asarray(types, np.int8)[rng.integers(0, len(types), S)]
    feat = rng.choice(np.float32([0.5, 1.0, 2.0, -1.5]), S)
    gsel = rng.random(S) < 0.6
    dt = np.int32 if int32 else np.int8
    worlds = [rng.integers(0, card, (P, NC)).astype(dt) for _ in range(2)]

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    v_ev, v_free = t(worlds[0]), t(worlds[1])
    if off_grid:        # the evidence world one byte past the 16-byte grid
        buf = torch.empty((P * NC + 1,), dtype=v_ev.dtype, device=dev)
        buf[1:].copy_(v_ev.reshape(-1))
        v_ev = buf[1:].view(P, NC)
    own_idx = (t(rng.integers(0, B, (C, B)).astype(np.int32)) if hub
               else None)
    present = tuple(sorted(set(int(x) for x in types)))
    return (v_ev, v_free, t(nbr), t(pos), t(ismine), t(mask), t(hmask),
            None if eq is None else t(eq), t(typ), t(arity), t(feat),
            t(gsel), P - C * B, B, own_idx, present, card == 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (B, D, A, NC, card, types, int32, hub, off_grid)
CARD_CASES = ([(300, d, a, nc, 2, FUNCS[:6], False, False, False)
               for a in (1, 2, 3, 5) for d in (1, 4, 9) for nc in (48, 37)]
              + [(200, 5, 3, 256, 2, FUNCS, False, False, False),
                 (64, 256, 3, 256, 2, FUNCS[:6], False, True, False),
                 (200, 5, 2, 512, 4, (jfs.FUNC_AND_CATEGORICAL,
                                      jfs.FUNC_EQUAL), False, False, False),
                 (200, 5, 2, 48, 200, (jfs.FUNC_AND_CATEGORICAL,), True,
                  False, False),
                 (200, 3, 3, 48, 2, FUNCS[:6], False, False, True)])


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda_device):
    for i, (B, D, A, nc, card, types, i32, hub, off) in enumerate(
            CARD_CASES):
        args = random_record_streams(cuda_device, B, D, A, nc, i,
                                     C=1 + i % 3, card=card, types=types,
                                     int32=i32, hub=hub, off_grid=off)
        got, again = grad_records(*args), grad_records(*args)
        ref = grad_records_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        if fs.FUNC_RATIO in types:
            assert float((got - ref).abs().max()) <= 1e-6 * max(
                1.0, float(ref.abs().max())), (B, D, A, nc)
        else:
            assert torch.equal(got.view(torch.int32),
                               ref.view(torch.int32)), (B, D, A, nc, card)


@pytest.mark.gpu
def test_records_sum_kernel_matches_plain_on_card(cuda_device):
    """grad_records_sum on random streams (a plan of one tier each of
    CARD_CASES, weight ids from a few weights): its owner terms equal the
    per-record plain version's bit for bit (RATIO: within 1e-6 of the
    largest), each weight within one float32 ulp of the plain sum (RATIO:
    within 1e-6 a record), and two calls equal byte for byte."""
    for i, (B, D, A, nc, card, types, i32, hub, off) in enumerate(
            CARD_CASES):
        args = random_record_streams(cuda_device, B, D, A, nc, i,
                                     C=1 + i % 3, card=card, types=types,
                                     int32=i32, hub=hub, off_grid=off)
        W = 1 + i % 5
        wid = torch.randint(0, W, tuple(args[10].shape), dtype=torch.int32,
                            device=cuda_device)
        plan = tgrad.record_plan([tgrad.RecordTier(*args[2:16], wid)], W,
                                 args[16])
        got = tgrad.grad_records_sum(args[0], args[1], plan)
        terms = plan.terms.clone()
        again = tgrad.grad_records_sum(args[0], args[1], plan)
        ref = tgrad.grad_records_sum_plain(args[0], args[1], plan)
        want = _owner_terms(plan, args[0], args[1])[0]
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        if fs.FUNC_RATIO in types:
            scale = max(1.0, float(want.abs().max()))
            assert float((terms - want).abs().max()) <= 1e-6 * scale
            n = max(1, int(plan.terms.numel()))
            assert float((got - ref).abs().max()) <= 1e-6 * scale * n
        else:
            assert torch.equal(terms.view(torch.int32),
                               want.view(torch.int32)), (B, D, A, nc, card)
            assert _within_ulp(got, ref), (B, D, A, nc, card)
