"""The reference against brute force on graphs small enough to
enumerate: each conditional, the gradient, and the marginals of a Gibbs
sampler built on it; the pooled draw statistic on draws of known law."""
import itertools

import numpy as np
import pytest
import torch

from gpubench import graphs, judge, reference as ref
from gpubench.graphs import (FUNC_AND, FUNC_EQUAL, FUNC_IMPLY_MLN,
                             FUNC_IMPLY_NATURAL, FUNC_ISTRUE, FUNC_OR)


def phi(ftype, lits):
    """φ from the definitions, one factor (head = last literal)."""
    head, body = lits[-1], lits[:-1]
    if ftype in (FUNC_AND, FUNC_IMPLY_NATURAL):
        return float(all(lits))
    if ftype == FUNC_OR:
        return float(any(lits))
    if ftype == FUNC_EQUAL:
        return float(all(lits) or not any(lits))
    if ftype == FUNC_ISTRUE:
        return float(head)
    if ftype == FUNC_IMPLY_MLN:
        return 1.0 if not all(body) else float(head)
    raise ValueError(ftype)


def members(g, f):
    s = slice(g["f_ptr"][f], g["f_ptr"][f + 1])
    return g["e_vid"][s], g["e_ispos"][s]


def log_weight(g, x):
    total = 0.0
    for f in range(len(g["f_type"])):
        vids, pos = members(g, f)
        lits = [bool(x[v] == 1) == bool(p) for v, p in zip(vids, pos)]
        total += g["w_init"][g["f_wid"][f]] * g["f_feat"][f] * phi(
            g["f_type"][f], lits)
    return total


def small_graph():
    """Six variables, every factor type, a negated literal, a variable in
    two slots of one factor, an isolated variable (5) and evidence (4)."""
    return graphs.arrays(
        var_role=[0, 0, 0, 0, 1, 0], var_init=[0, 0, 0, 0, 1, 0],
        w_init=[0.7, -1.1, 0.4, 1.3],
        f_type=[FUNC_ISTRUE, FUNC_AND, FUNC_OR, FUNC_EQUAL, FUNC_IMPLY_MLN,
                FUNC_IMPLY_NATURAL, FUNC_ISTRUE, FUNC_OR],
        f_wid=[0, 1, 2, 3, 1, 0, 3, 2],
        f_ptr=[0, 1, 3, 6, 8, 11, 13, 14, 16],
        e_vid=[0, 0, 1, 1, 2, 3, 2, 4, 0, 3, 1, 2, 2, 5, 5, 5],
        e_ispos=[1, 1, 0, 1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 1, 1, 0])


COLORS = np.array([0, 1, 0, 2, 1, 0])        # proper: no factor repeats one


def exact_marginals(g):
    V = len(g["var_card"])
    ev = np.asarray(g["var_role"]) == 1
    p1, z = np.zeros(V), 0.0
    for x in itertools.product([0, 1], repeat=V):
        x = np.array(x)
        if (x[ev] != np.asarray(g["var_init"])[ev]).any():
            continue
        w = np.exp(log_weight(g, x))
        z += w
        p1 += w * x
    return p1 / z


def test_coloring_is_proper():
    fa = ref.Factors(small_graph(), "cpu")
    assert judge.proper(fa, COLORS)
    assert not judge.proper(fa, np.zeros(6, np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conditionals_match_enumeration(seed):
    g = small_graph()
    fa = ref.Factors(g, "cpu")
    rng = np.random.default_rng(seed)
    NC = 7
    old = rng.integers(0, 2, (6, NC)).astype(np.int8)
    new = rng.integers(0, 2, (6, NC)).astype(np.int8)
    d = ref.logodds(fa, g["w_init"], torch.from_numpy(old),
                    torch.from_numpy(new), COLORS).numpy()
    for v in range(6):
        for n in range(NC):
            x = np.where(COLORS < COLORS[v], new[:, n], old[:, n]).astype(int)
            x1, x0 = x.copy(), x.copy()
            x1[v], x0[v] = 1, 0
            want = log_weight(g, x1) - log_weight(g, x0)
            assert abs(d[v, n] - want) < 1e-12, (v, n)
    lo = ref.logodds(fa, g["w_init"], torch.from_numpy(old),
                     torch.from_numpy(new), COLORS, torch.bfloat16)
    assert lo.dtype == torch.bfloat16
    assert np.abs(lo.double().numpy() - d).max() < 0.05


def test_gradient_matches_loops():
    g = small_graph()
    fa = ref.Factors(g, "cpu")
    rng = np.random.default_rng(4)
    ev = rng.integers(0, 2, (6, 5)).astype(np.int8)
    free = rng.integers(0, 2, (6, 5)).astype(np.int8)
    got = ref.gradient(fa, torch.from_numpy(ev), torch.from_numpy(free))
    want = np.zeros(4)
    for f in range(len(g["f_type"])):
        vids, pos = members(g, f)
        if not (np.asarray(g["var_role"])[vids] == 1).any():
            continue
        for n in range(5):
            a = phi(g["f_type"][f], [bool(ev[v, n] == 1) == bool(p)
                                     for v, p in zip(vids, pos)])
            b = phi(g["f_type"][f], [bool(free[v, n] == 1) == bool(p)
                                     for v, p in zip(vids, pos)])
            want[g["f_wid"][f]] += (a - b) / 5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_gibbs_on_the_reference_finds_the_exact_marginals():
    g = small_graph()
    fa = ref.Factors(g, "cpu")
    gen = torch.Generator().manual_seed(0)
    NC, sweeps = 4000, 120
    x = torch.randint(0, 2, (6, NC), generator=gen, dtype=torch.int8)
    ev = fa.role == 1
    x[ev] = fa.label[ev][:, None].to(torch.int8)
    ones = torch.zeros(6, dtype=torch.float64)
    for s in range(sweeps):
        for c in range(3):
            d = ref.logodds(fa, g["w_init"], x, x, COLORS)
            draw = torch.bernoulli(torch.sigmoid(d), generator=gen).to(
                torch.int8)
            sel = torch.as_tensor(COLORS == c) & ~ev
            x[sel] = draw[sel]
        if s >= 20:
            ones += x.double().sum(dim=1)
    p = (ones / (NC * (sweeps - 20))).numpy()
    assert np.abs(p - exact_marginals(g)).max() < 0.01


def test_z_bins_pool_draws_and_see_a_biased_law():
    """Draws from the reference's own conditionals read |z| of a standard
    normal in every bin; draws from probabilities 0.005 too high do not."""
    g, colors = graphs.generator("ising_torus")(0, 32, 32, 0.8813735870195430)
    fa = ref.Factors(g, "cpu")
    gen = torch.Generator().manual_seed(3)
    every = torch.ones(fa.V, dtype=torch.bool)
    sound, biased = judge.ZBins("cpu"), judge.ZBins("cpu")
    for _ in range(8):
        old = torch.randint(0, 2, (fa.V, 512), generator=gen,
                            dtype=torch.int8)
        # one color drawn from ``old`` alone: the other keeps its values
        d = ref.logodds(fa, g["w_init"], old, old, colors)
        p = torch.sigmoid(d)
        one = torch.as_tensor(colors == 0)[:, None]
        for zb, q in ((sound, p), (biased, (p + 0.005).clamp(max=1))):
            new = torch.where(one, torch.bernoulli(q, generator=gen).to(
                torch.int8), old)
            zb.add(fa, g["w_init"], old, new, colors,
                   torch.as_tensor(colors == 0))
    assert sound.max() < 4.5
    assert biased.max() > 10
    rows = sound.table()
    assert sum(n for _, n, _ in rows) == 8 * 512 * fa.V // 2
