"""The generators, found by name: deterministic in the seed, and the
periodic lattice is the torus its configuration states."""
import numpy as np
import pytest

from gpubench_cells import parts
from gpubench import graphs, reference as ref, judge


def test_same_seed_same_graph():
    cfg, _ = parts("ising-2048", "infer")
    a, ca = graphs.make(cfg, 2 ** 31 + 17)
    b, cb = graphs.make(cfg, 2 ** 31 + 17)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("rows,cols", [(4, 4), (6, 10), (64, 64)])
def test_torus(rows, cols):
    g, colors = graphs.generator("ising_torus")(0, rows, cols, 0.75)
    V = rows * cols
    assert len(g["f_type"]) == 2 * V and (g["f_type"] == 3).all()
    assert (np.diff(g["f_ptr"]) == 2).all() and (g["f_wid"] == 0).all()
    assert g["w_init"].tolist() == [0.75] and (g["var_role"] == 0).all()
    pairs = g["e_vid"].reshape(-1, 2)
    # every site has four neighbours, each pair once, and the wrap edges
    assert (np.bincount(pairs.reshape(-1), minlength=V) == 4).all()
    assert len({tuple(sorted(p)) for p in pairs.tolist()}) == 2 * V
    r, c = np.divmod(pairs, cols)
    dr, dc = (r[:, 1] - r[:, 0]) % rows, (c[:, 1] - c[:, 0]) % cols
    assert (((dr == 0) & (dc == 1)) | ((dr == 1) & (dc == 0))).all()
    assert judge.proper(ref.Factors(g, "cpu"), colors)


def test_odd_torus_refused():
    with pytest.raises(ValueError):
        graphs.generator("ising_torus")(0, 5, 8, 0.75)


def test_unknown_generator_named():
    with pytest.raises(FileNotFoundError):
        graphs.generator("no_such_generator")


def test_every_second_label():
    cfg, _ = parts("ising-2048", "learn")
    g, _ = graphs.make(cfg, 0, "every_second")
    assert (g["var_role"][::2] == 1).all() and (g["var_role"][1::2] == 0).all()
    assert (g["var_init"][::2] == np.arange(len(g["var_role"][::2])) % 2).all()
