"""The roofline counts, by hand, on a 4x4 torus and a four-variable
KBC-shaped graph (a duplicated member and an evidence variable in it)."""
import numpy as np

from gpubench import graphs, roofline
from gpubench.graphs import FUNC_AND, FUNC_ISTRUE, FUNC_OR


def test_torus_4x4():
    g, _ = graphs.generator("ising_torus")(0, 4, 4, 0.5)   # 32 EQUAL pairs
    every = np.ones(16, bool)
    w = roofline.draw_sweep(g, 16, every)
    # 16 rows read and 16 written; 64 incidences; 1 weight
    assert w.bytes == 16 * (16 + 16) + 9 * 64 + 4 * 1
    # 64 (variable, factor) pairs, 2 a drawn value
    assert w.f32 == 16 * (64 + 2 * 16)
    # members of each pair's factor: 64 x 2
    assert w.i32 == 16 * 2 * 128 / 4
    t = roofline.tally_sweep(g, 16)
    assert t.bytes == 16 * 16 + 2 * 4 * 2 * 16 and t.i32 == 2 * 16 * 16 / 4
    gl = graphs.label(g, "every_second")       # the even sites
    gr = roofline.gradient(gl, 16)
    # all 16 row pairs and the 8 column pairs of even sites: 48 incidences
    assert gr.bytes == 2 * 16 * 16 + 9 * 48 + 4 * 1
    assert gr.f32 == 16 * 24 and gr.i32 == 2 * 2 * 16 * 48 / 4


def tiny_kbc():
    #   f0 ISTRUE(0) w0; f1 AND(0, 1) w1; f2 OR(1, 2, 3) w0; f3 AND(3, 3) w2
    return graphs.arrays(
        var_role=[0, 0, 1, 0], var_init=[0, 0, 1, 0], w_init=[0.1, 0.2, 0.3],
        f_type=[FUNC_ISTRUE, FUNC_AND, FUNC_OR, FUNC_AND], f_wid=[0, 1, 0, 2],
        f_ptr=[0, 1, 3, 6, 8], e_vid=[0, 0, 1, 1, 2, 3, 3, 3],
        e_ispos=[1, 1, 0, 1, 1, 1, 1, 0])


def test_tiny_kbc():
    g = tiny_kbc()
    drawn = np.array([True, True, False, True])
    w = roofline.draw_sweep(g, 8, drawn)
    # pairs (f, v): (0,0) (1,0) (1,1) (2,1) (2,3) (3,3); 4 rows, 3 drawn;
    # 8 incidences; weights 0, 1, 2
    assert w.bytes == 8 * (4 + 3) + 9 * 8 + 4 * 3
    assert w.f32 == 8 * (6 + 2 * 3)
    assert w.i32 == 8 * 2 * (1 + 2 + 2 + 3 + 3 + 2) / 4
    gr = roofline.gradient(g, 8)               # only f2 has variable 2
    assert gr.bytes == 2 * 8 * 3 + 9 * 3 + 4 * 3
    assert gr.f32 == 8 and gr.i32 == 2 * 2 * 8 * 3 / 4


def test_bound_takes_the_largest_term():
    w = roofline.Work(bytes=3.35e9, f32=67e9 * 2, i32=0)
    assert w.bound() == (2e-3, "f32")
    assert (w * 2).bound() == (4e-3, "f32")
    assert roofline.Work(bytes=3.35e12).bound() == (1.0, "bytes")
