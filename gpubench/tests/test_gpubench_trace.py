"""Idle share, gaps and their host ops from synthetic intervals."""
import types

from gpubench import trace
from gpubench_cells import harness


def test_merge_and_gaps():
    busy = trace.merge([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert busy == [[0, 3], [5, 8]]
    assert trace.gaps(busy, 0, 10) == [(3, 5), (8, 10)]
    assert trace.gaps(busy, -1, 8) == [(-1, 0), (3, 5)]


def test_gap_goes_to_the_innermost_host_op():
    host = [(0, 100, "outer"), (20, 40, "inner"), (60, 70, "other")]
    by = trace.attribute([(25, 35), (62, 68), (80, 90), (200, 210)], host)
    want = {"inner": 10e-6, "other": 6e-6, "outer": 10e-6,
            "host (no op)": 10e-6}
    assert by.keys() == want.keys()
    assert all(abs(by[k] - want[k]) < 1e-15 for k in want)


def test_idle_share_reader():
    s = trace.Summary(window_s=2.0, busy_s=1.5, n_kernels=40, jobs=2,
                      sweeps=20, by_kernel={"void k<1>(int)": (1.0, 30),
                                            "other_kernel": (0.5, 10)},
                      breakdown={})
    ctx = dict(trace=s, job=types.SimpleNamespace(kind="infer"))
    assert harness.reader("device_idle_pct.infer")(ctx) == 25.0
    assert harness.reader("device_idle_pct.learn")(ctx) is None
    assert harness.reader("launches_per_sweep.infer")(ctx) == 2.0
    assert s.kernel_seconds([r"\bk\b"]) == (1.0, 30)
    assert trace.short("void dm_gather_draw_kernel<16, true>(Launch, int)") \
        == "dm_gather_draw_kernel"


def test_no_trace_no_reading():
    ctx = dict(trace=None, job=types.SimpleNamespace(kind="infer"))
    for m in ("device_idle_pct.infer", "launches_per_sweep.infer",
              "tally_counts_roofline", "fused_dm_draw_roofline"):
        assert harness.reader(m)(dict(ctx)) is None
