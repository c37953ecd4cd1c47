"""The readers of the program's spans on synthetic records and a synthetic
context: each number from its definition, and None where a run is
untraced, of another kind, has no records, or runs a program without
spans."""
import types

import pytest

from gpubench import trace
from gpubench_cells import harness

from sampler_tpu_torch import observe

R = observe.Record
US = 1000                       # ns a microsecond

# two inference runs (3 sweeps in all) under one root each, a
# marginals-like span outside them, and a sweep outside any run
INFER = [
    R("engine.init_values", 0, 10 * US, -1, 1),                 # 0
    R("engine.run_inference", 20 * US, 120 * US, -1, 2),        # 1
    R("engine.fold", 21 * US, 25 * US, 1, 2),                   # 2
    R("engine.sweep", 25 * US, 60 * US, 1, 2),                  # 3
    R("op.fused_dm_draw", 30 * US, 40 * US, 3, 2),              # 4
    R("op.fused_dm_draw", 45 * US, 55 * US, 3, 2),              # 5
    R("op.tally_counts", 60 * US, 66 * US, 1, 2),               # 6
    R("engine.sweep", 70 * US, 110 * US, 1, 2),                 # 7
    R("op.fused_dm_draw", 75 * US, 80 * US, 7, 2),              # 8
    R("op.tally_counts", 112 * US, 116 * US, 1, 2),             # 9
    R("engine.run_inference", 200 * US, 260 * US, -1, 3),       # 10
    R("engine.sweep", 210 * US, 250 * US, 10, 3),               # 11
    R("op.fused_dm_draw", 215 * US, 225 * US, 11, 3),           # 12
    R("engine.run_sweeps", 300 * US, 340 * US, -1, 4),          # 13
    R("engine.sweep", 300 * US, 340 * US, 13, 4),               # 14
    R("op.fused_dm_draw", 310 * US, 330 * US, 14, 4),           # 15
]

LEARN = [
    R("engine.learn", 0, 400 * US, -1, 1),                      # 0
    R("engine.init_values", 1 * US, 5 * US, 0, 1),              # 1
    R("engine.epoch", 10 * US, 110 * US, 0, 1),                 # 2
    R("engine.fold", 10 * US, 30 * US, 2, 1),                   # 3
    R("engine.sweep", 30 * US, 60 * US, 2, 1),                  # 4
    R("engine.gradient", 60 * US, 100 * US, 2, 1),              # 5
    R("engine.epoch", 200 * US, 360 * US, 0, 1),                # 6
    R("engine.fold", 200 * US, 240 * US, 6, 1),                 # 7
    R("engine.fold", 380 * US, 390 * US, 0, 1),                 # 8: no epoch
]


def _ctx(kind, window_s=1e-3):
    s = trace.Summary(window_s=window_s, busy_s=0.0, n_kernels=0, jobs=1,
                      sweeps=1, by_kernel={}, breakdown={})
    return dict(trace=s, job=types.SimpleNamespace(kind=kind))


@pytest.fixture
def records(monkeypatch):
    box = []
    monkeypatch.setattr(observe, "spans", lambda: list(box))
    return box


def test_inference_readers(records):
    records.extend(INFER)
    ctx = _ctx("infer", window_s=500e-6)
    # runs 100 + 60 us over the 3 sweeps under them
    assert harness.reader("sweep_host_us.infer")(ctx) \
        == pytest.approx(160 / 3)
    # op self times under the runs: 10 + 10 + 6 + 5 + 4 + 10 us
    assert harness.reader("wrapper_host_us.infer")(ctx) \
        == pytest.approx(45 / 3)
    # roots 10 + 100 + 60 + 40 us of a 500 us stretch
    assert harness.reader("outside_program_pct.infer")(ctx) \
        == pytest.approx(100 * (1 - 210 / 500))
    for m in ("epoch_host_us.learn", "fold_host_us.learn",
              "outside_program_pct.learn"):
        assert harness.reader(m)(dict(ctx)) is None


def test_learning_readers(records):
    records.extend(LEARN)
    ctx = _ctx("learn", window_s=800e-6)
    assert harness.reader("epoch_host_us.learn")(ctx) \
        == pytest.approx((100 + 160) / 2)
    # folds under epochs 20 + 40 us over 2 epochs; the loose fold is not
    assert harness.reader("fold_host_us.learn")(ctx) == pytest.approx(30)
    assert harness.reader("outside_program_pct.learn")(ctx) \
        == pytest.approx(50)
    for m in ("sweep_host_us.infer", "wrapper_host_us.infer",
              "outside_program_pct.infer"):
        assert harness.reader(m)(dict(ctx)) is None


NAMES = ["sweep_host_us.infer", "wrapper_host_us.infer",
         "outside_program_pct.infer", "epoch_host_us.learn",
         "fold_host_us.learn", "outside_program_pct.learn"]


@pytest.mark.parametrize("name", NAMES)
def test_untraced_or_empty_reads_none(name, records):
    kind = name.rsplit(".", 1)[1]
    records.extend(INFER if kind == "infer" else LEARN)
    assert harness.reader(name)(dict(trace=None, job=types.SimpleNamespace(
        kind=kind))) is None
    records.clear()
    assert harness.reader(name)(_ctx(kind)) is None


@pytest.mark.parametrize("name", NAMES)
def test_program_without_spans_reads_none(name, monkeypatch):
    monkeypatch.delattr(observe, "spans")
    kind = name.rsplit(".", 1)[1]
    assert harness.reader(name)(_ctx(kind)) is None
