"""The port's spans (``sampler_tpu_torch.observe``) on the CPU entry points:

  * with no profiler recording a span records nothing and never builds a
    record function, and the entry points' outputs are bit for bit those
    of a run under a profiler;
  * under torch.profiler the engine's phases nest as the engine calls
    them: a root a request, a fold a run, a sweep a sweep, an epoch's
    fold, gradient and update;
  * each record lies on the trace's own clock, as the trace's ``cpu_op``
    event of the same name, nested the same way;
  * ``span_table``'s self time is exact on synthetic records;
  * plans are built once a graph; ``dw gibbs --profile`` traces the load,
    the compile and the engine, and logs the span line.
"""
import json

import numpy as np
import pytest
import torch

from sampler_tpu_torch import fixtures, observe
from sampler_tpu_torch.benchgraphs import random_kbc_graph
from sampler_tpu_torch.cli import main
from sampler_tpu_torch.coloring import greedy_coloring
from sampler_tpu_torch.compile import compile_graph, to_device
from sampler_tpu_torch.engine.learn import LearnConfig
from sampler_tpu_torch.engine.multichain import (infer_mc, init_values_mc,
                                                 learn_mc, run_inference_mc)
from sampler_tpu_torch.io import binary
from sampler_tpu_torch.ops.tally import tally_counts

CLOCK_TOL_NS = 500_000          # a record against its trace event
CHAINS = 8
CFG = LearnConfig(n_epochs=3, n_sweeps_per_epoch=2, stepsize=0.05,
                  diminish=0.95, regularization="none")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_records():
    observe.clear_spans()
    yield
    observe.clear_spans()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _grid():
    g = fixtures.ising_grid(4, 4)
    dg, info = compile_graph(g)
    return to_device(dg, "cpu"), info


def _kbc():
    """A small KBC graph with a hub tier: the fold, the CPU dm plan with
    its hub rows, and the records route's gradient plan."""
    g = random_kbc_graph(300, 900, max_arity=3, n_weights=11, seed=3,
                         skew=1.2, evidence_frac=0.3)
    dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=8,
                             hub_chunk=4)
    assert info.has_hub
    return to_device(dg, "cpu"), info


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _infer(d, info, seed=0):
    return infer_mc(d, d.w_init, _gen(seed), 2, 4, info, CHAINS,
                    device="cpu")


def _learn(d, info, seed=0):
    return learn_mc(d, d.w_init, _gen(seed), CFG, info, CHAINS,
                    device="cpu")


def _named(records, name):
    return [i for i, r in enumerate(records) if r.name == name]


def test_spans_off_without_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record function built for {name}")

    monkeypatch.setattr(observe, "_record_function", refuse)
    d, info = _kbc()
    _infer(d, info)
    _learn(d, info)
    assert observe.spans() == []
    assert observe.span("engine.sweep") is observe.span("op.tally_counts")


def test_inference_spans_nest_by_sweep():
    d, info = _grid()
    v = init_values_mc(d, _gen(), CHAINS, info)
    with _profiler():
        run_inference_mc(d, v, d.w_init, _gen(1), 5, False, info,
                         device="cpu")
    recs = observe.spans()
    roots = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].name for i in roots] == ["engine.run_inference"]
    req = recs[roots[0]].request
    assert all(r.request == req for r in recs)
    assert len(_named(recs, "engine.fold")) == 1
    sweeps = _named(recs, "engine.sweep")
    assert len(sweeps) == 5
    assert all(recs[i].parent == roots[0] for i in sweeps)
    # the plain versions open no kernel span
    assert not any(r.name.startswith("op.") for r in recs)


def test_learning_spans_nest_by_epoch():
    d, info = _kbc()
    with _profiler():
        _learn(d, info)
    recs = observe.spans()
    E, S = CFG.n_epochs, CFG.n_sweeps_per_epoch
    epochs = _named(recs, "engine.epoch")
    assert len(epochs) == E
    for name in ("engine.fold", "engine.gradient", "engine.update"):
        idx = _named(recs, name)
        assert len(idx) == E, name
        assert all(recs[i].parent in epochs for i in idx), name
    sweeps = _named(recs, "engine.sweep")
    assert len(sweeps) == 2 * E * S
    assert all(recs[i].parent in epochs for i in sweeps)
    root = _named(recs, "engine.learn")
    assert len(root) == 1 and recs[root[0]].parent < 0
    assert len(_named(recs, "engine.init_values")) == 2
    assert {r.request for r in recs} == {recs[root[0]].request}


@pytest.mark.parametrize("entry", ["infer", "learn"])
def test_outputs_equal_with_the_profiler_on_and_off(entry):
    d, info = _kbc()
    run = _infer if entry == "infer" else _learn
    off = run(d, info, seed=5)
    with _profiler():
        on = run(d, info, seed=5)
    assert observe.spans()
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)


def test_records_lie_on_the_trace_clock(tmp_path):
    d, info = _grid()
    with _profiler() as prof:
        _learn(d, info)
        _infer(d, info)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    recs = observe.spans()
    names = {r.name for r in recs}
    events = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") in names:
            assert e["cat"] == "cpu_op", e
            events.setdefault(e["name"], []).append(e)
    matched = []
    for r in recs:
        evs = events[r.name]
        start = [e["ts"] * 1000 + base for e in evs]
        j = int(np.argmin([abs(s - r.start_ns) for s in start]))
        e = evs[j]
        assert abs(start[j] - r.start_ns) < CLOCK_TOL_NS, r
        assert abs(e["dur"] * 1000 - (r.end_ns - r.start_ns)) \
            < CLOCK_TOL_NS, r
        matched.append((e["ts"], e["ts"] + e["dur"]))
    assert len(set(matched)) == len(recs)
    for r, (a, b) in zip(recs, matched):
        if r.parent >= 0:
            pa, pb = matched[r.parent]
            assert pa <= a and b <= pb, r


def test_span_table_self_time_is_exact():
    R = observe.Record
    recs = [R("root", 0, 100, -1, 1),
            R("kid", 10, 40, 0, 1),
            R("kid", 30, 60, 0, 1),          # overlaps the first kid
            R("leaf", 35, 45, 2, 1),
            R("kid", 90, 120, 0, 1),         # runs past its parent
            R("root", 200, 210, -1, 2),
            R("open", 220, None, -1, 3)]
    assert observe.self_ns(recs) == [40, 30, 20, 10, 30, 10, None]
    table = observe.span_table(recs)
    assert list(table) == ["kid", "root", "leaf"]
    n, inc, own = table["kid"]
    assert n == 3 and abs(inc - 90e-9) < 1e-18 and abs(own - 80e-9) < 1e-18
    n, inc, own = table["root"]
    assert n == 2 and abs(inc - 110e-9) < 1e-18 and abs(own - 50e-9) < 1e-18
    assert observe.span_line(recs, top=1).startswith("kid 3 ")


def test_plans_are_built_once_a_graph():
    d, info = _kbc()
    with _profiler():
        _learn(d, info)
        _infer(d, info)
    first = {r.name for r in observe.spans() if r.name.startswith("plan.")}
    assert {"plan.derived", "plan.records"} <= first
    observe.clear_spans()
    with _profiler():
        _learn(d, info, seed=1)
        _infer(d, info, seed=1)
    assert observe.spans()
    assert not [r for r in observe.spans() if r.name.startswith("plan.")]


def test_cli_profile_traces_load_compile_and_engine(tmp_path, capsys):
    g = fixtures.labeled_coin_graph(n_flips=40, seed=2)
    meta = binary.write_graph(g, str(tmp_path))
    prof = tmp_path / "prof"
    assert main(["gibbs", "-w", str(tmp_path / "graph.weights"),
                 "-v", str(tmp_path / "graph.variables"),
                 "-f", str(tmp_path / "graph.factors"), "-m", meta,
                 "-o", str(tmp_path / "out"), "-l", "5", "-i", "5",
                 "--device", "cpu", "--profile", str(prof)]) == 0
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    assert {"cli.load", "compile.graph", "compile.layout",
            "compile.to_device", "engine.learn", "engine.run_inference",
            "cli.marginals"} <= names
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("spans (name count inclusive_s self_s): ")]
    assert len(line) == 1
    rows = line[0].split(": ", 1)[1].split("; ")
    assert 0 < len(rows) <= 12
    table = observe.span_table(observe.spans())
    assert rows[0].split()[0] == next(iter(table))


def test_requests_open_at_roots_and_clear_refuses_inside_a_span():
    with _profiler():
        with observe.span("a"):
            with observe.span("b"):
                with pytest.raises(RuntimeError):
                    observe.clear_spans()
        with observe.span("c"):
            pass
    a, b, c = observe.spans()
    assert (a.parent, b.parent, c.parent) == (-1, 0, -1)
    assert a.request == b.request != c.request
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns


def test_wrapper_span_only_on_the_card_path():
    counts = torch.zeros((2, 6), dtype=torch.int32)
    values = torch.tensor([[0, 1], [1, 1], [0, 0], [1, 0], [1, 1], [0, 1]],
                          dtype=torch.int8)
    with _profiler():
        tally_counts(counts, values)
    assert observe.spans() == []
    assert counts.sum().item() == 12
    assert tally_counts.__name__ == "tally_counts"
    assert tally_counts.launches == 0


def test_spanned_passes_arguments_and_exceptions():
    @observe.spanned("t.fn")
    def fn(x, y=2):
        if x < 0:
            raise ValueError("negative")
        return x * y

    assert fn(3) == 6
    with _profiler():
        assert fn(3, y=4) == 12
        with pytest.raises(ValueError):
            fn(-1)
        with observe.span("t.after"):
            pass
    recs = observe.spans()
    assert [(r.name, r.parent) for r in recs] == [("t.fn", -1), ("t.fn", -1),
                                                  ("t.after", -1)]
    assert all(r.end_ns is not None for r in recs)
