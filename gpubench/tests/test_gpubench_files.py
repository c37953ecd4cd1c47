"""Every configuration, traffic mix, limit, metric reader and kernel file
that BENCHMARK.json names is found by name and read, and the file keeps
the contract's shape."""
import os
import re

import pytest

from gpubench_cells import ROOT, harness

BENCH = harness.load_bench(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found(cfg):
    data = harness.load_json("configs", cfg["name"] + ".json")
    assert cfg["file"] == f"gpubench/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert NAME.match(cfg["name"])
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_parts_found(cell):
    c, cfg, traffic = harness.cell_parts(BENCH, cell["name"])
    assert c is cell and cfg["name"] == cell["config"]
    assert traffic["job"] in ("infer", "learn")
    limits = harness.load_json("limits", cell["name"] + ".json")
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    for traced in (False, True):
        names = [m["name"] for m in harness.metric_names(BENCH, cell["name"],
                                                         traced)]
        assert names, (cell["name"], traced)
        if not traced:
            assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found(m):
    assert callable(harness.reader(m["name"]))
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    e2e = {x["name"] for x in BENCH["end_to_end"]}
    if "moves" in m:
        assert m["moves"] in e2e
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("kernel", sorted(
    f[:-5] for f in os.listdir(os.path.join(ROOT, "gpubench", "kernels"))))
def test_kernel_names_found(kernel):
    data = harness.load_json("kernels", kernel + ".json")
    assert data["kernel"] == kernel and data["device_names"]
    assert any(m["name"] == kernel + "_roofline" for m in BENCH["per_layer"])


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
