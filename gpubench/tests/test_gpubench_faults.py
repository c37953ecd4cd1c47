"""A whole run of each cell on the CPU, the harness's look for a card
skipped: sound, it is correct; with the timed path broken underneath, or
with the lower-precision control in the program's place, it is not."""
import os
import subprocess
import sys

import pytest
import torch

from gpubench import jobs
from gpubench.faults import planted
from gpubench_cells import ROOT, run

CELLS = [("ising-2048", "infer"), ("ising-2048", "learn")]


@pytest.mark.parametrize("config,traffic,chains", [
    (c, t, n) for c, t in CELLS for n in (1, 16)])
def test_sound_run_is_correct(config, traffic, chains):
    r = run(config, traffic, chains=chains)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1


@pytest.mark.parametrize("config,traffic,i,chains", [
    (c, t, i, n) for c, t in CELLS for i in range(5) for n in (1, 64)])
def test_fault_is_caught(config, traffic, i, chains):
    name, target, wrap = jobs.kind(traffic).FAULTS[i]
    with planted(target, wrap):
        r = run(config, traffic, chains=chains)
    assert not r["correct"], (name, r["check"])


@pytest.mark.parametrize("traffic,kw", [
    ("infer", dict(rows=128, cols=128, chains=128, sweeps=2)),
    ("learn", dict(rows=128, cols=128, chains=64, epochs=2))])
def test_control_is_caught(traffic, kw):
    r = run("ising-2048", traffic, control=True, seconds=30.0, **kw)
    assert r["control"] and not r["correct"], r["check"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ising-2048.infer", "ising-2048.learn"])
def test_control_at_cell_size_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "gpubench", "run.py"),
         "--workload", cell, "--seed", "424242", "--seconds", "10",
         "--trace", "0", "--control", "1"], capture_output=True, text=True,
        cwd=ROOT, timeout=360, check=True)
    assert '"correct": false' in out.stdout.splitlines()[-1]
