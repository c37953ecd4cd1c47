#!/usr/bin/env python3
"""Compare two trees of the PyTorch/CUDA port on one card, in turns.

Run on a machine with a CUDA card, from the repository root, with two
unpacked trees (say the parent commit and the change, each from
``git archive``, in directories that .gitignore lists):

    python3 tools/chip_compare.py checkout/parent checkout/change

Each side runs in its own process, in the order parent, change, change,
parent, with its own chip_smoke.py helpers and its own kernels (built
into its tree's sampler_tpu_torch/_build/), and prints one line:
``tree rc RESULT {json}`` with

  * ``tally_<rows>x<chains>``: tally_counts' ms a launch on a random int8
    world of two values (the flagship's 1,048,577 x 512, the KBC cell's
    500,000 x 1024, the 5120^2 grid's 26,214,400 x 128);
  * ``<cell>_learn``: one learning epoch by part (chip_smoke.epoch_parts,
    the mean of 5, after 10 epochs of learn_mc) on the learning cells of
    chip_smoke.py phases 6, 9, 12 and 16 (the labelled Ising flagship,
    triple and Potts grids and the KBC learning graph);
  * ``kbc_learn_walls_s``: the wall seconds of 5 learn_mc runs of 10
    epochs on the KBC learning graph (after one warm epoch), and
    ``kbc_learn_updates_per_s`` from them, as phase 16 counts them.

The card's name and power limit come first (nvidia-smi).  The script
imports neither JAX nor the JAX package.
"""
import subprocess
import sys

ONE = r'''
import dataclasses, json, os, sys, time
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
from sampler_tpu_torch.coloring import greedy_coloring
from sampler_tpu_torch.compile import compile_graph, to_device
from sampler_tpu_torch.engine.learn import LearnConfig
from sampler_tpu_torch.engine.multichain import learn_mc, resolve_modes
from sampler_tpu_torch.ops import _build
from sampler_tpu_torch.ops.tally import tally_counts

_build.build()
dev = torch.device("cuda")
out = {}
gen = torch.Generator(device=dev).manual_seed(1)
for rows, nc in ((1048577, 512), (500000, 1024), (26214400, 128)):
    v = torch.randint(0, 2, (rows, nc), generator=gen, device=dev,
                      dtype=torch.int8)
    c = torch.zeros((2, rows), dtype=torch.int32, device=dev)
    out[f"tally_{rows}x{nc}"] = cs.time_ms(lambda: tally_counts(c, v),
                                           iters=50)
    del v, c
cfg = LearnConfig(n_epochs=cs.LEARN_EPOCHS,
                  n_sweeps_per_epoch=cs.LEARN_SWEEPS, stepsize=0.01,
                  diminish=0.99, regularization="l2", reg_param=0.01)


def epochs(name, d, info, chains):
    g = torch.Generator(device=dev).manual_seed(2)
    w, v_ev, v_free = learn_mc(d, d.w_init, g, cfg, info, chains,
                               device=dev)
    out[name] = cs.epoch_parts(d, w, info, resolve_modes(info, dev), v_ev,
                               v_free, cfg, g, reps=5)


g, colors = cs.labelled_flagship(cs.GRID)
dg, info = compile_graph(g, colors=colors)
epochs("ising_learn", to_device(dg, dev), info, cs.LEARN_CHAINS)
_, d, info, _ = cs.triple_flagship(dev, labelled=True)
epochs("triple_learn", d, info, cs.LEARN_CHAINS)
_, d, info, _ = cs.potts_flagship(dev, labelled=True)
epochs("potts_learn", d, info, cs.CAT_CHAINS)
g = cs.kbc_graph(cs.KBC_LEARN_VARS, 10_000, 1)
colors = greedy_coloring(g)
cs.label_half(g)
dg, info = compile_graph(g, colors=colors, band_wmax=32768, hub_cap=256)
d = to_device(dg, dev)
epochs("kbc_learn", d, info, cs.LEARN_CHAINS)
learn_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(1),
         dataclasses.replace(cfg, n_epochs=1), info, cs.LEARN_CHAINS,
         device=dev)
walls = []
for _ in range(5):
    torch.cuda.synchronize()
    t = time.perf_counter()
    learn_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(2), cfg,
             info, cs.LEARN_CHAINS, device=dev)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
n = info.n_vars * cfg.n_epochs * cfg.n_sweeps_per_epoch * 2 * cs.LEARN_CHAINS
out["kbc_learn_walls_s"] = walls
out["kbc_learn_updates_per_s"] = [n / w for w in walls]
print("RESULT " + json.dumps(out), flush=True)
'''


def main(argv=None) -> int:
    parent, change = (argv if argv is not None else sys.argv[1:])[:2]
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    failed = 0
    for name, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        r = subprocess.run([sys.executable, "-c", ONE, tree],
                           capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT")]
        failed |= r.returncode != 0 or not lines
        print(name, r.returncode,
              lines[-1] if lines else r.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
