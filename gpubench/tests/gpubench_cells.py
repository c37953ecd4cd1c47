"""Small cells for the benchmark's CPU tests: the real configurations and
traffic, cut to sizes a CPU holds."""
import copy
import io
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from gpubench import harness  # noqa: E402

torch.set_num_threads(1)

SMALL = {"ising_torus": dict(rows=64, cols=64)}


def parts(config: str, traffic: str, chains: int = 16, sweeps: int = 12,
          epochs: int = 4, **graph) -> tuple:
    cfg = copy.deepcopy(harness.load_json("configs", config + ".json"))
    cfg["graph"].update(SMALL[cfg["generator"]], **graph)
    cfg["n_chains"] = chains
    tr = copy.deepcopy(harness.load_json("workloads", traffic + ".json"))
    tr.update(n_sweeps=sweeps) if tr["job"] == "infer" else tr.update(
        n_epochs=epochs)
    return cfg, tr


def run(config: str, traffic: str, seed: int = 5, seconds: float = 6.0,
        traced: bool = False, control: bool = False, **kw) -> dict:
    """One run of the small cell on the CPU, with the real cell's limits
    and metrics; its printed lines are dropped."""
    cfg, tr = parts(config, traffic, **kw)
    name = f"{config}.{traffic}"
    bench = harness.load_bench(ROOT)
    return harness.run({"name": name}, cfg, tr,
                       harness.load_json("limits", name + ".json"),
                       harness.metric_names(bench, name, traced), seed,
                       seconds, traced, "cpu", control, out=io.StringIO(),
                       err=io.StringIO())
