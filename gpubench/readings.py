"""Readings of a cell's checks at its own size, for setting its limits:
per seed, ``--jobs`` sound jobs read by the reference and by the
lower-precision control, and on the seeds of ``--fault-seeds`` two jobs
with each planted fault of the cell's job kind (``FAULTS`` in
``gpubench/kinds/<kind>.py``).  One JSON line a (seed, reading).

    python3 gpubench/readings.py --workload <cell> --seeds 11,12,13 \\
        --fault-seeds 11

Seeds whose graph arrays are equal share one set-up.  The benchmark's own
runs never run this; the control over a whole window is
``run.py --control 1``.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same_graph(a: dict, b: dict) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--jobs", type=int, default=16)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from gpubench import faults, graphs, harness, jobs

    bench = harness.load_bench(ROOT)
    cell, config, traffic = harness.cell_parts(bench, args.workload)
    kind = jobs.kind(traffic["job"])
    labels = config["labels"] if traffic["job"] == "learn" else None
    fault_seeds = {int(x) for x in args.fault_seeds.split(",") if x}
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    s = dg = None
    for seed in (int(x) for x in args.seeds.split(",")):
        if s is None or not same_graph(graphs.make(config, seed, labels)[0],
                                       s.graph):
            s = dg = None
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            s = harness.set_up(config, traffic, seed, dev)
            dg = s.dg
            jobs.make(traffic, warmup=True).run(
                s, jobs.job_generator(seed, -1, dev))
        job = jobs.make(traffic)
        runs = [("sound", None, None, args.jobs)]
        if seed in fault_seeds:
            runs += [(n, t, w, 2) for n, t, w in kind.FAULTS]
        for name, target, wrap, n_jobs in runs:
            s.dg = dg
            t0 = time.perf_counter()
            done, kept = [], []
            with (faults.planted(target, wrap) if target
                  else contextlib.nullcontext()):
                for i in range(n_jobs):
                    r = job.run(s, jobs.job_generator(seed, i, dev))
                    done.append(r.brief)
                    kept.append((i, {k: v.cpu() if torch.is_tensor(v) else v
                                     for k, v in r.keep.items()}))
                    del r
            harness.sync(dev)
            dt = time.perf_counter() - t0
            win = harness.Window([], dt, done, kept, None)
            modes = [(name, False)] + ([("control", True)] if target is None
                                       else [])
            for label, control in modes:
                nums, notes = harness.check(s, win, job, traffic, control,
                                            seed)
                print(json.dumps(dict(cell=args.workload, seed=seed,
                                      reading=label, jobs=n_jobs, job_s=dt,
                                      **nums, bins=notes[0]["draw_z_bins"])),
                      flush=True)
            del win, kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
