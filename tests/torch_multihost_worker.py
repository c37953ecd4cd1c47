"""One process of tests/test_torch_multihost.py's process group.

    python torch_multihost_worker.py <rank> <world> <store file> <dir>

Joins a Gloo group through the ``file://`` store, loads the compiled
graphs that the test pickled into <dir>, runs the port's entry points as
this process's rank (infer_multihost and learn_multihost on the chains
mesh of every rank, infer_gs and learn_gs on a 2 x 2 mesh), and saves the
results as <dir>/<name>_r<rank>.npy.
"""
import os
import pickle
import sys


def main():
    rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch

    from sampler_tpu_torch.engine.learn import LearnConfig
    from sampler_tpu_torch.parallel.comm import make_mesh
    from sampler_tpu_torch.parallel.graph_shard import infer_gs, learn_gs
    from sampler_tpu_torch.parallel.multihost import (global_chains_mesh,
                                                      infer_multihost,
                                                      init_multihost,
                                                      learn_multihost)

    torch.set_num_threads(1)
    init_multihost(f"file://{store}", world, rank, backend="gloo")
    with open(os.path.join(outdir, "graphs.pkl"), "rb") as f:
        graphs = pickle.load(f)
    mesh = global_chains_mesh("cpu")
    out = {}
    dg, info = graphs["ising"]
    out["marg"] = infer_multihost(dg, dg.w_init, 7, 50, 400, info, mesh,
                                  chains_per_device=8)
    dg, info = graphs["coin"]
    cfg = LearnConfig(**graphs["coin_cfg"])
    out["w"] = learn_multihost(dg, dg.w_init, 11, cfg, info, mesh,
                               chains_per_device=4).numpy()
    mesh2 = make_mesh(2, 2, ["cpu"] * 4)
    dg, info = graphs["ising_gs"]
    out["marg_gs"] = infer_gs(dg, dg.w_init, 21, 50, 400, info, mesh2, 4)
    dg, info = graphs["coin_gs"]
    cfg = LearnConfig(**graphs["coin_gs_cfg"])
    out["w_gs"] = learn_gs(dg, dg.w_init, 31, cfg, info, mesh2, 4).numpy()
    for name, a in out.items():
        np.save(os.path.join(outdir, f"{name}_r{rank}.npy"), a)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
