"""Run one cell of the port's benchmark once.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; then ``check``, each number the verdict
compared with its limit.  Earlier lines give the card and its power limit
beside the peaks used, the kernels' launch counts and each roofline's
terms.  Exits non-zero, and prints no result, without a CUDA card.

``--control 1`` reads the checks with the lower-precision control (the
reference in bfloat16) in the program's place; the benchmark's own runs
never pass it.
"""
import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = os.path.join(ROOT, "gpubench", "out", "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    sys.path.insert(0, ROOT)
    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    from gpubench.harness import run_cell

    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bool(args.control),
                      T_PROCESS)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
