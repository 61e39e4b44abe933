#!/usr/bin/env python3
"""The benchmark of mindthegap_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names a configuration and a traffic mix. The run makes its inputs from the
seed, warms up on a small cut of them, then runs whole jobs of the mix
back to back for about `--seconds`, in this process. With `--trace 1` one
torch.profiler window covers the jobs and the per-layer metrics are read
from it and from the jobs' phase clocks; with `--trace 0` the end-to-end
metrics are reported. After the window every job's output files are held
against the plain reference (benchmark/mtgbench/reference). The compared
numbers and their limits are the last lines on standard error; the last
line on standard output is the result, as JSON.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
# kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from mtgbench import harness

    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the benchmark runs without JAX and the JAX package",
              file=sys.stderr)
        return 3
    print(f"log: {json.dumps(result.pop('log'))}", file=sys.stderr)
    for err in result.get("errors", []):
        print(f"failed job: {err}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
