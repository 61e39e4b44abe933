#!/usr/bin/env python3
"""The control of a cell's comparison, at the cell's own size: the
reference with a Bloom filter in place of the exact solid set, held to the
exact reference by the cell's check, on each seed given. Prints one JSON
line a seed. The benchmark's runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    from mtgbench import control

    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    config, traffic = control.cell_inputs(bench, args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = control.control_checks(config, traffic, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
