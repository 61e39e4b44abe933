"""The benchmark's CPU tests (`python -m pytest benchmark/tests -q` from
the repository's root) import this first: it puts the benchmark's folder
and the repository on sys.path, and cuts a cell to a size the tests hold
(the configuration's widths, options and read layout kept; the genome and
its variant counts cut)."""

import copy
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, genome: int = 40_000, warmup: int = 15_000):
    """(config, traffic) of a BENCHMARK.json cell at `genome` bases."""
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == name)
    entry = next(c for c in b["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(genome_length=genome, insertions=3, snps=2, deletions=2)
    traffic["warmup_bases"] = warmup
    return cfg, traffic
