"""The control of a cell's comparison: the reference put in the program's
place with the configuration's guarantee broken (a Bloom filter answers for
the exact solid set), held to the exact reference by the cell's own check.
Each compared number must read 0 for the program and above 0 for the
control on some number of every cell."""

from __future__ import annotations

import json
import os
import tempfile

from .harness import ROOT, load, load_json
from .reference.bloom import BloomSet


def control_checks(config: dict, traffic: dict, seed: int, device: str, member=None) -> dict[str, int]:
    """The cell's compared numbers for the control on one seed. `member`
    wraps the reference's exact solid set (the Bloom filter by default)."""
    member = member or (lambda solid: BloomSet(solid, device=device))
    kind = load("jobs", traffic["job"])
    with tempfile.TemporaryDirectory(prefix="mtgbench-control-") as workdir:
        job = kind.Job(config, traffic, seed, workdir, device)
        want = job.reference()
        got = job.reference(member=member)
        prefix = os.path.join(workdir, "control")
        job.write_answer(got, prefix)
        return {name: value for name, (value, _limit) in job.check([prefix], want).items()}


def cell_inputs(bench: dict, cell_name: str) -> tuple[dict, dict]:
    """(the configuration, the traffic mix) of a cell of BENCHMARK.json."""
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    return config, load_json("traffic", cell["traffic"] + ".json")
