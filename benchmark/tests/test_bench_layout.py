"""BENCHMARK.json and the files it names: every configuration, mix, job
kind, metric reader and yardstick is a file of its own, found by name, and
the entries keep to the benchmark's contract."""

import json
import os
import re

import pytest

from tiny import BENCH, ROOT, bench  # first: it puts the benchmark on sys.path
from mtgbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = bench()
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"] and B["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]] + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configs_found_by_name(c):
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and c["file"] == f"benchmark/configs/{c['name']}.json"
    assert set(c["reduced"]) <= set(cfg) and "published" in cfg or not c["reduced"]
    for key in c["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size", "_length")) or key == "genome_length"


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files_and_metrics(w):
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert w["config"] in {c["name"] for c in B["configs"]}
    traffic = harness.load_json("traffic", w["traffic"] + ".json")
    assert hasattr(harness.load("jobs", traffic["job"]), "Job")
    e2e = harness.metric_specs(B, w["name"], trace=False)
    layer = harness.metric_specs(B, w["name"], trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    moved = {m["name"] for m in e2e}
    for m in layer:
        assert m["moves"] in moved, (w["name"], m["name"])
    for m in e2e + layer:
        assert callable(harness.load("metrics", m["name"]).read)


def test_every_configuration_is_used_and_every_reader_named():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    readers = {f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics")) if f.endswith(".py")}
    assert {m["name"] for m in METRICS} <= readers


def test_rooflines_found_by_name():
    for m in B["per_layer"]:
        if m["name"].endswith("_roofline"):
            mod = harness.load("roofline", m["name"][: -len("_roofline")])
            assert mod.KERNELS and callable(mod.least_seconds)


def test_counters_name_program_counters():
    c = harness.Counters()
    assert len(c.entries) >= 7
    assert all(isinstance(n, int) for n in c.snapshot().values())


def test_a_new_cell_needs_no_edit(tmp_path):
    """A cell of a new mix is data alone: the harness finds its mix, its
    job kind and its metrics by name."""
    assert harness.load_json("traffic", "find_graph.json")["job"] == "find"
    assert harness.load("jobs", "find") is harness.load("jobs", "find")
