"""A tiny cell run end to end on the CPU, through the harness with the
kernels' plain versions (the program's `-device cpu`): the outputs hold to
the reference, and the device metrics refuse to report. The command itself
refuses to run without a CUDA device."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from tiny import BENCH, ROOT, bench, cell  # first: it puts the benchmark on sys.path
from mtgbench import harness


def _run(name, trace, **kw):
    cfg, traffic = cell(name, **kw)
    return harness.run_cell(bench(), name, 2**31 + 77, 1.0, trace, time.perf_counter(), device="cpu",
                            config=cfg, traffic=traffic)


@pytest.mark.parametrize("name", ["ecoli_k31.find_graph", "ecoli_k45.find_graph", "ecoli_k31.find_reads"])
def test_tiny_cell_traced_on_cpu(name):
    r = _run(name, True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    specs = {m["name"]: m for m in harness.metric_specs(bench(), name, True)}
    for metric in r["metrics"]:
        assert specs[metric]["source"] != "device_trace", metric
    assert any(specs[m]["source"] == "program_span" for m in r["metrics"])
    assert r["device"]["platform"] == "cpu" and r["device"]["busy_s"] == 0.0
    assert "breakdown" not in r
    assert list(r)[-1] == "checks" and all(c["value"] == 0 for c in r["checks"].values())


def test_tiny_cell_untraced_reports_end_to_end():
    r = _run("ecoli_k31.find_graph", False)
    assert r["correct"] and set(r["metrics"]) == {"find_graph_mbp_per_s", "setup_s"}
    assert r["metrics"]["find_graph_mbp_per_s"]["value"] > 0 and r["metrics"]["setup_s"]["value"] > 0


def test_options_reach_the_program_and_the_reference_alike(tmp_path):
    """The configuration's detection options, at values other than the
    program's defaults, reach the job's command and the reference alike."""
    name = "ecoli_k31.find_reads"
    cfg, traffic = cell(name)
    opts = {"max_rep": 2, "het_max_occ": 2, "snp_min_val": 3, "branching_filter": 5, "abundance_min": 5}
    cfg.update(opts)
    job = harness.load("jobs", traffic["job"]).Job(cfg, traffic, 2**31 + 78, str(tmp_path), "cpu")
    args = job.args(str(tmp_path / "out"))
    given = dict(zip(args, args[1:]))
    for key, value in opts.items():
        assert given["-" + key.replace("_", "-")] == str(value), key
    want = job.reference()
    assert want["graph"][2]["thresholds"] == 5
    r = harness.run_cell(bench(), name, 2**31 + 79, 1.0, False, time.perf_counter(), device="cpu",
                         config=cfg, traffic=traffic)
    assert r["correct"] and all(c["value"] == 0 for c in r["checks"].values()), r


def test_command_refuses_without_cuda(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "ecoli_k31.find_graph",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_command_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ecoli_k31.find_graph",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert json.loads(open(tmp_path / "BENCHMARK.json").read())["paths"] == ["benchmark"]
