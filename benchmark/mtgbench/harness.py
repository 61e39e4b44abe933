"""One run of one cell: set-up, the measured window of whole jobs, the
traced window, the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, job kind,
metric or kernel is a file of its own under the benchmark's folder, found
by the name that BENCHMARK.json (or another file) gives it:

    configs/<config>.json     the deployment's sizes and options
    traffic/<mix>.json        a mix: its job kind and the kind's parameters
    jobs/<kind>.py            Job: makes the inputs, the command of a job,
                              the reference and the comparison
    metrics/<metric>.py       read(run) -> number, or None: nothing to read
    roofline/<kernel>.py      KERNELS, least_seconds(inputs, peaks)
    counters/<name>.json      a launch counter of the program and its kernel
"""

from __future__ import annotations

import contextlib
import gc
import glob
import importlib.util
import io
import itertools
import json
import os
import re
import sys
import tempfile
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "mindthegap_tpu")
_MODULES: dict = {}


def load(kind: str, name: str):
    """The module benchmark/<kind>/<name>.py (names may hold dots)."""
    key = (kind, name)
    if key not in _MODULES:
        path = os.path.join(BENCH_DIR, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(f"mtgbench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def load_json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Counters:
    """The program's kernel launch counters (counters/*.json)."""

    def __init__(self):
        self.entries = []
        for path in sorted(glob.glob(os.path.join(BENCH_DIR, "counters", "*.json"))):
            with open(path) as f:
                spec = json.load(f)
            mod = importlib.import_module(spec["module"])
            self.entries.append((getattr(mod, spec["attr"]), spec["kernel"]))

    def snapshot(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for fn, kernel in self.entries:
            out[kernel] = out.get(kernel, 0) + int(fn.launches)
        return out

    def delta(self, before: dict[str, int]) -> dict[str, int]:
        return {k: n - before[k] for k, n in self.snapshot().items() if n - before[k] > 0}


@dataclass
class JobRecord:
    prefix: str
    seconds: float
    ok: bool
    phases: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    error: str = ""


@dataclass
class Run:
    """What a metric reader sees."""

    cell: str
    config: dict
    traffic: dict
    device_kind: str
    setup_s: float
    jobs: list
    window_s: float
    kernel_inputs: dict
    trace: object = None  # trace.Trace of a traced run


_PHASE = re.compile(r"^ {8}(\S.*?)\s*: ([\d.]+) s$")


def parse_phases(report: str) -> dict[str, float]:
    """The -profile phase clocks of a job's report (seconds by phase)."""
    out, on = {}, False
    for line in report.splitlines():
        if line.strip() == "Per-phase timings":
            on = True
        elif on:
            m = _PHASE.match(line)
            if not m:
                break
            out[m.group(1)] = float(m.group(2))
    return out


def run_job(cli, args: list[str], prefix: str, work: dict) -> JobRecord:
    report, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(report), contextlib.redirect_stderr(err):
            rc = cli.main(args)
        ok, error = rc == 0, f"exit code {rc}" if rc else ""
    except Exception as e:  # a job that raises is a failed job; the run goes on
        ok, error = False, f"{type(e).__name__}: {e}"
    seconds = time.perf_counter() - t0
    if not ok:
        error += "\n" + report.getvalue()[-1000:] + err.getvalue()[-1000:]
    return JobRecord(prefix, seconds, ok, parse_phases(report.getvalue()), dict(work), error)


def sync(device: str):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def window(cli, job, seconds: float, workdir: str, device: str, tag: str, span=None) -> tuple[list, float]:
    """Whole jobs back to back. After a job ends the window closes if one
    more job of the mean length so far would end past `seconds`; the first
    job always runs, and a failed job ends the window. Returns (the jobs,
    seconds from the window's start to the last job's end)."""
    jobs: list[JobRecord] = []
    t0 = time.perf_counter()
    while True:
        prefix = os.path.join(workdir, f"{tag}{len(jobs)}")
        ctx = span(f"{len(jobs)}") if span else contextlib.nullcontext()
        with ctx:
            jobs.append(run_job(cli, job.args(prefix), prefix, job.work))
            sync(device)
        elapsed = time.perf_counter() - t0
        if elapsed + elapsed / len(jobs) > seconds or not jobs[-1].ok:
            return jobs, elapsed


def host_probe_s() -> float:
    """Seconds of a fixed host task (the least of three sorts of 2^22
    random 64-bit words): the host's speed beside a run's numbers, which
    the host's own phases follow."""
    import numpy as np

    words = np.random.default_rng(0).integers(0, 2**63, 2**22, dtype=np.uint64)
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        np.sort(words)
        best = min(best, time.perf_counter() - t)
    return best


def metric_specs(bench: dict, cell: str, trace: bool) -> list[dict]:
    specs = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in specs if "workloads" not in m or cell in m["workloads"]]


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", config: dict | None = None, traffic: dict | None = None,
             program=None) -> dict:
    """One run of the cell; returns the result object (the last line a run
    prints), with the compared numbers under "checks". `config` and
    `traffic` stand in for the files; `program` for the CLI module."""
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    if config is None:
        cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
        with open(os.path.join(ROOT, cfg_entry["file"])) as f:
            config = json.load(f)
    traffic = traffic or load_json("traffic", cell["traffic"] + ".json")
    kind = load("jobs", traffic["job"])
    if program is None:
        from mindthegap_tpu_torch import cli as program
    import torch

    on_cuda = device == "cuda"
    log = {"imports_s": time.perf_counter() - t_start}
    with tempfile.TemporaryDirectory(prefix="mtgbench-") as workdir:
        t = time.perf_counter()
        job = kind.Job(config, traffic, seed, workdir, device)
        log["inputs_s"] = time.perf_counter() - t
        counters = Counters()
        warm = run_job(program, job.warmup_args(os.path.join(workdir, "warmup", "out")), "", {})
        if not warm.ok:
            raise RuntimeError(f"the warm-up job failed: {warm.error}")
        sync(device)
        gc.collect()
        log["warmup_s"] = warm.seconds
        setup_s = time.perf_counter() - t_start

        devices = range(cell["chips"] if on_cuda else 0)
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        tr = None
        proc0 = time.process_time()
        if trace:
            from . import trace as T

            attempt = itertools.count(1)
            windows, tr = T.traced_window(
                lambda span: window(program, job, seconds, workdir, device, f"t{next(attempt)}_", span),
                counters, workdir, device)
            all_jobs = [j for jobs, _s in windows for j in jobs]
            jobs, window_s = windows[-1]
        else:
            jobs, window_s = window(program, job, seconds, workdir, device, "job")
            all_jobs = jobs
        log["window_process_cpu_s"] = time.process_time() - proc0
        log["host_probe_s"] = host_probe_s()
        memory_peak = max((torch.cuda.max_memory_allocated(d) for d in devices), default=0)
        device_kind = torch.cuda.get_device_name() if on_cuda else "cpu"
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()

        t = time.perf_counter()
        want = job.reference()
        checks = job.check([j.prefix for j in all_jobs], want)
        log["reference_s"] = time.perf_counter() - t
        log["jobs"] = [{"s": j.seconds, "phases": j.phases} for j in all_jobs]

    run = Run(cell_name, config, traffic, device_kind, setup_s, jobs, window_s, job.kernel_inputs, tr)
    metrics = {}
    for spec in metric_specs(bench, cell_name, trace):
        value = None if (spec["source"] == "device_trace" and not on_cuda) else load("metrics", spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    failed = sum(1 for j in all_jobs if not j.ok)
    correct = failed == 0 and all(v <= limit for v, limit in checks.values())
    dev = {"platform": "gpu" if on_cuda else "cpu", "kind": device_kind,
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(all_jobs), "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s if on_cuda else 0.0
        dev["window_s"] = tr.window_s
        if on_cuda:
            result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["errors"] = [j.error for j in all_jobs if not j.ok][:3]
    result["log"] = log
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    return result
