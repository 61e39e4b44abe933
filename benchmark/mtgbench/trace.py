"""The device trace of a traced run: one torch.profiler window (CPU and
CUDA) around the whole run of jobs, read back from its Chrome trace.

Kernels launched through a C launcher (ctypes) are recorded by CUPTI as
any other. torch.profiler has been seen to lose records; the program's
launch counters say how many launches of each kernel a window made, so a
window whose trace holds fewer is taken again (`traced_window`)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "mtgbench.window"
JOB_SPAN = "mtgbench.job"
TRIES = 3


def short_name(name: str) -> str:
    """A kernel's name cut to its function's own (no namespace, template
    or arguments)."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split("::")[-1].split()
    return head[-1] if head else name


@dataclass
class Trace:
    window: tuple[float, float]  # the window's span, microseconds on the trace's clock
    device: list = field(default_factory=list)  # (start us, end us, name, cat) of device events
    jobs: list = field(default_factory=list)  # (start us, end us, label) of the job spans
    lost: set = field(default_factory=set)  # kernels whose launches the trace did not all hold

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernel_events(self, names) -> list:
        names = set(names)
        return [e for e in self.device if e[3] == "kernel" and short_name(e[2]) in names]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device events, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for s, e, _n, _c in self.device if e > lo and s < hi)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_ops(self, n: int = 10) -> list:
        """The device operations that took the most time: [name, seconds]."""
        tot: dict[str, float] = {}
        for s, e, name, cat in self.device:
            key = short_name(name) if cat == "kernel" else name
            tot[key] = tot.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches of the window with nothing on the device,
        each named by the job span it falls in and the device operations
        around it: [label, seconds]."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        ops = sorted(self.device)
        gaps = []
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e <= s:
                continue
            inside = [label for js, je, label in self.jobs if je > s and js < e]
            job = (f"job {inside[0]}" if len(inside) == 1 else f"jobs {inside[0]}-{inside[-1]}") if inside \
                else "between jobs"
            before = next((short_name(o[2]) for o in reversed(ops) if o[1] <= s), "window start")
            after = next((short_name(o[2]) for o in ops if o[0] >= e), "window end")
            gaps.append([f"{job}: after {before}, before {after}", (e - s) / 1e6])
        return sorted(gaps, key=lambda g: -g[1])[:n]


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    device, jobs = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, "kernel" if cat == "kernel" else name))
        elif cat == "user_annotation":
            if name == WINDOW_SPAN:
                window = (ts, ts + dur)
            elif name.startswith(JOB_SPAN):
                jobs.append((ts, ts + dur, name[len(JOB_SPAN) + 1:]))
    if window is None:
        raise RuntimeError(f"the trace {path} holds no {WINDOW_SPAN} span")
    return Trace(window, sorted(device), sorted(jobs))


def traced_window(run_window, counters, workdir: str, device: str):
    """Run `run_window()` under torch.profiler; returns (the result of
    each window run, the last window's Trace). A window whose trace
    holds fewer launches of a kernel than the counters report is taken
    again, up to TRIES windows; the last one's missing kernels are left in
    `Trace.lost`, and their metrics are not reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    on_cuda = device == "cuda"
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
    results = []
    for attempt in range(TRIES):
        before = counters.snapshot()
        with profile(activities=activities) as prof:
            if on_cuda:
                # the first launch after the profiler starts can go unrecorded
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            with record_function(WINDOW_SPAN):
                out = run_window(lambda label: record_function(f"{JOB_SPAN}.{label}"))
                if on_cuda:
                    torch.cuda.synchronize()
        path = os.path.join(workdir, f"trace{attempt}.json")
        prof.export_chrome_trace(path)
        tr = read_chrome_trace(path)
        os.remove(path)
        launches = counters.delta(before)
        tr.lost = {kernel for kernel, n in launches.items() if len(tr.kernel_events([kernel])) < n}
        results.append(out)
        if not tr.lost:
            break
    return results, tr
