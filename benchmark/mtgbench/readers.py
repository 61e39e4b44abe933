"""Helpers of the metric readers (metrics/<name>.py). Each returns None
where there is nothing to read: no job did the work, the run was not
traced, the trace lost a kernel's records, or the device has no peaks in
the table. None of them returns 0 for a share it could not read."""

from __future__ import annotations

import json
import os

from .harness import BENCH_DIR, load

SORT_KERNELS = ("RadixSort", "radixSort", "DeviceRadix", "SegmentedSort")


def rate(run, unit: str, scale: float = 1.0):
    """Work of every job in the window over the window's seconds."""
    work = [j.work.get(unit) for j in run.jobs]
    if not work or None in work or run.window_s <= 0:
        return None
    return sum(work) * scale / run.window_s


def phase_mean(run, *names: str):
    """Seconds a job spent in the named -profile phases, the mean over the
    window's jobs; None when a job reports none of them."""
    per_job = []
    for j in run.jobs:
        found = [j.phases[n] for n in names if n in j.phases]
        if not found:
            return None
        per_job.append(sum(found))
    return sum(per_job) / len(per_job) if per_job else None


def device_seconds(run, kernels=(), substrings=()):
    """Device seconds of the named kernels (and of those whose names hold
    one of `substrings`) in the traced window."""
    tr = run.trace
    if tr is None or not tr.device or (set(kernels) & tr.lost):
        return None
    from .trace import short_name

    total, seen = 0.0, False
    for s, e, name, cat in tr.device:
        if cat != "kernel":
            continue
        if short_name(name) in kernels or any(p in name for p in substrings):
            total += (e - s) / 1e6
            seen = True
    return total if seen else None


def peaks(device_kind: str):
    with open(os.path.join(BENCH_DIR, "mtgbench", "peaks.json")) as f:
        return json.load(f).get(device_kind)


def roofline_pct(run, kernel: str):
    """100 x the least time the card could take for the window's work of
    `kernel` (roofline/<kernel>.py, from the cell's inputs alone) over the
    time the trace gives that kernel."""
    mod = load("roofline", kernel)
    pk = peaks(run.device_kind)
    t = device_seconds(run, mod.KERNELS)
    if pk is None or not t or not run.jobs:
        return None
    return 100.0 * len(run.jobs) * mod.least_seconds(run.kernel_inputs, pk) / t


def idle_pct(run):
    """Share of the traced window with no kernel, copy or memset on the
    device."""
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
