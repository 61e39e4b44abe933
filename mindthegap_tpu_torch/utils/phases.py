"""Per-phase wall-clock accounting (SURVEY.md §5.1).

The reference reports one coarse `Time` row (difftime around the core phase,
src/Finder.cpp:401-405). We keep that row byte-compatible and, with the
hidden `-profile` flag, add a per-phase breakdown beneath it; `-profile-trace
DIR` additionally captures a torch.profiler trace of the run (Chrome trace
format; the JAX package writes a jax.profiler trace instead).

A job's PhaseTimer is the current one while the job runs (`PhaseTimer.active`),
so code below the runner opens child spans with `span(name)` and adds to
counts with `count(name, n)` without being handed the timer; with no current
timer both do nothing. While a torch.profiler runs, each span is also a
`record_function` range named by its path, on the same clock as the card's
kernels and copies in the trace."""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from dataclasses import dataclass

import torch

SEP = " / "


@dataclass(frozen=True)
class SpanRecord:
    """One pass through a span, on time.perf_counter's clock."""

    path: str
    parent: str | None
    start: float
    end: float


class PhaseTimer:
    """Accumulates wall-clock seconds per span path (a span may be entered
    many times, e.g. once per sequence). A span opened inside another is its
    child, with the path "<parent> / <name>"; paths are registered at first
    entry, so a parent comes before its children. Counts belong to the
    innermost open span."""

    def __init__(self):
        self._acc: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._open: list[str] = []
        self.records: list[SpanRecord] = []

    @contextmanager
    def phase(self, name: str):
        parent = self._open[-1] if self._open else None
        path = name if parent is None else parent + SEP + name
        self._acc.setdefault(path, 0.0)
        self._open.append(path)
        # record_function costs ~14 us a call even with no profiler
        # running, the check well under 1 us
        rng = torch.profiler.record_function(path) if torch.autograd._profiler_enabled() else nullcontext()
        t0 = time.perf_counter()
        try:
            with rng:
                yield
        finally:
            t1 = time.perf_counter()
            self._open.pop()
            self._acc[path] += t1 - t0
            self.records.append(SpanRecord(path, parent, t0, t1))

    def count(self, name: str, n: int):
        """Add n to the count `name` of the innermost open span."""
        key = self._open[-1] + SEP + name if self._open else name
        self._counts[key] = self._counts.get(key, 0) + int(n)

    @contextmanager
    def active(self, trace_dir: str | None = None, device=None):
        """This timer as the current one, and the block traced by
        maybe_trace; both undone on exit, also when the block raises."""
        token = _CURRENT.set(self)
        try:
            with maybe_trace(trace_dir, device):
                yield self
        finally:
            _CURRENT.reset(token)

    def add_to_info(self, info, level: int):
        """The "Per-phase timings" section at `level` (every span path, in
        order of first entry), then "Per-phase counts" (each
        "<span path> / <count name>")."""
        info.add(level, "Per-phase timings")
        for path, secs in self._acc.items():
            info.add(level + 1, path, "%.3f s", secs)
        info.add(level, "Per-phase counts")
        for key, n in self._counts.items():
            info.add(level + 1, key, "%i", n)


_CURRENT: ContextVar[PhaseTimer | None] = ContextVar("mindthegap_phase_timer", default=None)


def span(name: str):
    """A child span of the current timer's innermost open span; nothing
    without a current timer."""
    timer = _CURRENT.get()
    return nullcontext() if timer is None else timer.phase(name)


def count(name: str, n: int):
    """PhaseTimer.count on the current timer, if there is one."""
    timer = _CURRENT.get()
    if timer is not None:
        timer.count(name, n)


@contextmanager
def maybe_trace(trace_dir: str | None, device=None):
    """torch.profiler trace of the enclosed block when a directory is given:
    the host's torch operations and, on a CUDA device, the card's kernels and
    copies (CUPTI), exported as a Chrome trace to DIR/trace.json
    (DIR/trace.rank<r>.json in a run across processes)."""
    if not trace_dir:
        yield
        return
    import os

    from ..parallel import distributed as D

    on_cuda = device is not None and torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    name = "trace.json" if D.process_count() == 1 else f"trace.rank{D.process_index()}.json"
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if on_cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, name))
