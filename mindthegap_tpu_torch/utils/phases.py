"""Per-phase wall-clock accounting (SURVEY.md §5.1).

The reference reports one coarse `Time` row (difftime around the core phase,
src/Finder.cpp:401-405). We keep that row byte-compatible and, with the
hidden `-profile` flag, add a per-phase breakdown beneath it; `-profile-trace
DIR` additionally captures a torch.profiler trace of the run (Chrome trace
format; the JAX package writes a jax.profiler trace instead)."""

from __future__ import annotations

import time
from contextlib import contextmanager


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase (a phase may be
    entered many times, e.g. once per sequence)."""

    def __init__(self):
        self._acc: dict[str, float] = {}
        self._order: list[str] = []

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self._acc:
                self._acc[name] = 0.0
                self._order.append(name)
            self._acc[name] += dt

    def items(self):
        return [(name, self._acc[name]) for name in self._order]

    def add_to_info(self, info, level: int):
        for name, secs in self.items():
            info.add(level, name, "%.2f s", secs)


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

    import torch

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
