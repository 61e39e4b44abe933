"""Per-phase wall-clock accounting (SURVEY.md §5.1).

The reference reports one coarse `Time` row (difftime around the core phase,
src/Finder.cpp:401-405). We keep that row byte-compatible and, with the
hidden `-profile` flag, add a per-phase breakdown beneath it. `-profile-trace`
(a jax.profiler trace in the JAX package) is not yet ported."""

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
def maybe_trace(trace_dir: str | None):
    """Raises when a trace directory is given: tracing is not yet ported."""
    if trace_dir:
        from .. import NotYetPorted

        raise NotYetPorted("-profile-trace")
    yield
