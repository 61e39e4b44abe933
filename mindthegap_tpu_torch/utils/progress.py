"""Progress reporting (the GATB ProgressSynchro/IteratorListener equivalent,
reference src/FindBreakpoints.hpp:381-385, src/Filler.cpp:811-839)."""

from __future__ import annotations

import sys
import time


class Progress:
    def __init__(self, total: int, label: str, enabled: bool = True, stream=None):
        self.total = max(int(total), 1)
        self.label = label
        self.enabled = enabled
        self.stream = stream or sys.stderr
        self.done = 0
        self._last_pct = -1
        self._t0 = time.time()
        if enabled:
            self._render()

    def inc(self, n: int = 1):
        self.done += n
        if not self.enabled:
            return
        pct = min(100, (100 * self.done) // self.total)
        if pct != self._last_pct:
            self._last_pct = pct
            self._render()

    def _render(self):
        pct = min(100, (100 * self.done) // self.total)
        self.stream.write("\r[%s]  %3d %%   elapsed: %5.1f s" % (self.label, pct, time.time() - self._t0))
        self.stream.flush()

    def finish(self):
        if self.enabled:
            self.done = self.total
            self._last_pct = -1
            self._render()
            self.stream.write("\n")
            self.stream.flush()
