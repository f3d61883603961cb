"""Throttled progress reporting (CdProgression equivalent,
reference src/LibHLA.cpp:198-269: percent lines at >=15 s intervals)."""

from __future__ import annotations

import sys
import time


class Progress:
    """Prints '<info>    <pct>%, ETA ...' at most every `interval` seconds."""

    def __init__(self, total: int, info: str = "", interval: float = 15.0,
                 enabled: bool = True, stream=None):
        self.total = max(int(total), 1)
        self.info = info
        self.interval = interval
        self.enabled = enabled
        self.stream = stream or sys.stderr
        self.count = 0
        self.start = time.time()
        self._last = self.start

    def forward(self, k: int = 1) -> None:
        self.count += k
        now = time.time()
        if not self.enabled:
            return
        if now - self._last >= self.interval or self.count >= self.total:
            self._last = now
            pct = 100.0 * self.count / self.total
            elapsed = now - self.start
            eta = elapsed / max(self.count, 1) * (self.total - self.count)
            self.stream.write(
                f"{self.info}\t{pct:.1f}%, ETA: {_fmt(eta)}\n")
            self.stream.flush()

    def done(self) -> None:
        if self.enabled and self.count < self.total:
            self.count = self.total
            self.forward(0)


def _fmt(seconds: float) -> str:
    s = int(seconds)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    if h:
        return f"{h}h {m:02d}m {s:02d}s"
    if m:
        return f"{m}m {s:02d}s"
    return f"{s}s"
