"""RSS memory profiling (counterpart of ``torchsnapshot_tpu/rss_profiler.py``).

The JAX package reads RSS through psutil, which the GPU host lacks; this
module reads ``VmRSS`` from ``/proc/self/status``.

- :func:`measure_rss_deltas` samples RSS deltas on a thread at a fixed
  interval (a benchmark's context manager).
- :class:`RSSWatermark` tracks one operation's RSS high-water mark
  incrementally: no thread of its own, the caller samples it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Generator, List


def rss_bytes() -> int:
    """This process's resident set size, from ``/proc/self/status``."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS line")


class RSSWatermark:
    """Incremental RSS high-water tracking for one operation.

    ``sample()`` is one /proc read and safe from any thread; the watermark
    is monotone, and a tracker that never samples still reports its
    construction-time RSS.
    """

    __slots__ = ("baseline", "high_water")

    def __init__(self) -> None:
        try:
            rss = rss_bytes()
        except (OSError, RuntimeError, ValueError):
            rss = 0
        self.baseline = rss
        self.high_water = rss

    def sample(self) -> int:
        """Take one RSS sample; returns the current RSS and raises the
        watermark if exceeded.  Never raises (profiling must not break the
        pipeline)."""
        try:
            rss = rss_bytes()
        except (OSError, RuntimeError, ValueError):
            return self.high_water
        if rss > self.high_water:
            self.high_water = rss
        return rss

    @property
    def delta(self) -> int:
        """High-water minus baseline: the operation's peak RSS growth."""
        return self.high_water - self.baseline


@contextmanager
def measure_rss_deltas(
    rss_deltas: List[int], interval_ms: float = 100.0
) -> Generator[None, None, None]:
    baseline = rss_bytes()
    stop = threading.Event()

    def sample() -> None:
        while not stop.is_set():
            rss_deltas.append(rss_bytes() - baseline)
            stop.wait(interval_ms / 1000.0)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()
        rss_deltas.append(rss_bytes() - baseline)
