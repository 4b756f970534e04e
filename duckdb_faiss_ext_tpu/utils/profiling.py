"""Tracing, timing, and engine statistics.

The reference has no tracing/metrics at all (SURVEY.md §5: benchmarks time
whole queries only); this is the rebuild's observability tier:

* ``trace(path)`` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable device trace of everything inside;
* ``timed(op)`` — lightweight per-op wall-clock accumulation into the
  process-global ``STATS`` registry (search/add/train counts and latencies);
* ``stats()`` / ``reset_stats()`` — snapshot/clear, and the per-index
  ``faiss_stats`` analogue is exposed through api-level counters.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class _OpStats:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    def as_dict(self):
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_ms": round(1e3 * self.total_s / self.count, 3)
            if self.count else 0.0,
            "max_ms": round(1e3 * self.max_s, 3),
        }


_lock = threading.Lock()
_stats: dict[str, _OpStats] = defaultdict(_OpStats)


@contextlib.contextmanager
def timed(op: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _stats[op].add(dt)


def stats() -> dict:
    with _lock:
        return {k: v.as_dict() for k, v in sorted(_stats.items())}


def reset_stats() -> None:
    with _lock:
        _stats.clear()


@contextlib.contextmanager
def trace(path: str):
    """Capture a jax.profiler device trace (view with TensorBoard or xprof)."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
