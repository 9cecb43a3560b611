"""Tracing / profiling / stats — the observability subsystem.

The reference has none of this (SURVEY.md §5: no logging calls, no
counters, no timings anywhere in /root/reference/src/pyskani/_skani/*.rs;
the skani crate only links `log` + `simple-logging`).  This module adds
the device-side equivalents:

* ``scope(name)`` — a context manager that opens a ``jax.profiler``
  TraceAnnotation (visible in XLA/TensorBoard traces) *and* records
  wall-clock into the process-wide :class:`Stats` registry;
* ``Stats`` — cheap counters/timers (screen pass-rate, pairs chained,
  Mbp sketched) that the Database/engine update when profiling is
  enabled;
* ``start_trace(logdir)`` / ``stop_trace()`` — thin wrappers over
  ``jax.profiler`` for full device traces.

Everything is a no-op unless enabled (``enable()`` or the
``PYSKANI_TPU_PROFILE=1`` environment variable) so the hot path carries
no overhead by default.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["enable", "disable", "enabled", "scope", "stats", "reset_stats",
           "start_trace", "stop_trace", "Stats"]

_enabled = bool(int(os.environ.get("PYSKANI_TPU_PROFILE", "0")))
_lock = threading.Lock()


@dataclass
class Stats:
    """Process-wide counters and phase timers."""

    counters: Dict[str, float] = field(default_factory=dict)
    timers: Dict[str, float] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)

    def add(self, name: str, value: float = 1.0) -> None:
        with _lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def time(self, name: str, seconds: float) -> None:
        with _lock:
            self.timers[name] = self.timers.get(name, 0.0) + seconds
            self.calls[name] = self.calls.get(name, 0) + 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with _lock:
            out = {
                "counters": dict(self.counters),
                "timers_s": dict(self.timers),
                "calls": dict(self.calls),
            }
        # derived rates
        t_chain = out["timers_s"].get("chain", 0.0)
        pairs = out["counters"].get("pairs_chained", 0.0)
        if t_chain > 0 and pairs:
            out["counters"]["pairs_per_s"] = pairs / t_chain
        t_sketch = out["timers_s"].get("sketch", 0.0)
        bp = out["counters"].get("bases_sketched", 0.0)
        if t_sketch > 0 and bp:
            out["counters"]["sketch_mbp_per_s"] = bp / 1e6 / t_sketch
        screened = out["counters"].get("refs_screened", 0.0)
        passed = out["counters"].get("screen_passed", 0.0)
        if screened:
            out["counters"]["screen_pass_rate"] = passed / screened
        return out


_stats = Stats()


def stats() -> Stats:
    return _stats


def reset_stats() -> None:
    global _stats
    _stats = Stats()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def scope(name: str):
    """Named profiling scope: jax.profiler annotation + wall timer.

    No-op (zero device sync, zero allocation beyond the generator) when
    profiling is disabled.
    """
    if not _enabled:
        yield
        return
    import jax

    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(f"pyskani_tpu/{name}"):
        try:
            yield
        finally:
            _stats.time(name, time.perf_counter() - t0)


def start_trace(logdir: str) -> None:
    """Start a full device trace (view with TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    import jax

    jax.profiler.stop_trace()
