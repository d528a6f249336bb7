"""Fault tolerance (port of ``repro.train.fault``): restart supervision,
preemption handling and per-step wall-time telemetry.

* **Preemption**: SIGTERM/SIGINT set a flag (:class:`PreemptionGuard`); the
  solve polls it between segments, writes one synchronous checkpoint and
  stops. The checkpoint's atomic tmp→rename protocol means a kill during the
  save leaves the previous checkpoint authoritative.
* **Node failure**: :func:`run_with_restarts` is the in-process stand-in for
  a scheduler's restart: every attempt re-enters the body, which restores
  the newest complete checkpoint.
* **Stragglers**: :class:`StepTimer` keeps rolling per-step wall times.

Plain Python: nothing here touches torch.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional


class PreemptionGuard:
    """SIGTERM/SIGINT → request a final checkpoint and a clean exit."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


class StepTimer:
    """Rolling per-step wall-time stats (straggler telemetry)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.monotonic()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def p_max(self) -> float:
        return max(self.times) if self.times else 0.0

    def straggling(self, factor: float = 2.0) -> bool:
        """Last step took `factor`x the rolling mean → candidate for drain."""
        return bool(self.times) and self.times[-1] > factor * max(self.mean, 1e-9)


def run_with_restarts(body: Callable[[int], object], max_restarts: int = 3,
                      retry_on: tuple = (RuntimeError,), *,
                      backoff: float = 0.0, backoff_factor: float = 2.0,
                      max_backoff: float = 30.0,
                      sleep: Callable[[float], None] = time.sleep):
    """Supervise ``body(attempt)``; re-enter on failure (the in-process stand-in
    for scheduler-level worker restarts). Returns body's result.

    ``backoff`` seconds before the first retry, multiplied by
    ``backoff_factor`` each subsequent retry and capped at ``max_backoff`` —
    a crash-looping worker (bad node, poisoned input) should not hot-spin
    through its restart budget. ``sleep`` is injectable for tests.
    """
    attempt = 0
    delay = backoff
    while True:
        try:
            return body(attempt)
        except retry_on:
            attempt += 1
            if attempt > max_restarts:
                raise
            if delay > 0:
                sleep(min(delay, max_backoff))
                delay = min(delay * backoff_factor, max_backoff)
