"""Fault-tolerance monitors for the training loop (the port's copy of
``repro.ft.monitor``; pure Python).

``StragglerMonitor`` — per-step wall-time EMA with kσ outlier detection.
Step time is a collective property on a cluster (the slowest worker gates
everyone), so a persistent outlier means a straggling worker or a
degraded link; the loop's policy hook decides what to do (log, or
checkpoint). Tests drive it with a simulated clock.

``HeartbeatTracker`` — liveness bookkeeping for N workers. A worker missing
``timeout_s`` of heartbeats is dead; the elastic planner
(``ft/elastic.plan_remesh``) takes the survivors' count.

``PreemptionGuard`` — converts SIGTERM/SIGINT into a polled flag so the
training loop can finish its step, write a final checkpoint, and exit
cleanly.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class StragglerMonitor:
    """EMA + variance tracker over step wall-times; flags >kσ outliers."""
    alpha: float = 0.1          # EMA weight of the newest sample
    k_sigma: float = 4.0        # outlier threshold
    warmup_steps: int = 8       # ignore compile/first-touch noise
    min_sigma_frac: float = 0.02  # σ floor as a fraction of the mean

    _mean: float = field(default=0.0, init=False)
    _var: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)
    _flags: list = field(default_factory=list, init=False)

    def observe(self, step: int, dt_s: float) -> bool:
        """Record one step time. Returns True when flagged as straggler."""
        self._n += 1
        if self._n <= self.warmup_steps:
            # prime the EMA without flagging
            if self._n == 1:
                self._mean = dt_s
            else:
                self._mean += self.alpha * (dt_s - self._mean)
            return False
        sigma = max(self._var ** 0.5, self.min_sigma_frac * max(self._mean, 1e-12))
        is_outlier = dt_s > self._mean + self.k_sigma * sigma
        if is_outlier:
            self._flags.append((step, dt_s, self._mean, sigma))
        else:
            # update statistics from non-outlier samples only, so a stuck
            # host does not inflate the baseline it is measured against
            delta = dt_s - self._mean
            self._mean += self.alpha * delta
            self._var = (1 - self.alpha) * (self._var + self.alpha * delta * delta)
        return is_outlier

    @property
    def mean_s(self) -> float:
        return self._mean

    @property
    def sigma_s(self) -> float:
        return self._var ** 0.5

    @property
    def flags(self) -> list:
        return list(self._flags)

    def consecutive_flags(self, window: int = 3) -> bool:
        """True when the last `window` observed steps were all flagged."""
        if len(self._flags) < window:
            return False
        steps = [f[0] for f in self._flags[-window:]]
        return steps == list(range(steps[0], steps[0] + window))


@dataclass
class HeartbeatTracker:
    """Last-seen bookkeeping for worker liveness (simulated clock in tests)."""
    n_workers: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self._last_seen = {w: now for w in range(self.n_workers)}

    def beat(self, worker: int) -> None:
        self._last_seen[worker] = self.clock()

    def dead(self) -> list[int]:
        now = self.clock()
        return sorted(w for w, t in self._last_seen.items()
                      if now - t > self.timeout_s)

    def alive(self) -> list[int]:
        dead = set(self.dead())
        return [w for w in range(self.n_workers) if w not in dead]


class PreemptionGuard:
    """SIGTERM/SIGINT → polled flag. Use as a context manager around the
    training loop; inside, check ``guard.preempted`` once per step."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._previous: dict = {}
        self._preempted = False

    def __enter__(self):
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        return False

    def _handler(self, signum, frame):
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def trigger(self) -> None:
        """Test hook: simulate a maintenance event."""
        self._preempted = True
