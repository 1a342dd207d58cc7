"""Fault-tolerance utilities: graceful shutdown, bounded retry, straggler
detection, and failure injection for tests.

On a real multi-pod deployment these hook the cluster manager (preemption
notices arrive as SIGTERM; stragglers feed back into the scheduler).  The
mechanisms themselves — checkpoint-on-signal, retry-from-latest-good,
per-step timing surveillance — are fully exercised here on CPU.

Pure stdlib; the JAX package has the same module, and the port keeps this
copy so that it imports nothing of that package.  The fault channels are
the same: ``"ship.<dest>"``, ``"<replica>.apply"`` and ``"primary.rotate"``.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import threading
import time
from typing import Callable, List, Optional

__all__ = ["GracefulShutdown", "retry", "StragglerDetector",
           "FailureInjector", "FaultPlan"]


class GracefulShutdown:
    """Installs SIGTERM/SIGINT handlers that flip a flag instead of dying.

    The train loop polls ``requested`` each step and checkpoints + exits
    cleanly — the standard preemption dance on managed clusters.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def request(self) -> None:  # for tests
        self._flag.set()


def retry(fn: Callable, retries: int = 3, backoff: float = 0.5,
          on_error: Optional[Callable] = None,
          retryable=(RuntimeError, OSError)):
    """Bounded retry with exponential backoff; ``on_error(attempt, exc)``
    runs before each retry (e.g. restore from the latest good checkpoint)."""
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            attempt += 1
            if attempt > retries:
                raise
            if on_error is not None:
                on_error(attempt, e)
            time.sleep(backoff * (2 ** (attempt - 1)))


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration: float
    mean: float
    std: float
    z: float


class StragglerDetector:
    """EWMA-based per-step timing surveillance.

    Flags steps slower than ``mean + z_thresh * std``.  At fleet scale the
    same statistic runs per-host on the synchronisation barrier wait time;
    flagged hosts get drained/replaced.  ``hot`` exposes whether mitigation
    (e.g. re-dispatch of that host's shard) should trigger.
    """

    def __init__(self, alpha: float = 0.1, z_thresh: float = 3.0,
                 warmup: int = 5, trip_count: int = 3):
        self.alpha = alpha
        self.z_thresh = z_thresh
        self.warmup = warmup
        self.trip_count = trip_count
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flags: List[StragglerReport] = []
        self._consecutive = 0

    def record(self, step: int, duration: float) -> Optional[StragglerReport]:
        self.n += 1
        if self.n <= self.warmup:
            # seed the statistics
            delta = duration - self.mean
            self.mean += delta / self.n
            self.var += delta * (duration - self.mean)
            return None
        std = math.sqrt(max(self.var / max(self.n - 1, 1), 1e-12))
        z = (duration - self.mean) / std if std > 0 else 0.0
        report = None
        if z > self.z_thresh:
            report = StragglerReport(step, duration, self.mean, std, z)
            self.flags.append(report)
            self._consecutive += 1
        else:
            self._consecutive = 0
        # EWMA update (skip extreme outliers so one straggler doesn't poison
        # the baseline)
        if z <= self.z_thresh * 2:
            self.mean = (1 - self.alpha) * self.mean + self.alpha * duration
            self.var = (1 - self.alpha) * self.var + self.alpha * (duration - self.mean) ** 2
        return report

    @property
    def hot(self) -> bool:
        return self._consecutive >= self.trip_count


class FailureInjector:
    """Deterministic failure injection for fault-tolerance tests."""

    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected failure at step {step}")


class FaultPlan(FailureInjector):
    """Deterministic multi-channel fault schedule (DESIGN.md §8.5).

    Generalises ``FailureInjector``'s step-indexed crashes to NAMED
    channels, each with its own auto-incrementing event counter, so one
    plan scripts an entire partial-failure scenario: shipped-frame drops
    and tears on the replication transport, replica crashes mid-apply,
    a primary kill mid-rotation — every injection keyed by (channel,
    event index) and therefore exactly reproducible.

    ``schedule`` maps ``channel -> {event_index: action}``.  Actions are
    strings or tuples, interpreted by the instrumented component:

    * transport send channels (``"ship.<replica>"``): ``"drop"``, ``"dup"``,
      ``"reorder"`` (hold one frame, release after the next), ``"tear"`` /
      ``("tear", keep_bytes)`` (deliver a truncated frame),
      ``("delay", n)`` (hold for n sends), ``"error"`` /
      ``("error", n)`` (raise ``TransportError`` n times — exercises
      retry+backoff);
    * apply channels (``"<replica>.apply"``): ``"crash"`` — the component
      calls ``crash_if`` and dies mid-apply;
    * rotation channel (``"primary.rotate"``): ``"crash"`` — primary dies
      mid-compaction-rotation, after the new epoch pair is published and
      before old WALs are deleted.

    Every consumed action lands in ``self.log`` and the per-action tallies
    in ``counts()`` — the observability surface the serving stats report.
    """

    def __init__(self, schedule=None, exc=RuntimeError):
        super().__init__((), exc)
        self.schedule = {str(c): dict(m) for c, m in (schedule or {}).items()}
        self.counters = {}
        self.log = []                    # [(channel, event_index, action)]

    def action(self, channel: str):
        """Consume one event on ``channel``; returns the scheduled action
        for this event index (logged), or None."""
        step = self.counters.get(channel, 0)
        self.counters[channel] = step + 1
        act = self.schedule.get(channel, {}).get(step)
        if act is not None:
            self.log.append((channel, step, act))
            self.fired.add((channel, step))
        return act

    def crash_if(self, channel: str) -> None:
        """Consume one event; raise ``exc`` when it is scheduled as a
        ``"crash"`` (the named-channel ``maybe_fail``)."""
        if self.action(channel) == "crash":
            raise self.exc(f"injected crash on {channel} "
                           f"(event {self.counters[channel] - 1})")

    def counts(self) -> dict:
        """{action_name: times_fired} over everything consumed so far."""
        out = {}
        for _, _, act in self.log:
            name = act[0] if isinstance(act, tuple) else act
            out[name] = out.get(name, 0) + 1
        return out
