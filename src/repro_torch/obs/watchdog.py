"""Serving-pause watchdog (DESIGN.md §10.3).

The mixed-write bench gates ``pause_max <= 5x median wave gap``
offline; this makes that signal live and always-on.  ``wave_done()`` is
called once per completed wave (``QueryServer._finish_wave``); the
watchdog keeps a trailing window of completion timestamps and, when the
gap since the previous completion exceeds ``factor`` × the trailing
median gap, increments ``serving_pause_total{culprit=...}`` in the
metrics registry and fires the optional callback.

The *culprit* is attributed from the tracer ring: the background span
(``compact.*``, ``wal.*``, ``ship.*``, ``replica.*``, ``failover.*``)
with the largest time overlap with the gap window — i.e. "this pause
was a compaction install / a WAL fsync / a ship retry", attached to the
counter label and the callback.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional

from .metrics import MetricsRegistry, get_registry
from .trace import Tracer

__all__ = ["PauseWatchdog"]

_BACKGROUND_PREFIXES = ("compact.", "wal.", "ship.", "replica.",
                        "failover.", "durability.")


class PauseWatchdog:
    """Trailing-median gap monitor over wave completions.

    Parameters
    ----------
    factor : pause threshold as a multiple of the trailing median gap
        (the mixed-write bench gate uses 5x at r=0.5).
    window : completions kept for the median estimate.
    min_samples : completions required before pauses are judged (the
        first waves of a cold server always straggle).
    min_gap_s : gaps below this are never pauses regardless of the
        median (guards the microsecond-median regime where scheduler
        jitter alone exceeds ``factor``×).
    callback : ``f(gap_s, median_s, culprit)`` with ``culprit`` a
        finished-span dict or None.
    """

    def __init__(self, factor: float = 5.0, window: int = 64,
                 min_samples: int = 8, min_gap_s: float = 1e-4,
                 tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 callback: Optional[Callable] = None):
        self.factor = float(factor)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.min_gap_s = float(min_gap_s)
        self.tracer = tracer
        self.registry = registry
        self.callback = callback
        self._gaps: deque = deque(maxlen=self.window)
        self._last: Optional[float] = None
        self.pauses: List[dict] = []          # bounded: last 64 judgments
        self.pause_count = 0

    def _median(self) -> float:
        if not self._gaps:
            return 0.0
        s = sorted(self._gaps)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def _tracer_now(self) -> Optional[Tracer]:
        """Pinned tracer, else whatever global tracer is installed at
        judgment time (tracing may be enabled after the server starts)."""
        if self.tracer is not None:
            return self.tracer
        from . import tracer as _global
        return _global()

    def _culprit(self, gap_start: float, gap_end: float) -> Optional[dict]:
        """Background span in the tracer ring with max overlap with the
        gap window."""
        tr = self._tracer_now()
        if tr is None:
            return None
        best, best_ov = None, 0.0
        for e in tr.events():
            if not e["name"].startswith(_BACKGROUND_PREFIXES):
                continue
            t1 = e["t1"] if e["t1"] is not None else gap_end
            ov = min(t1, gap_end) - max(e["t0"], gap_start)
            if ov > best_ov:
                best, best_ov = e, ov
        # an open background span (mid-install) also counts
        for e in tr.open_spans():
            if not e["name"].startswith(_BACKGROUND_PREFIXES):
                continue
            ov = gap_end - max(e["t0"], gap_start)
            if ov > best_ov:
                best, best_ov = e, ov
        return best

    def wave_done(self, now: Optional[float] = None) -> Optional[dict]:
        """Record one wave completion; returns the pause record when the
        gap since the previous completion breached the threshold, else
        None."""
        now = time.perf_counter() if now is None else now
        last, self._last = self._last, now
        if last is None:
            return None
        gap = now - last
        med = self._median()
        self._gaps.append(gap)
        if (len(self._gaps) <= self.min_samples or med <= 0.0
                or gap < self.min_gap_s or gap <= self.factor * med):
            return None
        culprit = self._culprit(last, now)
        label = culprit["name"] if culprit else "unknown"
        reg = self.registry if self.registry is not None else get_registry()
        reg.counter("serving_pause_total",
                    "wave-completion gaps exceeding factor x trailing median",
                    ("culprit",)).inc(culprit=label)
        rec = {"gap_s": gap, "median_s": med, "factor": gap / med,
               "culprit": culprit}
        self.pause_count += 1
        self.pauses.append(rec)
        if len(self.pauses) > 64:
            del self.pauses[0]
        if self.callback is not None:
            try:
                self.callback(gap, med, culprit)
            except Exception:
                pass
        return rec

    def describe(self) -> dict:
        return {"pauses": self.pause_count, "median_gap_s": self._median(),
                "window": len(self._gaps), "factor": self.factor,
                "last_culprit": (self.pauses[-1]["culprit"]["name"]
                                 if self.pauses and self.pauses[-1]["culprit"]
                                 else None)}
