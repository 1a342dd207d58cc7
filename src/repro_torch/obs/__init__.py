"""Unified telemetry plane (DESIGN.md §10).

Three layers, zero dependencies:

1. **Metrics registry** (`metrics.py`) — process-global counters,
   gauges and log-bucketed histograms with labeled families; every
   ``stats()``/``describe()`` surface in the tree reads from it.
   Always on: registry updates happen at wave/record granularity and
   fit the §10.4 overhead budget (≤5% QPS, CI-gated).
2. **Span tracing** (`trace.py`) — opt-in (``obs.enable_tracing()``);
   when no tracer is installed every ``obs.span(...)`` site is a
   cheap no-op, which is how the telemetry-off path stays at zero
   overhead beyond the registry.
3. **Profiling hooks** (`profile.py`) — ``obs.profile(logdir)`` gates
   ``torch.profiler`` capture around device waves.

`watchdog.py` builds the serving-pause monitor on layers 1+2.
"""
from __future__ import annotations

import time
from typing import Optional, Union

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry, parse_text_exposition, set_registry)
from .profile import profile
from .trace import Span, Tracer
from .watchdog import PauseWatchdog

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "PauseWatchdog",
    "Span", "Tracer", "disable_tracing", "enable_tracing", "get_registry",
    "metrics", "parse_text_exposition", "profile", "set_registry",
    "set_tracer", "span", "stage_timer", "tracer",
]

# -------------------------------------------------------------------- #
# Global tracer: None (the default) means every span site no-ops.
# -------------------------------------------------------------------- #
_tracer: Optional[Tracer] = None


def tracer() -> Optional[Tracer]:
    """The installed global tracer, or None when tracing is off."""
    return _tracer


def set_tracer(t: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or remove, with None) the global tracer; returns the
    previous one."""
    global _tracer
    prev, _tracer = _tracer, t
    return prev


def enable_tracing(capacity: int = 8192) -> Tracer:
    """Install a fresh global ring-buffered tracer and return it."""
    t = Tracer(capacity=capacity)
    set_tracer(t)
    return t


def disable_tracing() -> Optional[Tracer]:
    """Remove the global tracer (span sites become no-ops again)."""
    return set_tracer(None)


def metrics() -> MetricsRegistry:
    """The process-global metrics registry (alias of ``get_registry``)."""
    return get_registry()


class _NullCtx:
    """No-tracer fallback for ``obs.span``: zero-allocation enter/exit,
    yields None so call sites can pass the result as a parent safely
    (``parent=None`` means implicit parenting downstream)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


def span(name: str, parent: Union[Span, int, None] = None, **args):
    """Context manager recording a span on the global tracer — or a
    no-op when tracing is off.  Yields the ``Span`` (or None)."""
    t = _tracer
    if t is None:
        return _NULL_CTX
    return t.span(name, parent, **args)


# -------------------------------------------------------------------- #
# Per-stage timing (§10.1): ONE histogram family shared by every plane
# so the bench's per-stage breakdown reads from a single place.
# stages: probe | search | filter | merge | delta_scan | cache_route |
#         cache_admit | dispatch | transfer | flush | fsync
# -------------------------------------------------------------------- #
def stage_hist() -> Histogram:
    return get_registry().histogram(
        "coax_stage_seconds",
        "per-pipeline-stage wall time (DESIGN.md §10.1)",
        ("stage", "backend"))


class _StageTimer:
    """Always-on stage timer: one ``perf_counter`` pair + one histogram
    observe per stage per wave (the §10.4 overhead budget)."""
    __slots__ = ("stage", "backend", "_t0")

    def __init__(self, stage: str, backend: str):
        self.stage = stage
        self.backend = backend

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        stage_hist().observe(time.perf_counter() - self._t0,
                             stage=self.stage, backend=self.backend)
        return False


def stage_timer(stage: str, backend: str = "numpy") -> _StageTimer:
    return _StageTimer(stage, backend)
