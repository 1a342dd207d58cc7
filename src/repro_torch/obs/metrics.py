"""Process-global metrics registry (DESIGN.md §10.1).

One source of truth for every ``stats()``/``describe()`` surface in the
tree: counters (monotonic), gauges (last-write-wins) and log-bucketed
histograms (p50/p90/p99/max without storing samples).  Families are
keyed by metric name; children by a tuple of label values (``backend``,
``shard``, ``epoch``, ``plane``, ...).  Everything is guarded by one
coarse lock — updates happen at wave/record granularity, never per row,
so contention is negligible (§10.4 overhead budget).

Zero dependencies beyond the standard library.  Exposition:

* ``registry.render_text()``   — Prometheus-style text format
* ``registry.snapshot()``      — nested JSON-serialisable dict
* ``parse_text_exposition()``  — inverse of ``render_text`` (CI gate)
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry", "parse_text_exposition",
]

# Log-spaced bucket boundaries shared by every histogram: 1µs .. ~4.6h in
# ×2 steps (44 finite buckets + overflow).  Observations are clamped into
# [0, +inf); quantiles interpolate linearly inside a bucket.
_HIST_BASE = 1e-6
_HIST_GROWTH = 2.0
_HIST_BUCKETS = 44
_BOUNDS = tuple(_HIST_BASE * _HIST_GROWTH ** i for i in range(_HIST_BUCKETS))


def _label_key(labelnames: Tuple[str, ...], labels: Dict[str, object]) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[k]) for k in labelnames)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Family:
    """Base: a named metric family with fixed label names and one child
    per observed label-value combination."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = lock
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child(self, labels: Dict[str, object]):
        key = _label_key(self.labelnames, labels)
        child = self._children.get(key)
        if child is None:
            child = self._make_child()
            self._children[key] = child
        return child

    def labelsets(self) -> List[Tuple[str, ...]]:
        with self._lock:
            return sorted(self._children)


class Counter(_Family):
    """Monotonically increasing count (resets only via ``registry.reset``)."""

    kind = "counter"

    def _make_child(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._child(labels)[0] += amount

    def value(self, **labels) -> float:
        with self._lock:
            key = _label_key(self.labelnames, labels)
            child = self._children.get(key)
            return child[0] if child is not None else 0.0

    def total(self) -> float:
        """Sum over every labelset (the unlabeled rollup)."""
        with self._lock:
            return sum(c[0] for c in self._children.values())


class Gauge(_Family):
    """Last-write-wins instantaneous value (``set``) with ``add`` for
    up/down counts (inflight queries, pinned epochs)."""

    kind = "gauge"

    def _make_child(self):
        return [0.0]

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._child(labels)[0] = float(value)

    def add(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._child(labels)[0] += amount

    def value(self, **labels) -> float:
        with self._lock:
            key = _label_key(self.labelnames, labels)
            child = self._children.get(key)
            return child[0] if child is not None else 0.0


class _HistChild:
    __slots__ = ("counts", "overflow", "count", "sum", "max")

    def __init__(self):
        self.counts = [0] * _HIST_BUCKETS
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.max = 0.0


class Histogram(_Family):
    """Log-bucketed (×2 from 1µs) distribution.  ``observe`` is O(1);
    ``quantile`` interpolates linearly inside the winning bucket, so
    p50/p90/p99 are exact to within one bucket's width (§10.1)."""

    kind = "histogram"

    def _make_child(self):
        return _HistChild()

    @staticmethod
    def bucket_index(value: float) -> int:
        """Index of the first bucket whose upper bound >= value (or
        ``_HIST_BUCKETS`` for overflow)."""
        if value <= _HIST_BASE:
            return 0
        i = int(math.ceil(math.log(value / _HIST_BASE, _HIST_GROWTH) - 1e-12))
        return min(i, _HIST_BUCKETS)

    def observe(self, value: float, **labels) -> None:
        v = max(float(value), 0.0)
        with self._lock:
            c = self._child(labels)
            i = self.bucket_index(v)
            if i >= _HIST_BUCKETS:
                c.overflow += 1
            else:
                c.counts[i] += 1
            c.count += 1
            c.sum += v
            if v > c.max:
                c.max = v

    # -- reads ---------------------------------------------------------- #
    def _merged(self, labels: Optional[Dict[str, object]]) -> _HistChild:
        """One child, or the sum over all labelsets when ``labels=None``."""
        if labels is not None:
            key = _label_key(self.labelnames, labels)
            return self._children.get(key) or _HistChild()
        out = _HistChild()
        for c in self._children.values():
            out.counts = [a + b for a, b in zip(out.counts, c.counts)]
            out.overflow += c.overflow
            out.count += c.count
            out.sum += c.sum
            out.max = max(out.max, c.max)
        return out

    def quantile(self, q: float, **labels) -> float:
        with self._lock:
            c = self._merged(labels or None)
            if c.count == 0:
                return 0.0
            rank = q * c.count
            seen = 0.0
            for i, n in enumerate(c.counts):
                if n == 0:
                    continue
                if seen + n >= rank:
                    lo = 0.0 if i == 0 else _BOUNDS[i - 1]
                    hi = min(_BOUNDS[i], c.max)
                    frac = (rank - seen) / n
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                seen += n
            return c.max

    def summary(self, **labels) -> Dict[str, float]:
        """{count, sum, mean, p50, p90, p99, max} for one labelset (or the
        all-labelset rollup with no labels)."""
        with self._lock:
            c = self._merged(labels or None)
        if c.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0, "max": 0.0}
        out = {"count": c.count, "sum": c.sum,
               "mean": c.sum / c.count, "max": c.max}
        for q, k in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            out[k] = self.quantile(q, **labels)
        return out


class MetricsRegistry:
    """Container of metric families.  ``counter``/``gauge``/``histogram``
    get-or-create by name (re-declaration with different labelnames or a
    different kind is an error — ONE schema per name across the tree)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- declaration ---------------------------------------------------- #
    def _get(self, cls, name: str, help: str, labelnames: Iterable[str]):
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, labelnames, self._lock)
                self._families[name] = fam
                return fam
        if not isinstance(fam, cls):
            raise ValueError(f"{name} already declared as {fam.kind}")
        if fam.labelnames != labelnames:
            raise ValueError(
                f"{name} labelnames {fam.labelnames} != {labelnames}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = ()) -> Histogram:
        return self._get(Histogram, name, help, labelnames)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # -- exposition ----------------------------------------------------- #
    def snapshot(self) -> dict:
        """Nested JSON-serialisable dump: {name: {kind, help, series:
        [{labels, value | summary}]}}."""
        out: dict = {}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            series = []
            for key in fam.labelsets():
                labels = dict(zip(fam.labelnames, key))
                if isinstance(fam, Histogram):
                    series.append({"labels": labels,
                                   "summary": fam.summary(**labels)})
                else:
                    series.append({"labels": labels,
                                   "value": fam.value(**labels)})
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def render_text(self) -> str:
        """Prometheus-style text exposition.  Histograms render as a
        summary: ``<name>{...,quantile="0.5"}``, ``<name>_sum``,
        ``<name>_count``, ``<name>_max``."""
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            lines.append(f"# HELP {fam.name} {fam.help}")
            kind = "summary" if isinstance(fam, Histogram) else fam.kind
            lines.append(f"# TYPE {fam.name} {kind}")
            for key in fam.labelsets():
                labels = dict(zip(fam.labelnames, key))
                base = ",".join(f'{k}="{_escape(v)}"'
                                for k, v in zip(fam.labelnames, key))
                if isinstance(fam, Histogram):
                    s = fam.summary(**labels)
                    for q, k in (("0.5", "p50"), ("0.9", "p90"),
                                 ("0.99", "p99")):
                        ql = (base + "," if base else "") + f'quantile="{q}"'
                        lines.append(f"{fam.name}{{{ql}}} {s[k]:.9g}")
                    suff = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}_sum{suff} {s['sum']:.9g}")
                    lines.append(f"{fam.name}_count{suff} {s['count']}")
                    lines.append(f"{fam.name}_max{suff} {s['max']:.9g}")
                else:
                    suff = f"{{{base}}}" if base else ""
                    v = fam.value(**labels)
                    lines.append(f"{fam.name}{suff} {v:.9g}")
        return "\n".join(lines) + "\n"


def parse_text_exposition(text: str) -> Dict[str, dict]:
    """Parse ``render_text`` output back into ``{name: {type, help,
    samples: [(labels_dict, value)]}}``.  Used by the CI smoke gate to
    prove the exposition round-trips; raises ValueError on malformed
    lines."""
    out: Dict[str, dict] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            out.setdefault(name, {"help": "", "type": "untyped",
                                  "samples": []})["help"] = help_
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            out.setdefault(name, {"help": "", "type": "untyped",
                                  "samples": []})["type"] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        # sample: name{l="v",...} value   |   name value
        brace = line.find("{")
        if brace >= 0:
            name = line[:brace]
            close = line.rfind("}")
            if close < brace:
                raise ValueError(f"malformed sample line: {line!r}")
            body, valstr = line[brace + 1:close], line[close + 1:].strip()
            labels: Dict[str, str] = {}
            i = 0
            while i < len(body):
                eq = body.index("=", i)
                k = body[i:eq]
                if body[eq + 1] != '"':
                    raise ValueError(f"malformed labels: {line!r}")
                j = eq + 2
                val = []
                while body[j] != '"':
                    if body[j] == "\\":
                        j += 1
                        val.append({"\\": "\\", '"': '"', "n": "\n"}[body[j]])
                    else:
                        val.append(body[j])
                    j += 1
                labels[k] = "".join(val)
                i = j + 1
                if i < len(body) and body[i] == ",":
                    i += 1
        else:
            name, _, valstr = line.partition(" ")
            labels = {}
        try:
            value = float(valstr)
        except ValueError:
            raise ValueError(f"malformed value in: {line!r}")
        root = name
        for suffix in ("_sum", "_count", "_max"):
            if name.endswith(suffix) and name[:-len(suffix)] in out:
                root = name[:-len(suffix)]
        out.setdefault(root, {"help": "", "type": "untyped", "samples": []})
        out[root]["samples"].append((name, labels, value))
    return out


# ---------------------------------------------------------------------- #
# Process-global default registry.  Import-time singleton: every plane
# records here unless a test swaps it out with ``set_registry``.
# ---------------------------------------------------------------------- #
_global = MetricsRegistry()
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    return _global


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev, _global = _global, registry
    return prev
