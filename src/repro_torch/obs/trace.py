"""Span tracing (DESIGN.md §10.2).

A ``Tracer`` records *spans* — named `(t0, t1)` intervals on the
monotonic clock with an explicit parent id — into a bounded ring, so a
long-running ``QueryServer`` holds the trailing window only.  Parenting
is implicit through a thread-local stack (a span opened inside another
on the same thread becomes its child) with an explicit ``parent=``
override for the two places that legitimately cross that model:

* the executor's pipelined submit/collect, where wave *k*'s collect
  runs while wave *k+1*'s submit is already on the stack — collect-side
  spans pass wave *k*'s span explicitly so they never adopt *k+1*;
* background threads (compactor build, replication pump), which carry
  the spawning span across the thread boundary.

Export: ``events()`` (finished-span dicts), ``dump_jsonl``, and
``to_chrome()`` — Chrome ``trace_event`` JSON that ``chrome://tracing``
/ Perfetto opens as a wave timeline.  ``validate()`` is the CI gate:
every span closed, parents precede children, wave spans cover their
dispatch spans.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

__all__ = ["Span", "Tracer"]


class Span:
    """One open (then finished) interval.  Use via ``tracer.span(...)``
    as a context manager, or ``start``/``finish`` for intervals whose
    ends live in different call frames (submit vs collect)."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "args", "tid")

    def __init__(self, name: str, id: int, parent: Optional[int],
                 t0: float, tid: int, args: Dict[str, object]):
        self.name = name
        self.id = id
        self.parent = parent
        self.t0 = t0
        self.t1: Optional[float] = None
        self.args = args
        self.tid = tid

    def to_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "t0": self.t0, "t1": self.t1, "tid": self.tid,
                "args": self.args}


class Tracer:
    """Thread-safe bounded-ring span recorder on ``time.perf_counter``."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._ids = itertools.count(1)
        self._open: Dict[int, Span] = {}
        self._lock = threading.Lock()
        self._stack = threading.local()
        self.dropped = 0            # spans evicted from the ring

    # -- recording ------------------------------------------------------ #
    def _stack_list(self) -> List[Span]:
        st = getattr(self._stack, "spans", None)
        if st is None:
            st = self._stack.spans = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack_list()
        return st[-1] if st else None

    def start(self, name: str,
              parent: Union[Span, int, None] = None, **args) -> Span:
        """Open a span.  ``parent`` defaults to the innermost span open
        on THIS thread; pass a ``Span``/id explicitly to pin the parent
        across the pipelined submit/collect seam or a thread boundary
        (see module docstring).  The caller must ``finish`` it; started
        spans do NOT join the thread-local stack (context-manager spans
        do)."""
        if parent is None:
            cur = self.current()
            pid = cur.id if cur is not None else None
        else:
            pid = parent.id if isinstance(parent, Span) else int(parent)
        sp = Span(name, next(self._ids), pid, time.perf_counter(),
                  threading.get_ident(), args)
        with self._lock:
            self._open[sp.id] = sp
        return sp

    def finish(self, span: Span, **args) -> Span:
        span.t1 = time.perf_counter()
        if args:
            span.args.update(args)
        # a span finished on a different thread than it started (the
        # §10.2 thread-boundary handoff) takes the finishing thread's
        # lane: that is where the work ran, and validate() uses the tid
        # mismatch to exempt it from same-thread parent containment
        span.tid = threading.get_ident()
        with self._lock:
            self._open.pop(span.id, None)
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(span)
        return span

    class _Ctx:
        __slots__ = ("_tracer", "_span", "_push")

        def __init__(self, tracer: "Tracer", span: Span, push: bool):
            self._tracer = tracer
            self._span = span
            self._push = push

        def __enter__(self) -> Span:
            if self._push:
                self._tracer._stack_list().append(self._span)
            return self._span

        def __exit__(self, *exc) -> bool:
            if self._push:
                st = self._tracer._stack_list()
                if st and st[-1] is self._span:
                    st.pop()
                elif self._span in st:       # tolerate misnested exits
                    st.remove(self._span)
            self._tracer.finish(self._span)
            return False

    def span(self, name: str,
             parent: Union[Span, int, None] = None, **args) -> "_Ctx":
        """Context manager: records the span over the ``with`` body and
        makes it the implicit parent for nested spans on this thread."""
        return Tracer._Ctx(self, self.start(name, parent, **args), True)

    class _Attach:
        """Push an already-open span as the implicit parent for the
        ``with`` body WITHOUT finishing it on exit — the executor's
        pipelined collect re-attaches wave *k*'s span so drain-side
        children never adopt wave *k+1* (module docstring)."""
        __slots__ = ("_tracer", "_span")

        def __init__(self, tracer: "Tracer", span: Span):
            self._tracer = tracer
            self._span = span

        def __enter__(self) -> Span:
            self._tracer._stack_list().append(self._span)
            return self._span

        def __exit__(self, *exc) -> bool:
            st = self._tracer._stack_list()
            if st and st[-1] is self._span:
                st.pop()
            elif self._span in st:
                st.remove(self._span)
            return False

    def attach(self, span: Span) -> "_Attach":
        return Tracer._Attach(self, span)

    # -- reads / export ------------------------------------------------- #
    def events(self) -> List[dict]:
        with self._lock:
            return [s.to_dict() for s in self._ring]

    def open_spans(self) -> List[dict]:
        with self._lock:
            return [s.to_dict() for s in self._open.values()]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self.dropped = 0

    def dump_jsonl(self, path: str) -> int:
        evs = self.events()
        with open(path, "w") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")
        return len(evs)

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` format: one complete ("ph": "X") event
        per finished span, µs timescale, tid = recording thread."""
        evs = []
        for e in self.events():
            evs.append({
                "name": e["name"], "ph": "X", "pid": 1, "tid": e["tid"],
                "ts": e["t0"] * 1e6,
                "dur": max((e["t1"] - e["t0"]) * 1e6, 0.0),
                "args": dict(e["args"], span_id=e["id"],
                             parent=e["parent"]),
            })
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def validate(self, wave_prefix: str = "wave",
                 covered_names: Tuple[str, ...] = ("device.dispatch",
                                                   "device.transfer"),
                 ) -> Tuple[bool, List[str]]:
        """CI gate (§10.2): (a) no span left open, (b) every in-ring
        parent precedes its children (t0 ordering) and contains them
        (t1 ordering) — containment is only asserted for same-thread
        children, because a span handed across a thread boundary (the
        compactor's ``compact.build``, spawned by a drain that returns
        long before the build lands) legitimately outlives its parent —
        (c) every ``covered_names`` span reaches a ``wave_prefix``-named
        ancestor whose interval covers it.  Returns ``(ok, problems)``;
        spans whose parents were evicted from the ring are skipped, not
        failed."""
        problems: List[str] = []
        evs = self.events()
        for o in self.open_spans():
            problems.append(f"span never finished: {o['name']} id={o['id']}")
        by_id = {e["id"]: e for e in evs}
        eps = 1e-6
        for e in evs:
            p = by_id.get(e["parent"]) if e["parent"] is not None else None
            if p is None:
                continue
            if p["t0"] > e["t0"] + eps:
                problems.append(
                    f"parent {p['name']} starts after child {e['name']}")
            if p["t1"] is not None and e["t1"] is not None \
                    and p["tid"] == e["tid"] and p["t1"] + eps < e["t1"]:
                problems.append(
                    f"parent {p['name']} ends before child {e['name']}")
        for e in evs:
            if e["name"] not in covered_names:
                continue
            node, seen = e, 0
            covered = orphaned = False
            while node["parent"] is not None and seen < 64:
                node = by_id.get(node["parent"])
                seen += 1
                if node is None:
                    orphaned = True          # ancestor evicted: skip
                    break
                if node["name"].startswith(wave_prefix) \
                        and node["t0"] <= e["t0"] + eps \
                        and node["t1"] is not None \
                        and node["t1"] + eps >= e["t1"]:
                    covered = True
                    break
            if not covered and not orphaned:
                problems.append(
                    f"{e['name']} id={e['id']} not covered by a "
                    f"{wave_prefix}* ancestor")
        return (not problems), problems
