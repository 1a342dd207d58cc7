"""Pluggable frame transport + deterministic fault injection (DESIGN.md §8.3).

``Transport`` is deliberately socket-shaped — ``send(dest, bytes)`` /
``recv(dest) -> [bytes]`` with no shared-memory assumptions, at-most-once
delivery and no ordering promise — so the in-process implementation used
here swaps for a real socket later without touching the protocol: replicas
already tolerate loss, duplication, reordering and truncation (the replica
protocol repairs via catch-up, §8.4, never by trusting the wire).

``InProcTransport``  — per-destination FIFO of raw frame bytes.
``FaultyTransport``  — wraps any transport and executes a
    ``runtime.failure.FaultPlan``'s schedule on channel ``"ship.<dest>"``:
    drop / duplicate / reorder / tear (truncate mid-frame) / delay /
    error (raise ``TransportError`` — the sender's retry+backoff path).
    Every injection is tallied, so serving stats can report exactly what
    the wire did to the stream.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from ..runtime.failure import FaultPlan

__all__ = ["TransportError", "Transport", "InProcTransport", "FaultyTransport"]


class TransportError(RuntimeError):
    """Transient send failure — retryable (``runtime.failure.retry``)."""


class Transport:
    """The socket-shaped contract replication is written against."""

    def send(self, dest: str, data: bytes) -> None:
        raise NotImplementedError

    def recv(self, dest: str, max_messages: Optional[int] = None) -> List[bytes]:
        raise NotImplementedError

    def pending(self, dest: str) -> int:
        raise NotImplementedError


class InProcTransport(Transport):
    """Per-destination FIFO queues; the single-process stand-in."""

    def __init__(self):
        self._queues: Dict[str, deque] = {}

    def send(self, dest: str, data: bytes) -> None:
        self._queues.setdefault(dest, deque()).append(bytes(data))

    def recv(self, dest: str, max_messages: Optional[int] = None) -> List[bytes]:
        q = self._queues.get(dest)
        out: List[bytes] = []
        while q and (max_messages is None or len(out) < max_messages):
            out.append(q.popleft())
        return out

    def pending(self, dest: str) -> int:
        return len(self._queues.get(dest, ()))


class FaultyTransport(Transport):
    """Deterministic wire damage between a sender and its destinations.

    Consults ``plan.action(f"ship.<dest>")`` once per ``send`` and applies:

    ``"drop"``            — the frame never arrives.
    ``"dup"``             — the frame arrives twice.
    ``"reorder"``         — the frame is held and released after the NEXT
                            send to the same destination (adjacent swap).
    ``"tear"`` / ``("tear", n)`` — the first ``n`` bytes arrive (default:
                            half the frame) — a mid-frame truncation the
                            replica's CRC catches.
    ``("delay", k)``      — held for ``k`` subsequent sends, then released
                            BEFORE that send's own frame (delayed, not
                            reordered relative to later traffic forever).
    ``"error"`` / ``("error", k)`` — ``TransportError`` raised ``k`` times
                            (default 1) before the frame goes through on
                            retry; the sender's ``retry`` path.

    Held frames survive in per-destination queues; ``flush_held`` releases
    everything (promotion drains call it — a dead wire keeps no secrets the
    catch-up path cannot re-derive, but flushing models the OS delivering
    its socket buffers).
    """

    def __init__(self, inner: Transport, plan: Optional[FaultPlan] = None):
        self.inner = inner
        self.plan = plan
        self.drops = 0
        self.dups = 0
        self.tears = 0
        self.reorders = 0
        self.delays = 0
        self.errors = 0
        # dest -> [[countdown, data, release_after_frame]]: reordered frames
        # release AFTER the next frame (the adjacent swap), delayed frames
        # BEFORE their k-th subsequent frame (delayed, never swapped)
        self._held: Dict[str, List[List]] = {}
        self._error_budget: Dict[str, int] = {}  # dest -> errors still to raise

    # ------------------------------------------------------------------ #
    def _release_due(self, dest: str, after: bool) -> None:
        held = self._held.get(dest, [])
        still = []
        for item in held:
            if item[2] != after:
                still.append(item)
                continue
            item[0] -= 1
            if item[0] <= 0:
                self.inner.send(dest, item[1])
            else:
                still.append(item)
        self._held[dest] = still

    def send(self, dest: str, data: bytes) -> None:
        budget = self._error_budget.get(dest, 0)
        if budget > 0:                      # mid-retry of an injected error
            self._error_budget[dest] = budget - 1
            self.errors += 1
            raise TransportError(f"injected send error to {dest}")
        act = self.plan.action(f"ship.{dest}") if self.plan is not None else None
        name = act[0] if isinstance(act, tuple) else act
        self._release_due(dest, after=False)
        if name == "error":
            times = act[1] if isinstance(act, tuple) else 1
            self._error_budget[dest] = times - 1
            self.errors += 1
            raise TransportError(f"injected send error to {dest}")
        hold = None
        if name == "drop":
            self.drops += 1
        elif name == "dup":
            self.dups += 1
            self.inner.send(dest, data)
            self.inner.send(dest, data)
        elif name == "tear":
            keep = act[1] if isinstance(act, tuple) else max(len(data) // 2, 1)
            self.tears += 1
            self.inner.send(dest, data[:keep])
        elif name == "reorder":
            self.reorders += 1
            hold = [1, bytes(data), True]
        elif name == "delay":
            self.delays += 1
            hold = [int(act[1]), bytes(data), False]
        else:
            self.inner.send(dest, data)
        # frames held by EARLIER sends that were due "after the next frame"
        # go out now — behind this send's own frame (the adjacent swap); the
        # frame held by THIS send joins the queue only afterwards
        self._release_due(dest, after=True)
        if hold is not None:
            self._held.setdefault(dest, []).append(hold)

    def recv(self, dest: str, max_messages: Optional[int] = None) -> List[bytes]:
        return self.inner.recv(dest, max_messages)

    def pending(self, dest: str) -> int:
        return self.inner.pending(dest) + len(self._held.get(dest, ()))

    def flush_held(self, dest: Optional[str] = None) -> None:
        """Deliver every held (reordered/delayed) frame immediately."""
        dests = [dest] if dest is not None else list(self._held)
        for d in dests:
            for item in self._held.pop(d, []):
                self.inner.send(d, item[1])

    def counts(self) -> dict:
        return {"drops": self.drops, "dups": self.dups, "tears": self.tears,
                "reorders": self.reorders, "delays": self.delays,
                "errors": self.errors}
