"""Replicated serving: routed reads, health checks, promotion (§8.5–8.6).

``ReplicatedServer`` owns one primary ``COAXIndex`` (journaling under
``<directory>/primary``), a ``ReplicationHub`` shipping its WAL, and N
``Replica`` instances.  Writes go to the primary and are ACKNOWLEDGED at
the journal frontier the call returned at (``acked`` — the no-data-loss
yardstick for promotion: an op that raised never acked, so a promoted
frontier ≥ ``acked`` proves no client-visible write was lost).

Reads round-robin over HEALTHY replicas — alive, a recent-enough
heartbeat, and lag within the bounded-staleness budget — and degrade to
primary-serves-reads (counted) when none qualifies.  ``tick()`` is the
control loop body: ship a heartbeat, pump every live replica.

``promote()`` is the failover sequence: pick the most-caught-up live
replica, deliver whatever the wire still holds, finish the dead primary's
journal straight off disk (``Replica.drain_from_disk``), gate on
``frontier ≥ acked``, then turn the replica into the new primary — its
index attaches a FRESH durability directory (snapshot + rotated WAL under
its own name) and a new hub re-seeds the surviving replicas against it.
Every step is synchronous and deterministic, so a ``FaultPlan`` schedule
reproduces an entire failover scenario exactly.

Replicas serve from the device backend on ``device="cuda"`` by default
(``replica_backend``/``device_opts``/``device``), each from its own device
plan; without a card the constructor raises before it attaches the
primary's journal or seeds a replica.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from .. import obs
from ..core import COAXIndex
from ..runtime.failure import FaultPlan
from ..storage.snapshot import require_device
from .replica import Replica, ReplicationError
from .ship import ReplicationHub
from .transport import FaultyTransport, InProcTransport, Transport

__all__ = ["ReplicatedServer"]


class ReplicatedServer:
    """Primary + N replicas behind one read/write façade."""

    def __init__(self, index: COAXIndex, directory: Union[str, Path],
                 n_replicas: int = 2, plan: Optional[FaultPlan] = None,
                 replica_backend: str = "device",
                 device_opts: Optional[dict] = None,
                 transport: Optional[Transport] = None,
                 heartbeat_timeout: float = 5.0, max_lag_frames: int = 256,
                 ship_retries: int = 3, ship_backoff: float = 0.0,
                 device: str = "cuda"):
        require_device(replica_backend, device)
        self.directory = Path(directory)
        self.plan = plan
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.max_lag_frames = int(max_lag_frames)
        self._ship_retries = int(ship_retries)
        self._ship_backoff = float(ship_backoff)
        self.primary = index
        if index.durable is None:
            index.attach_durability(self.directory / "primary")
        self.primary_dir = index.durable.directory
        base = transport if transport is not None else InProcTransport()
        self.transport: Transport = (FaultyTransport(base, plan)
                                     if plan is not None else base)
        self.hub = ReplicationHub(index.durable, self.transport, plan=plan,
                                  retries=ship_retries, backoff=ship_backoff)
        self.replicas: List[Replica] = [
            Replica(f"replica-{i}", self.hub, backend=replica_backend,
                    device_opts=device_opts, plan=plan, device=device)
            for i in range(int(n_replicas))
        ]
        self.primary_alive = True
        self.acked = self.hub.frontier  # journal frontier of the last ack'd op
        self.promotions = 0
        self.degraded_reads = 0
        self.replica_reads = 0
        self.primary_reads = 0
        self._rr = 0

    # ------------------------------------------------------------------ #
    # Write path (primary only; ack = the journal frontier on return)
    # ------------------------------------------------------------------ #
    def _require_primary(self) -> None:
        if not self.primary_alive:
            raise ReplicationError("primary is down; promote() a replica "
                                   "before writing")

    def insert(self, rows: np.ndarray,
               ids: Optional[np.ndarray] = None) -> np.ndarray:
        self._require_primary()
        out = self.primary.insert(rows, ids=ids)
        self.acked = self.hub.frontier
        return out

    def delete(self, row_ids) -> int:
        self._require_primary()
        out = self.primary.delete(row_ids)
        self.acked = self.hub.frontier
        return out

    def compact(self, relearn: Optional[bool] = None) -> dict:
        self._require_primary()
        out = self.primary.compact(relearn=relearn)
        self.acked = self.hub.frontier
        return out

    def sync(self) -> None:
        if self.primary_alive and self.primary.durable is not None:
            self.primary.durable.sync()

    # ------------------------------------------------------------------ #
    # Control loop
    # ------------------------------------------------------------------ #
    def tick(self) -> int:
        """One control-loop beat: heartbeat the stream, pump every live
        replica (apply + catch-up).  Returns frames applied."""
        if self.primary_alive:
            self.hub.heartbeat()
        applied = 0
        for rep in self.replicas:
            if rep.alive:
                applied += rep.pump()
        return applied

    def healthy(self, rep: Replica) -> bool:
        return (rep.alive
                and rep.heartbeat_age() <= self.heartbeat_timeout
                and rep.lag_frames() <= self.max_lag_frames)

    def healthy_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if self.healthy(r)]

    # ------------------------------------------------------------------ #
    # Read path (bounded-staleness routing)
    # ------------------------------------------------------------------ #
    def read_index(self) -> COAXIndex:
        """The index the next read is served from: round-robin over healthy
        replicas, degrading to the primary (counted) when none qualifies."""
        healthy = self.healthy_replicas()
        if healthy:
            rep = healthy[self._rr % len(healthy)]
            self._rr += 1
            self.replica_reads += 1
            return rep.index
        if self.primary_alive:
            self.degraded_reads += 1
            self.primary_reads += 1
            return self.primary
        raise ReplicationError("no healthy replica and the primary is down")

    def query(self, rect) -> np.ndarray:
        return self.read_index().query(rect)

    def query_batch(self, rects):
        return self.read_index().query_batch(rects)

    def query_batch_split(self, rects):
        return self.read_index().query_batch_split(rects)

    # ------------------------------------------------------------------ #
    # Failure + promotion
    # ------------------------------------------------------------------ #
    def kill_primary(self) -> None:
        """Model the primary process dying: shipping stops, the façade
        refuses writes, and the durability directory is left exactly as the
        dead process left it (no orderly close — that is the point)."""
        self.primary_alive = False
        self.hub.detach()

    def promote(self, name: Optional[str] = None) -> Replica:
        """Fail over onto the most-caught-up live replica (or ``name``).

        Sequence: (1) the wire surrenders what it still holds (held frames
        flushed, queue pumped); (2) the replica finishes the dead primary's
        journal off disk; (3) the no-data-loss gate — promoted frontier ≥
        last acked frontier — or ``ReplicationError``; (4) the replica's
        index attaches a fresh durability directory (snapshot + rotated
        WAL under its own name) and becomes the primary of a new hub;
        (5) surviving replicas re-seed against it.
        """
        if self.primary_alive:
            self.kill_primary()             # controlled switchover
        candidates = [r for r in self.replicas if r.alive]
        if not candidates:
            raise ReplicationError("no live replica to promote")
        if name is not None:
            rep = next(r for r in candidates if r.name == name)
        else:
            rep = max(candidates, key=lambda r: r.frontier)

        with obs.span("failover.promote", replica=rep.name) as sp:
            flush = getattr(self.transport, "flush_held", None)
            if flush is not None:
                flush(rep.name)             # the OS delivers its buffers
            rep.pump()                      # shipped tail + journal catch-up
            rep.drain_from_disk(self.primary_dir)
            if rep.frontier < self.acked:
                raise ReplicationError(
                    f"promotion would lose acknowledged writes: {rep.name} "
                    f"reached {rep.frontier}, last ack at {self.acked}")

            self.promotions += 1
            promoted_dir = self.directory / f"{rep.name}-gen{self.promotions}"
            rep.index.attach_durability(promoted_dir)
            self.primary = rep.index
            self.primary_dir = promoted_dir
            self.primary_alive = True
            self.hub = ReplicationHub(rep.index.durable, self.transport,
                                      plan=self.plan,
                                      retries=self._ship_retries,
                                      backoff=self._ship_backoff)
            self.replicas = [r for r in self.replicas if r is not rep]
            for r in self.replicas:
                r.hub = self.hub
                self.hub.register(r.name)
                r.reseed()                  # fresh subscription to the new
                r.alive = True              # primary's stream
            self.acked = self.hub.frontier
            if sp is not None:
                sp.args["epoch"], sp.args["seq"] = rep.frontier
        obs.get_registry().counter(
            "coax_promotions_total", "Replica-to-primary promotions.").inc()
        return rep

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        counts = (self.transport.counts()
                  if isinstance(self.transport, FaultyTransport) else {})
        return {
            "primary_alive": self.primary_alive,
            "primary_dir": str(self.primary_dir),
            "frontier": {"epoch": self.hub.frontier[0],
                         "seq": self.hub.frontier[1]},
            "acked": {"epoch": self.acked[0], "seq": self.acked[1]},
            "promotions": self.promotions,
            "reads": {"replica": self.replica_reads,
                      "primary": self.primary_reads,
                      "degraded": self.degraded_reads},
            "ship": self.hub.describe(),
            "transport_faults": counts,
            "fault_plan": self.plan.counts() if self.plan is not None else {},
            "replicas": [r.describe() for r in self.replicas],
        }

    def describe(self) -> dict:
        return self.stats()

    def close(self) -> None:
        """Orderly teardown: sync + close the primary's durability plane
        (idempotent, like everything on the close path)."""
        if self.primary.durable is not None:
            self.primary.durable.close()
