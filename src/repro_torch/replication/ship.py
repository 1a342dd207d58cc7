"""WAL shipping: the primary side of replication (DESIGN.md §8.2).

``ReplicationHub`` subscribes to a ``storage.Durability`` plane's
replication hooks and turns the primary's journal into a shipped stream:

* every journaled record ships as an ``F_WRITE`` frame carrying the EXACT
  WAL bytes, immediately after the append (``frame_observer``);
* every §7.5 compaction-rotation ships as an ``F_ROTATE`` control frame
  from INSIDE the rotation window (``rotate_observer``) — after the new
  epoch pair is on disk, before old WALs die — so a crash injected there
  models a primary dying mid-rotation with replicas mid-stream.  A §5.4
  background-compaction handoff fires the SAME observer
  (``Durability.handoff_rotate``); its re-journaled tail records are NOT
  pushed (``_suppress_ship``) — a sync replica already rotated implicitly
  at the trigger record, drops the old-epoch tail pushes as duplicates,
  and pulls the re-journaled tail via ``fetch(new_epoch, 0)``;
* ``heartbeat()`` ships the journal frontier + wall time, the liveness
  signal replicas date their health from.

Ship failures NEVER fail the primary's write path: each send runs under
``runtime.failure.retry`` (``TransportError`` is the retryable class), and
a frame that still cannot be delivered is counted and abandoned — the
replica repairs the gap through the pull path, ``fetch``, which reads the
primary's on-disk WAL through ``storage.WalFrameCursor`` (the journal
doubles as the retransmission buffer).  When the wanted epoch has rotated
away, ``fetch`` signals ``reseed`` and the replica re-bootstraps from
``seed_state`` — the same snapshot codec the durability plane uses, so the
seed is bit-identical by §7.3's round-trip contract.
"""
from __future__ import annotations

import io
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..runtime.failure import FaultPlan, retry
from ..storage.durability import Durability
from ..storage.snapshot import pack_state, unpack_state
from ..storage.wal import WalFrameCursor, wal_path
from .frames import (Frame, encode_frame, heartbeat_frame, rotate_frame,
                     write_frame)
from .transport import Transport, TransportError

__all__ = ["ReplicationHub", "seed_state"]


def seed_state(index) -> dict:
    """Deep, bit-identical copy of an index's full state, as the dict
    ``COAXIndex.from_state`` takes.

    Round-trips through the snapshot codec (``pack_state`` -> in-memory
    npz + JSON -> ``unpack_state``) rather than handing out ``state()``
    directly: the raw state dict ALIASES the live index's arrays, and a
    replica built from it would mutate its primary.  The codec path is
    the §7.3 bit-identity contract made into a copier — exactly what
    shipping a snapshot over a wire would do.

    Any in-flight §5.4 background build is JOINED first: a seed taken
    mid-build would hand the replica the old epoch plus a delta the
    primary is about to fold into a NEW epoch built from an earlier
    freeze — the replica's own (synchronous) trigger would then fire over
    a different row set and diverge.  Post-join, the seed is an ordinary
    whole-epoch state.
    """
    fh = getattr(index, "finish_handoff", None)
    if fh is not None:
        fh()
    manifest, arrays = pack_state(index.state())
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    buf.seek(0)
    with np.load(buf) as z:
        loaded = {k: z[k] for k in z.files}
    return unpack_state(json.loads(json.dumps(manifest)), loaded)


class ReplicationHub:
    """Fan-out point between one primary's durability plane and its
    replicas' transport destinations (DESIGN.md §8.2).

    Construction subscribes to ``durability.frame_observer`` /
    ``rotate_observer``; ``detach()`` unsubscribes (a killed primary stops
    shipping).  ``total_writes`` / ``total_bytes`` are the cumulative
    shipped-stream totals replicas measure their lag against.
    """

    def __init__(self, durability: Durability, transport: Transport,
                 plan: Optional[FaultPlan] = None, retries: int = 3,
                 backoff: float = 0.0):
        self.durability = durability
        self.transport = transport
        self.plan = plan
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.destinations: List[str] = []
        self.total_writes = 0           # F_WRITE frames shipped (stream length)
        self.total_bytes = 0            # encoded bytes of those frames
        self.send_retries = 0           # transport retries that later succeeded
        self.ship_failures = 0          # (frame, dest) pairs abandoned to catch-up
        self.heartbeats = 0
        # old_epoch -> (old_final_seq, new_epoch, relearned): lets ``fetch``
        # re-issue the ROTATE control frame during the §7.5 crash window in
        # which the old epoch's WAL is still on disk
        self.rotations: Dict[int, Tuple[int, int, bool]] = {}
        durability.frame_observer = self._on_append
        durability.rotate_observer = self._on_rotate

    # ------------------------------------------------------------------ #
    @property
    def index(self):
        return self.durability.index

    @property
    def frontier(self) -> Tuple[int, int]:
        """The primary journal's ``(epoch, next_seq)`` — what a fully
        caught-up replica's applied frontier equals."""
        wal = self.durability.wal
        if wal is None:
            return (self.index.epoch, 0)
        return (wal.epoch, wal.next_seq)

    def detach(self) -> None:
        """Stop shipping (the primary-death switch): a real dead process
        stops sending; here the observers are torn down explicitly."""
        if self.durability.frame_observer is self._on_append:
            self.durability.frame_observer = None
        if self.durability.rotate_observer is self._on_rotate:
            self.durability.rotate_observer = None

    # ------------------------------------------------------------------ #
    def register(self, dest: str) -> None:
        if dest not in self.destinations:
            self.destinations.append(dest)

    def unregister(self, dest: str) -> None:
        if dest in self.destinations:
            self.destinations.remove(dest)

    def _ship(self, dest: str, data: bytes) -> None:
        def _count_retry(attempt, exc):
            self.send_retries += 1
            obs.get_registry().counter(
                "coax_ship_retries_total", "Push-side send retries.").inc()

        with obs.span("ship.send", dest=dest, nbytes=len(data)) as sp:
            try:
                retry(lambda: self.transport.send(dest, data),
                      retries=self.retries, backoff=self.backoff,
                      on_error=_count_retry, retryable=(TransportError,))
            except TransportError:
                # give up on the push; the replica pulls the gap from the
                # journal (``fetch``).  The primary's write path never fails
                # because a replica link is down.
                self.ship_failures += 1
                obs.get_registry().counter(
                    "coax_ship_failures_total",
                    "Frames abandoned after retry exhaustion.").inc()
                if sp is not None:
                    sp.args["failed"] = True
        reg = obs.get_registry()
        reg.counter("coax_ship_frames_total",
                    "Frames pushed to replica links.").inc()
        reg.counter("coax_ship_bytes_total",
                    "Encoded frame bytes pushed.").inc(len(data))

    def _broadcast(self, frame: Frame) -> bytes:
        data = encode_frame(frame)
        for dest in self.destinations:
            self._ship(dest, data)
        return data

    # ------------------------------------------------------------------ #
    # Durability-plane hooks
    # ------------------------------------------------------------------ #
    def _on_append(self, epoch: int, seq: int, kind: int,
                   payload: bytes) -> None:
        data = self._broadcast(write_frame(epoch, seq, kind, payload))
        self.total_writes += 1
        self.total_bytes += len(data)

    def _on_rotate(self, old_epoch: int, old_final_seq: int, new_epoch: int,
                   relearned: bool) -> None:
        if self.plan is not None:
            # primary dies mid-rotation: the new epoch pair is on disk, the
            # old WALs are not yet deleted, no ROTATE frame was shipped
            self.plan.crash_if("primary.rotate")
        self.rotations[old_epoch] = (old_final_seq, new_epoch,
                                     bool(relearned))
        self._broadcast(rotate_frame(old_epoch, old_final_seq, new_epoch,
                                     relearned))

    def heartbeat(self) -> None:
        epoch, seq = self.frontier
        self._broadcast(heartbeat_frame(epoch, seq, time.time()))
        self.heartbeats += 1

    # ------------------------------------------------------------------ #
    # Pull path: catch-up reads against the on-disk journal
    # ------------------------------------------------------------------ #
    def fetch(self, epoch: int, from_seq: int,
              max_records: Optional[int] = None) -> dict:
        """Re-derive the shipped stream from ``(epoch, from_seq)`` out of
        the primary's on-disk WAL.  Returns ``{"frames": [...], "reseed":
        bool}`` — ``reseed`` means the wanted epoch rotated away (its WAL
        was deleted, §7.5 step 3), so no frame-level repair exists and the
        replica must re-bootstrap from a fresh seed."""
        path = wal_path(self.durability.directory, epoch)
        cur_epoch, _ = self.frontier
        if not path.exists():
            return {"frames": [], "reseed": epoch < cur_epoch}
        cursor = WalFrameCursor(path, expect_epoch=epoch, start_seq=from_seq)
        frames = [write_frame(epoch, seq, kind, payload)
                  for seq, kind, payload in cursor.read(max_records)]
        if epoch < cur_epoch:
            rot = self.rotations.get(epoch)
            if rot is None:
                # rotation predates this hub (or history was lost with a
                # crashed predecessor): cannot hand over the epoch boundary
                return {"frames": [], "reseed": True}
            frames.append(rotate_frame(epoch, rot[0], rot[1], rot[2]))
        return {"frames": frames, "reseed": False}

    def seed(self) -> Tuple[dict, Tuple[int, int], int, int]:
        """Bootstrap payload for a (re)seeding replica: a deep state copy
        plus the journal frontier and stream totals it corresponds to."""
        return (seed_state(self.index), self.frontier, self.total_writes,
                self.total_bytes)

    # ------------------------------------------------------------------ #
    def describe(self) -> dict:
        epoch, seq = self.frontier
        return {
            "destinations": list(self.destinations),
            "frontier": {"epoch": epoch, "seq": seq},
            "shipped_frames": self.total_writes,
            "shipped_bytes": self.total_bytes,
            "send_retries": self.send_retries,
            "ship_failures": self.ship_failures,
            "heartbeats": self.heartbeats,
            "rotations": len(self.rotations),
        }
