"""Read replicas: ordered apply of the shipped WAL stream (DESIGN.md §8.4).

A ``Replica`` owns a full ``COAXIndex`` bootstrapped from a bit-identical
seed of the primary (``ship.seed_state``) and advances it by applying
shipped frames THROUGH THE ORDINARY ``insert(rows, ids=...)`` /
``delete`` / ``compact`` paths — the same §7.4 recovery ≡ replay argument
that makes crash restore exact makes every replica exact at its applied
frontier ``(epoch, next_seq)``.

The wire owes it nothing: frames may arrive torn (CRC-rejected, counted),
duplicated (at-or-below-frontier, absorbed), out of order (parked in a
reorder buffer until their frontier slot opens) or not at all (repaired by
pulling the gap from the primary's journal via ``hub.fetch``; a gap whose
epoch has rotated away forces a reseed).  Compaction arrives two ways and
both are handled: a replica whose own §5 trigger fires while applying the
trigger record rotates IMPLICITLY — deterministically identical to the
primary, because trigger state and config are identical — and absorbs the
late ``F_ROTATE`` as a duplicate; a manual primary ``compact()`` has no
replica-side trigger, so the control frame at the frontier replays
``compact(relearn=...)`` verbatim.

On the device backend (the default, on ``device="cuda"``) a replica
serves its waves from its own device plan: every wave is ``fused_scan``
launches, one per segment, exactly as the primary's.  A replica that
re-bootstraps drops its old index's device plan first: a live plan and
its index refer to each other, so without that the old plan's images
(about 1 GB at 20M rows) would wait for the cyclic garbage collector.

``drain_from_disk`` is the promotion path (§8.6): with the primary dead,
the most-caught-up replica finishes the primary's journal straight off
disk — the WAL is the retransmission buffer of last resort — falling back
to a read-only ``storage.restore`` of the primary's directory only when a
rotation boundary cannot be replayed from frames (the §7.5 crash window
of a manual compaction).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Tuple

from .. import obs
from ..core import COAXIndex
from ..runtime.failure import FaultPlan
from ..storage.snapshot import latest_snapshot, read_manifest, require_device
from ..storage.wal import (OP_INSERT, WalFrameCursor, decode_record,
                           read_wal, wal_path)
from .frames import (F_HEARTBEAT, F_ROTATE, F_WRITE, Frame, FrameError,
                     decode_frame, frame_nbytes, rotate_frame,
                     unpack_heartbeat, unpack_rotate, unpack_write,
                     write_frame)
from .ship import ReplicationHub

__all__ = ["Replica", "ReplicationError"]


class ReplicationError(RuntimeError):
    """A replica diverged from the protocol's invariants (e.g. a replayed
    rotation landed on a different epoch than the primary announced) —
    never expected, always a bug, never silently absorbed."""


def _newest_epoch_on_disk(directory: Path) -> Optional[int]:
    best = None
    for p in Path(directory).glob("wal_*.log"):
        try:
            e = int(p.stem.split("_", 1)[1])
        except ValueError:
            continue
        best = e if best is None else max(best, e)
    snap = latest_snapshot(directory)
    if snap is not None:
        e = int(read_manifest(snap)["epoch"])
        best = e if best is None else max(best, e)
    return best


class Replica:
    """One read replica: seeded copy + ordered frame application.

    ``alive`` is the crash switch: a ``FaultPlan`` action ``"crash"`` on
    channel ``"<name>.apply"`` halts the replica BEFORE the frame mutates
    anything, so its state stays exactly at the applied frontier — the
    in-process model of a process killed between ops.  ``revive()``
    resumes from that frontier (a restarted process would reload its own
    checkpoint and land in the same place); the next ``pump`` repairs
    whatever the outage missed via catch-up.

    ``backend``/``device_opts``/``device`` are ``COAXIndex.from_state``'s:
    by default the replica serves from the device backend on ``"cuda"``,
    and without a card it raises before it registers or seeds anything;
    ``backend="numpy"`` is the host path, ``device="cpu"`` the kernels'
    plain versions.
    """

    def __init__(self, name: str, hub: ReplicationHub,
                 backend: str = "device", device_opts: Optional[dict] = None,
                 plan: Optional[FaultPlan] = None, device: str = "cuda"):
        require_device(backend, device)
        self.name = name
        self.hub = hub
        self.backend = backend
        self.device_opts = device_opts
        self.device = device
        self.plan = plan
        self.alive = True
        self.index: Optional[COAXIndex] = None
        self.epoch = 0                  # applied frontier: next frame slot is
        self.next_seq = 0               # (epoch, next_seq)
        self.position = 0               # cumulative write-frames absorbed
        self.position_bytes = 0         # ... and their encoded bytes
        self._future: Dict[Tuple[int, int], Frame] = {}   # reorder buffer
        self.frames_applied = 0
        self.frames_corrupt = 0
        self.frames_duplicate = 0
        self.rotations_applied = 0
        self.implicit_rotations = 0
        self.catchup_fetches = 0
        self.reseeds = 0
        self.crashes = 0
        # (local receive time, primary send time, shipped frontier)
        self.last_heartbeat: Optional[Tuple[float, float, Tuple[int, int]]] = None
        hub.register(name)
        self._bootstrap()

    def _bootstrap(self) -> None:
        # a (re)seed is a fresh subscription: frames queued for the OLD
        # stream are meaningless under the new journal's coordinates (a
        # promoted primary rotates its WAL, resetting seq), so purge them
        flush = getattr(self.hub.transport, "flush_held", None)
        if flush is not None:
            flush(self.name)
        self.hub.transport.recv(self.name)
        state, (epoch, seq), writes, nbytes = self.hub.seed()
        self._release_index()
        self.index = COAXIndex.from_state(state, backend=self.backend,
                                          device_opts=self.device_opts,
                                          device=self.device)
        self._force_sync_compaction()
        self.epoch, self.next_seq = epoch, seq
        self.position, self.position_bytes = writes, nbytes
        self._future.clear()
        self.last_heartbeat = (time.time(), time.time(), (epoch, seq))

    def _release_index(self) -> None:
        """Drop the device plan of the index about to be replaced."""
        if self.index is not None:
            self.index.release_plan()

    def _force_sync_compaction(self) -> None:
        """Replicas always compact SYNCHRONOUSLY, whatever the seeded
        config says: the §8.2 implicit-rotation contract needs the epoch
        to advance AT the trigger record (so the frontier resets exactly
        where the primary's freeze happened), which a §5.4 background
        build — installing at some later poll — would break.  A background
        primary's handoff converges to the same state (same frozen row
        set, tail re-journaled into the new epoch's WAL and pulled here
        via catch-up), so sync apply stays bit-identical."""
        import dataclasses
        cfg = self.index.config
        if cfg.background_compact:
            self.index.config = dataclasses.replace(
                cfg, background_compact=False)

    # ------------------------------------------------------------------ #
    @property
    def frontier(self) -> Tuple[int, int]:
        return (self.epoch, self.next_seq)

    def lag_frames(self) -> int:
        return max(self.hub.total_writes - self.position, 0)

    def lag_bytes(self) -> int:
        return max(self.hub.total_bytes - self.position_bytes, 0)

    def heartbeat_age(self, now: Optional[float] = None) -> float:
        if self.last_heartbeat is None:
            return float("inf")
        return (time.time() if now is None else now) - self.last_heartbeat[0]

    def behind(self) -> bool:
        return self._future or self.hub.frontier > self.frontier

    # ------------------------------------------------------------------ #
    def pump(self, catch_up: bool = True) -> int:
        """Drain the transport queue and apply everything applicable;
        optionally repair gaps from the primary's journal.  Returns the
        number of frames applied."""
        if not self.alive:
            return 0
        applied = 0
        with obs.span("replica.apply", replica=self.name) as sp:
            for data in self.hub.transport.recv(self.name):
                try:
                    frame = decode_frame(data)
                except FrameError:
                    self.frames_corrupt += 1  # torn in transit; catch-up
                    continue                  # repairs the gap
                applied += self._ingest(frame)
                if not self.alive:
                    break
            if catch_up and self.alive and self.behind():
                applied += self.catch_up()
            if sp is not None:
                sp.args["applied"] = applied
        if applied:
            obs.get_registry().counter(
                "coax_replica_frames_applied_total",
                "Frames applied on replicas.", ("replica",)).inc(
                    applied, replica=self.name)
        return applied

    def _ingest(self, frame: Frame) -> int:
        if frame.kind == F_HEARTBEAT:
            self.last_heartbeat = (time.time(), unpack_heartbeat(frame),
                                   frame.key)
            return 0
        if frame.key < self.frontier:
            self.frames_duplicate += 1      # dup in transit, or already pulled
            return 0
        if frame.key > self.frontier:
            if frame.key in self._future:
                self.frames_duplicate += 1
            else:
                self._future[frame.key] = frame
            return 0
        applied = self._apply(frame)
        if self.alive:
            applied += self._drain_future()
        return applied

    def _drain_future(self) -> int:
        applied = 0
        while self.alive:
            frame = self._future.pop(self.frontier, None)
            if frame is None:
                break
            applied += self._apply(frame)
        # rotation may leap the frontier past parked old-epoch keys (the
        # absorbed late-ROTATE case); they are duplicates now
        for key in [k for k in self._future if k < self.frontier]:
            del self._future[key]
            self.frames_duplicate += 1
        return applied

    # ------------------------------------------------------------------ #
    def _apply(self, frame: Frame) -> int:
        if self.plan is not None and \
                self.plan.action(f"{self.name}.apply") == "crash":
            self.alive = False              # dies BEFORE mutating: state
            self.crashes += 1               # stays at the applied frontier
            return 0
        if frame.kind == F_ROTATE:
            new_epoch, relearned = unpack_rotate(frame)
            self.index.compact(relearn=relearned)
            if self.index.epoch != new_epoch:
                raise ReplicationError(
                    f"{self.name}: replayed rotation reached epoch "
                    f"{self.index.epoch}, primary announced {new_epoch}")
            self.epoch, self.next_seq = new_epoch, 0
            self.rotations_applied += 1
            self.frames_applied += 1
            return 1
        if frame.kind != F_WRITE:
            raise ReplicationError(f"{self.name}: unknown frame kind "
                                   f"{frame.kind} at {frame.key}")
        kind, payload = unpack_write(frame)
        rows, ids = decode_record(kind, payload)
        epoch_before = self.index.epoch
        if kind == OP_INSERT:
            self.index.insert(rows, ids=ids)
        else:
            self.index.delete(ids)
        self.position += 1
        self.position_bytes += frame_nbytes(frame)
        self.frames_applied += 1
        if self.index.epoch != epoch_before:
            # the §5 trigger fired on this record here exactly as it did on
            # the primary (identical state, identical config): implicit
            # rotation; the primary's ROTATE frame arrives late and is
            # absorbed above as a duplicate
            self.implicit_rotations += 1
            self.epoch, self.next_seq = self.index.epoch, 0
        else:
            self.epoch, self.next_seq = frame.epoch, frame.seq + 1
        return 1

    # ------------------------------------------------------------------ #
    # Gap repair
    # ------------------------------------------------------------------ #
    def catch_up(self) -> int:
        """Pull the gap ``frontier .. primary frontier`` from the primary's
        journal (``hub.fetch``); reseed when the epoch rotated away."""
        self.catchup_fetches += 1
        resp = self.hub.fetch(self.epoch, self.next_seq)
        if resp["reseed"]:
            self.reseed()
            return 0
        applied = 0
        for frame in resp["frames"]:
            applied += self._ingest(frame)
            if not self.alive:
                break
        return applied

    def reseed(self) -> None:
        """Re-bootstrap from a fresh bit-identical seed of the live primary
        (frame-level repair impossible: the needed epoch rotated away)."""
        self._bootstrap()
        self.reseeds += 1

    def revive(self) -> None:
        """Bring a crashed replica back at its applied frontier; the next
        ``pump`` catches up whatever the outage missed."""
        self.alive = True

    # ------------------------------------------------------------------ #
    # Promotion support (DESIGN.md §8.6)
    # ------------------------------------------------------------------ #
    def drain_from_disk(self, directory=None) -> int:
        """Finish a dead primary's journal straight off its durability
        directory: apply every record past our frontier (ordinary write
        paths, implicit rotations included), crossing epoch boundaries via
        the hub's rotation history when frames can replay them and a
        read-only ``storage.restore`` of the directory when they cannot
        (manual compaction interrupted mid-rotation).  Returns frames
        applied; the caller asserts the resulting frontier covers every
        client-acknowledged write."""
        directory = Path(directory if directory is not None
                         else self.hub.durability.directory)
        applied = 0
        while self.alive:
            start = self.frontier
            path = wal_path(directory, self.epoch)
            if path.exists():
                cursor = WalFrameCursor(path, expect_epoch=self.epoch,
                                        start_seq=self.next_seq)
                for seq, kind, payload in cursor.read():
                    applied += self._apply(write_frame(self.epoch, seq,
                                                       kind, payload))
                    if not self.alive or self.epoch != start[0]:
                        break               # crashed, or implicitly rotated
            if not self.alive:
                break
            if self.frontier != start and self.epoch != start[0]:
                continue                    # drain the new epoch's WAL too
            disk_epoch = _newest_epoch_on_disk(directory)
            if disk_epoch is None or disk_epoch <= self.epoch:
                break                       # journal fully absorbed
            rot = self.hub.rotations.get(self.epoch)
            if rot is not None and rot[0] == self.next_seq:
                applied += self._apply(rotate_frame(self.epoch, rot[0],
                                                    rot[1], rot[2]))
                continue
            # epoch boundary with no replayable control frame (primary died
            # mid-rotation of a manual compact): recover exactly like a
            # restarted primary would — snapshot + WAL replay, read-only
            self._reseed_from_disk(directory)
        return applied

    def _reseed_from_disk(self, directory: Path) -> None:
        from ..storage import restore
        fresh = restore(directory, backend=self.backend,
                        device_opts=self.device_opts, durable=False,
                        device=self.device)
        self._release_index()
        self.index = fresh
        self._force_sync_compaction()
        _, next_seq, _ = read_wal(wal_path(directory, self.index.epoch),
                                  expect_epoch=self.index.epoch)
        self.epoch, self.next_seq = self.index.epoch, next_seq
        self.position = self.hub.total_writes
        self.position_bytes = self.hub.total_bytes
        self._future.clear()
        self.reseeds += 1

    # ------------------------------------------------------------------ #
    def describe(self) -> dict:
        return {
            "name": self.name,
            "alive": self.alive,
            "epoch": self.epoch,
            "next_seq": self.next_seq,
            "lag_frames": self.lag_frames(),
            "lag_bytes": self.lag_bytes(),
            "heartbeat_age": self.heartbeat_age(),
            "frames_applied": self.frames_applied,
            "frames_corrupt": self.frames_corrupt,
            "frames_duplicate": self.frames_duplicate,
            "rotations_applied": self.rotations_applied,
            "implicit_rotations": self.implicit_rotations,
            "catchup_fetches": self.catchup_fetches,
            "reseeds": self.reseeds,
            "crashes": self.crashes,
            "buffered": len(self._future),
        }
