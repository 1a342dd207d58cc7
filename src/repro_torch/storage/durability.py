"""The durability plane: journaled writes + crash recovery (DESIGN.md §7).

``Durability`` hooks one ``COAXIndex``'s write path to disk:

* ``log_insert``/``log_delete`` append one WAL frame per write call BEFORE
  the in-memory apply (``storage.wal`` framing), so on-disk state is always
  ``newest complete snapshot + WAL tail`` — a prefix of the live history;
* ``on_compact`` is the §7.5 truncation point: compaction already bumped
  the epoch and emptied the delta planes, so the plane publishes a fresh
  epoch snapshot (atomic, §7.1), opens the new epoch's WAL and only then
  deletes older WAL files — every crash window leaves a recoverable pair;
* ``handoff_rotate`` is the same truncation point for a BACKGROUND
  compaction (epoch handoff, DESIGN.md §5.4): the writes admitted during
  the build are re-journaled into the new epoch's WAL and fsynced BEFORE
  the new snapshot is published, so a crash in any window recovers either
  from the old pair (whose WAL still holds the trigger record + tail —
  replay re-fires the compaction deterministically) or from the new pair;
* ``checkpoint`` publishes a mid-epoch full-state snapshot stamped with the
  journal position (``wal_seq``), bounding replay cost without touching the
  WAL file;
* ``sync`` fsyncs the WAL tail — called by ``QueryServer`` at wave
  boundaries (§7.2 fsync contract).

``restore`` rebuilds an index from a durability directory: load the newest
complete snapshot, replay the WAL records it has not absorbed through the
ORDINARY ``insert``/``delete`` paths (identical arithmetic, identical
tracker accumulation order — the §7.4 recovery ≡ replay argument), and
optionally re-attach the plane so journaling continues where the crashed
process stopped.  If a replayed record trips the compaction trigger —
possible only when the crash hit the rotation window — the attached plane
rotates exactly as the live index would have, converging disk and memory.

Sharded layout (``ShardedDurability``): a ``spec.json`` partitioner spec
(atomic single-file replace) plus one independent per-shard durability
directory — each shard journals and rotates on its own epochs (§6 shard
locality), and the global id high-water mark is recovered as the max of
the spec's checkpointed value and every shard's restored ``_next_id``.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from .. import obs
from ..core import COAXIndex
from . import atomic
from .snapshot import (MANIFEST_NAME, SNAPSHOT_PREFIX, latest_snapshot,
                       load_snapshot, read_manifest, require_device,
                       snapshot_nbytes, write_snapshot)
from .wal import WriteAheadLog, OP_INSERT, read_wal, wal_path

__all__ = ["Durability", "ShardedDurability", "restore", "SPEC_NAME"]

SPEC_NAME = "spec.json"


def _wal_files(directory: Path) -> List[Path]:
    return sorted(Path(directory).glob("wal_*.log"))


class Durability:
    """Journal + snapshot series for one ``COAXIndex``.

    Build via ``Durability.attach`` (fresh directory) or implicitly through
    ``storage.restore(..., durable=True)`` (crash recovery).  The plane
    holds a reference to its index (``checkpoint`` snapshots it) and the
    index holds ``self`` as ``.durable`` — attached means journaling.
    """

    def __init__(self, index: COAXIndex, directory: Union[str, Path],
                 keep: int = 3, sync_every_op: bool = False):
        self.index = index
        self.directory = Path(directory)
        self.keep = int(keep)
        self.sync_every_op = bool(sync_every_op)
        self.wal: Optional[WriteAheadLog] = None
        self._suppress_append = False    # True only while replaying (§7.4)
        self._replaying = False          # defers rotation disk work (§7.5)
        self._suppress_ship = False      # True while re-journaling the §5.4
                                         # handoff tail (replicas pull it
                                         # via catch-up fetch instead, §8.4)
        self.last_snapshot_path: Optional[Path] = None
        self.last_snapshot_wal_seq = 0
        self.last_snapshot_bytes = 0
        # Replication hooks (DESIGN.md §8): a ReplicationHub subscribes by
        # setting these.  frame_observer(epoch, seq, kind, payload) fires on
        # every journaled record; rotate_observer(old_epoch, old_final_seq,
        # new_epoch, relearned) fires inside the §7.5 rotation, after the
        # new epoch's snapshot+WAL are published and before old WALs die.
        self.frame_observer = None
        self.rotate_observer = None

    def _open_wal(self, path: Path, epoch: int,
                  start_seq: int = 0) -> WriteAheadLog:
        """Every WAL this plane appends to routes records through
        ``_frame_appended`` so a subscribed shipper sees rotations and
        replays transparently (replayed records are NOT re-shipped — the
        replica protocol reseeds instead, §8.4)."""
        wal = WriteAheadLog(path, epoch, start_seq=start_seq)
        wal.observer = self._frame_appended
        return wal

    def _frame_appended(self, epoch: int, seq: int, kind: int,
                        payload: bytes) -> None:
        if (self.frame_observer is not None and not self._replaying
                and not self._suppress_ship):
            self.frame_observer(epoch, seq, kind, payload)

    # ------------------------------------------------------------------ #
    @classmethod
    def attach(cls, index: COAXIndex, directory: Union[str, Path],
               keep: int = 3, sync_every_op: bool = False) -> "Durability":
        """Start journaling ``index`` under a fresh (or snapshot-only)
        directory: publish a full-state snapshot of the CURRENT state at
        journal position 0 and open the epoch's WAL.  A directory that
        already holds journal records belongs to ``storage.restore`` —
        attaching over it would fork history, so it is refused."""
        directory = Path(directory)
        wal_file = wal_path(directory, index.epoch)
        if wal_file.exists():
            records, _, intact = read_wal(wal_file, expect_epoch=index.epoch)
            if records:
                raise ValueError(
                    f"{wal_file} already holds {len(records)} journal "
                    f"records; use storage.restore(durable=True) instead "
                    f"of re-attaching over live history")
            if intact < wal_file.stat().st_size:
                # recordless torn tail (a first append died mid-write):
                # cut it, or everything appended after it is unreadable
                os.truncate(wal_file, intact)
        entries = atomic.complete_entries(directory, SNAPSHOT_PREFIX,
                                          MANIFEST_NAME)
        if entries and entries[-1][0] > (index.epoch, 0):
            # a newer-keyed snapshot would shadow everything we write
            raise ValueError(
                f"{directory} already holds snapshot "
                f"{entries[-1][1].name}, newer than this index's "
                f"(epoch={index.epoch}, wal_seq=0); restore from it or "
                f"attach to a fresh directory")
        dur = cls(index, directory, keep=keep, sync_every_op=sync_every_op)
        dur._record_snapshot(write_snapshot(index, directory, wal_seq=0,
                                            keep=keep), 0)
        dur.wal = dur._open_wal(wal_file, index.epoch, start_seq=0)
        index.durable = dur
        return dur

    def _record_snapshot(self, path: Path, wal_seq: int) -> None:
        self.last_snapshot_path = path
        self.last_snapshot_wal_seq = int(wal_seq)
        self.last_snapshot_bytes = snapshot_nbytes(path)

    # ------------------------------------------------------------------ #
    # Write-path hooks (called by COAXIndex.insert/delete/compact)
    # ------------------------------------------------------------------ #
    def log_insert(self, rows: np.ndarray, ids: np.ndarray) -> None:
        if self._suppress_append:
            return
        self.wal.append_insert(rows, ids)
        if self.sync_every_op:
            self.wal.sync()

    def log_delete(self, ids: np.ndarray) -> None:
        if self._suppress_append:
            return
        self.wal.append_delete(ids)
        if self.sync_every_op:
            self.wal.sync()

    def on_compact(self, index: COAXIndex) -> None:
        """Rotate at the compaction boundary (§7.5).  Ordering is the crash
        contract: (1) publish the new epoch snapshot — from here recovery
        prefers it and ignores older WALs; (2) open the new epoch's WAL;
        (3) only then delete older WAL files.  A crash before (1) replays
        the old pair and deterministically re-fires this compaction; a
        crash between any later pair leaves a complete (snapshot, WAL)
        prefix.

        Mid-REPLAY compactions do nothing here: the WAL being replayed is
        still the authoritative journal of every op, so rotating (and
        deleting it) before the tail is re-applied would strand fsynced
        ops in memory if recovery itself crashed.  ``finish_replay``
        republishes the rotated state in one crash-safe pass at the end."""
        if self._replaying:
            return
        with obs.span("wal.rotate", epoch=index.epoch, mode="sync"):
            self._record_snapshot(
                write_snapshot(index, self.directory, wal_seq=0,
                               keep=self.keep), 0)
            old = self.wal
            self.wal = self._open_wal(wal_path(self.directory, index.epoch),
                                      index.epoch, start_seq=0)
            if old is not None:
                old.close()
            if self.rotate_observer is not None:
                # mid-rotation ship point (§8.2): the new epoch pair is live
                # on disk, the old WALs are not yet deleted — a crash raised
                # from the observer models "primary died mid-rotation"
                self.rotate_observer(
                    old.epoch if old is not None else index.epoch - 1,
                    old.next_seq if old is not None else 0,
                    index.epoch,
                    bool(getattr(index, "_last_compact_relearned", False)))
            for p in _wal_files(self.directory):
                if p != self.wal.path:
                    p.unlink(missing_ok=True)
        obs.get_registry().counter(
            "coax_wal_rotations_total", "WAL epoch rotations.",
            ("mode",)).inc(mode="sync")

    def handoff_rotate(self, index: COAXIndex, replay_tail,
                       relearned: bool) -> None:
        """Rotate at a BACKGROUND-compaction handoff (DESIGN.md §5.4): the
        index has already installed the built epoch (empty deltas), but the
        writes admitted during the build still live only in the OLD WAL.
        Ordering is the crash contract:

        1. open the new epoch's WAL (unlinking torn leftovers of a crashed
           prior handoff);
        2. run ``replay_tail`` — the index re-applies the recorded tail
           through its ordinary write paths, which journals each op into
           the new WAL.  Frame shipping is suppressed for these records: a
           replica rotates at the trigger record it replayed itself and
           pulls the re-journaled tail via catch-up ``fetch`` (§8.4), so
           ``total_writes`` never double-counts the tail;
        3. fsync the new WAL, THEN publish the new epoch snapshot stamped
           past the tail — from here recovery prefers the new pair;
        4. only then delete older WAL files.

        A crash before (3)'s snapshot lands recovers from the old pair:
        its WAL still holds the trigger record and the full tail, replay
        re-fires this compaction deterministically (sync, §7.3) and
        ``finish_replay`` unlinks the partial new WAL.  Mid-replay
        handoffs cannot happen (replay forces synchronous compaction)."""
        if self._replaying:            # defensive: replay is sync-only
            return
        with obs.span("wal.rotate", epoch=index.epoch, mode="handoff"):
            old = self.wal
            fresh = wal_path(self.directory, index.epoch)
            fresh.unlink(missing_ok=True)  # torn leftovers of a crashed
            self.wal = self._open_wal(fresh, index.epoch, start_seq=0)
            self._suppress_ship = True
            try:
                replay_tail()
            finally:
                self._suppress_ship = False
            self.wal.sync()
            if old is not None:
                old.close()
            self._record_snapshot(
                write_snapshot(index, self.directory,
                               wal_seq=self.wal.next_seq, keep=self.keep),
                self.wal.next_seq)
            if self.rotate_observer is not None:
                # same mid-rotation ship point as ``on_compact`` (§8.2)
                self.rotate_observer(
                    old.epoch if old is not None else index.epoch - 1,
                    old.next_seq if old is not None else 0,
                    index.epoch, bool(relearned))
            for p in _wal_files(self.directory):
                if p != self.wal.path:
                    p.unlink(missing_ok=True)
        obs.get_registry().counter(
            "coax_wal_rotations_total", "WAL epoch rotations.",
            ("mode",)).inc(mode="handoff")

    def finish_replay(self, tail_records) -> None:
        """Deferred rotation after a replay that crossed >=1 compaction
        (§7.5): the replayed WAL stayed untouched throughout, so every
        crash inside replay was a pure retry.  Now converge disk to the
        replayed state: (1) write the current epoch's WAL fresh with the
        records applied AFTER the last compaction (fsynced); (2) publish a
        full-state snapshot stamped past them; (3) only then delete older
        WAL files.  A crash before (2) re-recovers from the old pair —
        deterministically reaching this same point — and a crash after (2)
        recovers from the new pair directly."""
        old = self.wal
        fresh = wal_path(self.directory, self.index.epoch)
        fresh.unlink(missing_ok=True)      # torn leftovers of a crashed pass
        self.wal = self._open_wal(fresh, self.index.epoch, start_seq=0)
        for rec in tail_records:
            if rec.kind == OP_INSERT:
                self.wal.append_insert(rec.rows, rec.ids)
            else:
                self.wal.append_delete(rec.ids)
        self.wal.sync()
        if old is not None:
            old.close()                    # superseded; deleted below
        self._record_snapshot(
            write_snapshot(self.index, self.directory,
                           wal_seq=self.wal.next_seq, keep=self.keep),
            self.wal.next_seq)
        for p in _wal_files(self.directory):
            if p != self.wal.path:
                p.unlink(missing_ok=True)

    # ------------------------------------------------------------------ #
    def sync(self) -> None:
        """fsync the WAL tail — the wave-boundary durability point."""
        if self.wal is not None:
            self.wal.sync()

    def checkpoint(self, keep: Optional[int] = None) -> Path:
        """Publish a mid-epoch full-state snapshot stamped with the current
        journal position; replay after a crash then starts at this op
        instead of the epoch's beginning.  The WAL file itself is never cut
        mid-epoch (truncation happens only at rotation, §7.5).  ``keep``
        overrides the attach-time retention for this one call (the
        ``save(directory, keep=...)`` path).

        An in-flight §5.4 background build is folded in first: a snapshot
        taken mid-build would otherwise become a restore base from which
        the build's deterministic re-fire diverges (the freeze set is
        already fixed, but the checkpoint would split the tail across the
        rotation boundary)."""
        fh = getattr(self.index, "finish_handoff", None)
        if fh is not None:
            fh()
        self.sync()
        seq = self.wal.next_seq
        if (keep is None and self.last_snapshot_path is not None
                and self.last_snapshot_wal_seq == seq
                and self.last_snapshot_path.exists()):
            return self.last_snapshot_path    # nothing new to absorb
        with obs.span("durability.checkpoint", wal_seq=seq):
            path = write_snapshot(self.index, self.directory, wal_seq=seq,
                                  keep=self.keep if keep is None else keep)
        obs.get_registry().counter(
            "coax_checkpoints_total", "Mid-epoch checkpoint snapshots.").inc()
        self._record_snapshot(path, seq)
        return path

    def close(self) -> None:
        """fsync the WAL tail and release the handle.  Idempotent: a second
        ``close()`` — or a close after a failed rotation left a dead handle
        behind — is a no-op instead of raising from cleanup
        (``WriteAheadLog.close`` carries the guard)."""
        if self.wal is not None:
            self.wal.close()

    @property
    def closed(self) -> bool:
        return self.wal is None or self.wal.closed

    # ------------------------------------------------------------------ #
    @property
    def wal_pending_bytes(self) -> int:
        return self.wal.pending_bytes if self.wal is not None else 0

    def describe(self) -> dict:
        return {
            "directory": str(self.directory),
            "epoch": self.wal.epoch if self.wal is not None else None,
            "wal_records": self.wal.next_seq if self.wal is not None else 0,
            "wal_bytes": self.wal.nbytes() if self.wal is not None else 0,
            "wal_pending_bytes": self.wal_pending_bytes,
            "wal_pending_records": (self.wal.pending_records
                                    if self.wal is not None else 0),
            "last_snapshot_epoch": (self.index.epoch
                                    if self.last_snapshot_path else None),
            "last_snapshot_wal_seq": self.last_snapshot_wal_seq,
            "last_snapshot_bytes": self.last_snapshot_bytes,
            "snapshots": len(atomic.complete_entries(
                self.directory, SNAPSHOT_PREFIX, MANIFEST_NAME)),
        }


# --------------------------------------------------------------------- #
# Recovery
# --------------------------------------------------------------------- #
def _replay(index: COAXIndex, directory: Path, durable: bool,
            keep: int, sync_every_op: bool, start_seq: int) -> int:
    """Replay the WAL tail of ``index.epoch`` through the ordinary write
    paths; returns the number of records applied.  The WAL file is never
    mutated while it is being replayed — it stays the authoritative
    journal, so a crash anywhere inside replay is a pure retry (§7.4).
    With ``durable`` the plane is attached first (append suppressed); if
    the replay crossed a compaction, ``finish_replay`` converges disk to
    the rotated state in one crash-safe pass afterwards (§7.5)."""
    wfile = wal_path(directory, index.epoch)
    records, next_seq, intact = read_wal(wfile, expect_epoch=index.epoch)
    dur = None
    if durable:
        if wfile.exists() and intact < wfile.stat().st_size:
            os.truncate(wfile, intact)    # drop the torn tail before appending
        dur = Durability(index, directory, keep=keep,
                         sync_every_op=sync_every_op)
        dur.wal = dur._open_wal(wfile, index.epoch, start_seq=next_seq)
        dur._suppress_append = True
        dur._replaying = True
        latest = latest_snapshot(directory)
        if latest is not None:
            dur._record_snapshot(latest, read_manifest(latest)["wal_seq"])
        index.durable = dur
    applied = []
    tail_start = 0
    epoch_before = cur_epoch = index.epoch
    # replay is sync-only (§7.3): a replayed op that trips the compaction
    # trigger must compact HERE, not kick off a §5.4 background build —
    # also covers durable=False (read-only) loads, where no plane's
    # ``_replaying`` flag exists to force it
    sync_flag = hasattr(index, "_in_handoff_replay")
    if sync_flag:
        index._in_handoff_replay = True
    try:
        for rec in records:
            if rec.seq < start_seq:
                continue                  # already folded into the snapshot
            if rec.kind == OP_INSERT:
                index.insert(rec.rows, ids=rec.ids)
            else:
                index.delete(rec.ids)
            applied.append(rec)
            if index.epoch != cur_epoch:  # a replayed op re-fired compaction
                cur_epoch = index.epoch
                tail_start = len(applied)  # later ops belong to the new WAL
    finally:
        if sync_flag:
            index._in_handoff_replay = False
    if dur is not None:
        dur._replaying = False
        dur._suppress_append = False
        if cur_epoch != epoch_before:
            dur.finish_replay(applied[tail_start:])
        else:
            dur.sync()
    return len(applied)


def _restore_single(directory: Path, backend: str,
                    device_opts: Optional[dict], durable: bool,
                    keep: int, sync_every_op: bool,
                    device: str = "cuda") -> COAXIndex:
    if durable:
        # half-staged checkpoint litter from the crash (this is also the
        # sweep for each shard_<k>/ of a sharded recovery)
        atomic.sweep_stale_tmp(directory)
    snap = latest_snapshot(directory)
    if snap is None:
        raise FileNotFoundError(f"no complete snapshot under {directory}")
    # recovery's two costs apart (the §10.2 spans a restart is read from)
    with obs.span("snapshot.load", path=snap.name):
        index, manifest = load_snapshot(snap, backend=backend,
                                        device_opts=device_opts,
                                        device=device)
    with obs.span("wal.replay", epoch=index.epoch) as sp:
        n = _replay(index, directory, durable, keep, sync_every_op,
                    start_seq=int(manifest["wal_seq"]))
        if sp is not None:
            sp.args["records"] = n
    if durable:
        # stale WALs of older epochs (rotation crash window) are dead weight
        live = wal_path(directory, index.epoch)
        for p in _wal_files(directory):
            if p != live:
                p.unlink(missing_ok=True)
    return index


class ShardedDurability:
    """Per-shard durability planes + the partitioner spec for a
    ``ShardedCOAX`` (DESIGN.md §7.6).  Each shard journals independently
    under ``shard_<k>/``; the spec pins what queries cannot recompute —
    partitioner kind/dim, frozen range boundaries and the checkpointed
    global id high-water mark."""

    def __init__(self, sharded, directory: Union[str, Path]):
        self.sharded = sharded
        self.directory = Path(directory)

    @staticmethod
    def shard_dir(directory: Union[str, Path], k: int) -> Path:
        return Path(directory) / f"shard_{k:02d}"

    # ------------------------------------------------------------------ #
    @classmethod
    def attach(cls, sharded, directory: Union[str, Path], keep: int = 3,
               sync_every_op: bool = False) -> "ShardedDurability":
        directory = Path(directory)
        dur = cls(sharded, directory)
        dur.write_spec()
        for k, shard in enumerate(sharded.shards):
            Durability.attach(shard, cls.shard_dir(directory, k), keep=keep,
                              sync_every_op=sync_every_op)
        sharded.durable = dur
        return dur

    def write_spec(self) -> None:
        s = self.sharded
        spec = {
            "format": "sharded-coax-spec",
            "version": 1,
            "kind": "sharded",
            "time": time.time(),
            "n_shards": s.n_shards,
            "partition": s.partition,
            "partition_dim": s.partition_dim,
            "boundaries": (None if s._boundaries is None
                           else [float(b) for b in s._boundaries]),
            "next_id": int(s._next_id),
            "n_dims": s.n_dims,
        }
        atomic.replace_file(self.directory / SPEC_NAME,
                            json.dumps(spec, indent=2).encode())

    # ------------------------------------------------------------------ #
    def sync(self) -> None:
        for shard in self.sharded.shards:
            if shard.durable is not None:
                shard.durable.sync()

    def checkpoint(self, keep: Optional[int] = None) -> List[Path]:
        """Checkpoint every shard and re-pin the global id high-water mark
        in the spec (restore takes the max of spec and shard values, so a
        stale spec only ever understates — never aliases an id)."""
        paths = [shard.durable.checkpoint(keep=keep)
                 for shard in self.sharded.shards
                 if shard.durable is not None]
        self.write_spec()
        return paths

    def close(self) -> None:
        """fsync + close every shard's WAL; idempotent like the per-shard
        ``Durability.close`` it fans out to."""
        for shard in self.sharded.shards:
            if shard.durable is not None:
                shard.durable.close()

    @property
    def closed(self) -> bool:
        return all(shard.durable is None or shard.durable.closed
                   for shard in self.sharded.shards)

    @property
    def wal_pending_bytes(self) -> int:
        return sum(shard.durable.wal_pending_bytes
                   for shard in self.sharded.shards
                   if shard.durable is not None)

    def describe(self) -> dict:
        per_shard = [shard.durable.describe() if shard.durable is not None
                     else None for shard in self.sharded.shards]
        return {
            "directory": str(self.directory),
            "wal_records": sum(d["wal_records"] for d in per_shard if d),
            "wal_bytes": sum(d["wal_bytes"] for d in per_shard if d),
            "wal_pending_bytes": self.wal_pending_bytes,
            "last_snapshot_bytes": sum(d["last_snapshot_bytes"]
                                       for d in per_shard if d),
            "per_shard": per_shard,
        }


def _restore_sharded(directory: Path, backend: str,
                     device_opts: Optional[dict], durable: bool,
                     keep: int, sync_every_op: bool, device: str = "cuda"):
    from ..engine.sharded import ShardedCOAX

    spec = json.loads((directory / SPEC_NAME).read_text())
    if spec.get("format") != "sharded-coax-spec":
        raise ValueError(f"{directory / SPEC_NAME} is not a partitioner spec")
    shards = [
        _restore_single(ShardedDurability.shard_dir(directory, k), backend,
                        device_opts, durable, keep, sync_every_op, device)
        for k in range(int(spec["n_shards"]))
    ]
    sharded = ShardedCOAX._restore_parts(spec, shards, backend=backend)
    if durable:
        sharded.durable = ShardedDurability(sharded, directory)
    return sharded


def restore(directory: Union[str, Path], backend: str = "device",
            device_opts: Optional[dict] = None, durable: bool = False,
            keep: int = 3, sync_every_op: bool = False,
            device: str = "cuda"):
    """Recover an index from a durability directory (DESIGN.md §7.4).

    Sniffs the layout: a ``spec.json`` means a ``ShardedCOAX`` (per-shard
    recovery + partitioner spec), otherwise a single ``COAXIndex``
    (newest complete snapshot + WAL-tail replay).  ``durable=False`` is a
    strictly read-only load — the cold-start-replica path: nothing in the
    directory is modified, and the returned index does not journal.
    ``durable=True`` re-attaches the plane (truncating any torn WAL tail
    first) so the index resumes journaling at the recovered position.

    The recovered index serves from ``backend`` on the torch ``device``
    (``"cuda"`` by default); asked for the device backend on a device that
    is absent, ``restore`` raises before it reads or changes anything.  The
    device plan itself is built at the first device wave.
    """
    require_device(backend, device)
    directory = Path(directory)
    if durable:
        atomic.sweep_stale_tmp(directory)
    if (directory / SPEC_NAME).exists():
        return _restore_sharded(directory, backend, device_opts, durable,
                                keep, sync_every_op, device)
    return _restore_single(directory, backend, device_opts, durable,
                           keep, sync_every_op, device)
