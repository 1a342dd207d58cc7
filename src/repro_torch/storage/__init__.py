"""Durability plane: versioned snapshots + write-ahead log + bit-identical
crash recovery (DESIGN.md §7).

The memory-only serving planes (batched engine §2, device backend §4,
delta/compaction lifecycle §5, sharded scatter-gather §6) all die with the
process; this package makes them restartable:

``atomic``      — the staged-rename / newest-complete-manifest /
                  bounded-retention idiom (§7.1)
``snapshot``    — versioned ``manifest.json`` + ``arrays.npz`` serialisation
                  of a full ``COAXIndex`` state (§7.3)
``wal``         — framed, epoch-stamped, torn-tail-tolerant write-ahead log
                  (§7.2)
``durability``  — the plane itself: attach/rotate/checkpoint/sync, sharded
                  layout, and ``restore`` = snapshot + WAL replay ≡ the
                  never-crashed index, bit for bit (§7.4)

Everything here is numpy + stdlib: the on-disk format (npz arrays plus a
JSON manifest, framed WAL records) is the reference package's byte for
byte, so a snapshot and WAL written by either package restore in the
other.  A restored index builds its device plan lazily, at its first
device wave; ``restore`` asked for the device backend on a missing card
raises before it reads anything.
"""
from . import atomic
from .snapshot import (latest_snapshot, load_snapshot, read_manifest,
                       snapshot_nbytes, write_snapshot)
from .wal import (WalFrameCursor, WalRecord, WriteAheadLog, decode_record,
                  read_wal, wal_path)
from .durability import Durability, ShardedDurability, restore

__all__ = [
    "atomic",
    "write_snapshot",
    "load_snapshot",
    "latest_snapshot",
    "read_manifest",
    "snapshot_nbytes",
    "WriteAheadLog",
    "WalFrameCursor",
    "WalRecord",
    "decode_record",
    "read_wal",
    "wal_path",
    "Durability",
    "ShardedDurability",
    "restore",
]
