"""Write-ahead log: framed, epoch-stamped, torn-tail tolerant (DESIGN.md §7.2).

One WAL file exists per snapshot epoch (``wal_<epoch>.log``) and records the
index's write stream SINCE that epoch, in arrival order:

    file   := header record*
    header := magic "CWH1" | u32 format version | u64 epoch
    record := magic "CWR1" | u64 seq | u8 kind | u32 payload_len
              | u32 crc32(payload) | payload
    insert payload := u32 n_rows | u32 n_dims | rows f32[n*d] | ids i64[n]
    delete payload := u32 n_ids  | ids i64[n]

All integers little-endian.  Rows are logged as the exact float32 bytes the
in-memory path stores, and insert records carry the ASSIGNED ids, so replay
through the ordinary ``COAXIndex.insert(rows, ids=...)`` / ``delete`` paths
reproduces the live index bit for bit — including the Bayesian drift
trackers, because one record per ``insert()`` call preserves the exact
batch boundaries and arrival order the tracker accumulations folded in
(DESIGN.md §7.4 recovery ≡ replay argument).

Failure contract: appends go straight to the OS (``write``+``flush``) but
are NOT fsynced per record; ``sync()`` fsyncs and is called by
``QueryServer`` at wave boundaries — so the durable frontier advances in
the same per-wave steps as the server's snapshot semantics (§7.2 fsync
contract), and ``pending_bytes`` is exactly the at-risk tail.  The reader
treats ANY malformed tail — truncated header, short payload, CRC or magic
or sequence mismatch — as a torn write: replay stops at the last intact
record and ``Durability`` truncates the torn bytes before appending again.

Replication (DESIGN.md §8): the WAL is also the replication log.
``WalFrameCursor`` reads a WAL file's records incrementally from a
sequence position (the pull/catch-up path): an incomplete tail merely pauses the cursor — the
bytes may still be in flight from a concurrent appender — so re-reading
later resumes where it stopped, while genuinely torn bytes pause it
forever at the last intact record, exactly like ``read_wal``.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time
import zlib
from pathlib import Path
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np

from .. import obs

__all__ = ["WalRecord", "WriteAheadLog", "WalFrameCursor", "read_wal",
           "wal_path", "decode_record", "OP_INSERT", "OP_DELETE"]

_FILE_MAGIC = b"CWH1"
_REC_MAGIC = b"CWR1"
_FORMAT_VERSION = 1
_FILE_HDR = struct.Struct("<4sIQ")      # magic, version, epoch
_REC_HDR = struct.Struct("<4sQBII")     # magic, seq, kind, payload_len, crc

OP_INSERT = 1
OP_DELETE = 2


def wal_path(directory: Union[str, Path], epoch: int) -> Path:
    return Path(directory) / f"wal_{epoch:08d}.log"


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One decoded write op.  ``rows`` is None for deletes."""
    seq: int
    kind: int
    rows: Optional[np.ndarray]      # (n, d) float32, insert only
    ids: np.ndarray                 # (n,) int64: assigned (insert) or requested (delete)


def _encode_insert(rows: np.ndarray, ids: np.ndarray) -> bytes:
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    return (struct.pack("<II", rows.shape[0], rows.shape[1])
            + rows.tobytes() + ids.tobytes())


def _encode_delete(ids: np.ndarray) -> bytes:
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    return struct.pack("<I", ids.shape[0]) + ids.tobytes()


def _decode(kind: int, payload: bytes) -> Tuple[Optional[np.ndarray], np.ndarray]:
    if kind == OP_INSERT:
        n, d = struct.unpack_from("<II", payload, 0)
        off = 8
        rows = np.frombuffer(payload, np.float32, n * d, off).reshape(n, d)
        ids = np.frombuffer(payload, np.int64, n, off + n * d * 4)
        return rows.copy(), ids.copy()
    if kind == OP_DELETE:
        (n,) = struct.unpack_from("<I", payload, 0)
        return None, np.frombuffer(payload, np.int64, n, 4).copy()
    raise ValueError(f"unknown WAL op kind {kind}")


def decode_record(kind: int, payload: bytes) -> Tuple[Optional[np.ndarray],
                                                      np.ndarray]:
    """Decode one record payload -> ``(rows, ids)`` (rows None for deletes).
    The public face of the record codec — replicas shipping raw WAL frames
    (DESIGN.md §8) decode them with exactly the appender's arithmetic."""
    return _decode(kind, payload)


class WriteAheadLog:
    """Appender for one epoch's WAL file.

    Opens in append mode, creating the file (with its epoch-stamped header)
    when absent.  ``start_seq`` must be the sequence number of the next
    record — callers opening an existing file pass the count of intact
    records already in it (``read_wal``'s ``next_seq``), after truncating
    any torn tail to ``intact_bytes``.
    """

    def __init__(self, path: Union[str, Path], epoch: int, start_seq: int = 0):
        self.path = Path(path)
        self.epoch = int(epoch)
        self.next_seq = int(start_seq)
        self.pending_bytes = 0          # appended since the last fsync
        self.pending_records = 0
        fresh = not self.path.exists()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "ab")
        if fresh or self._f.tell() == 0:
            self._f.write(_FILE_HDR.pack(_FILE_MAGIC, _FORMAT_VERSION, self.epoch))
            self._f.flush()

    # ------------------------------------------------------------------ #
    def _append(self, kind: int, payload: bytes) -> int:
        hdr = _REC_HDR.pack(_REC_MAGIC, self.next_seq, kind, len(payload),
                            zlib.crc32(payload) & 0xFFFFFFFF)
        with obs.span("wal.append", seq=self.next_seq, kind=kind,
                      nbytes=len(hdr) + len(payload)):
            self._f.write(hdr)
            self._f.write(payload)
            self._f.flush()             # reaches the OS; fsync is sync()'s job
        self.next_seq += 1
        self.pending_bytes += len(hdr) + len(payload)
        self.pending_records += 1
        g = obs.get_registry()
        g.counter("coax_wal_appends_total", "WAL records appended").inc()
        g.counter("coax_wal_bytes_total", "WAL bytes appended").inc(
            len(hdr) + len(payload))
        return self.next_seq - 1

    def append_insert(self, rows: np.ndarray, ids: np.ndarray) -> int:
        """Log one ``insert()`` call (rows with their assigned ids); returns
        the record's sequence number."""
        return self._append(OP_INSERT, _encode_insert(rows, ids))

    def append_delete(self, ids: np.ndarray) -> int:
        """Log one ``delete()`` call (the requested ids, verbatim)."""
        return self._append(OP_DELETE, _encode_delete(ids))

    def sync(self) -> None:
        """fsync the appended tail — the per-wave durability point.  Safe on
        an already-closed handle: a closed file has either synced its tail
        (orderly ``close``) or lost the handle to a failed rotation — both
        cases where raising from a cleanup path helps nobody."""
        if self.pending_bytes and not self._f.closed:
            t0 = time.perf_counter()
            with obs.span("wal.fsync", nbytes=self.pending_bytes):
                self._f.flush()
                os.fsync(self._f.fileno())
            g = obs.get_registry()
            g.counter("coax_wal_fsync_total", "WAL fsyncs").inc()
            g.histogram("coax_wal_fsync_seconds",
                        "WAL tail fsync latency").observe(
                            time.perf_counter() - t0)
            obs.stage_hist().observe(time.perf_counter() - t0,
                                     stage="fsync", backend="numpy")
            self.pending_bytes = 0
            self.pending_records = 0

    def nbytes(self) -> int:
        """Total WAL bytes on disk (header + records appended so far)."""
        return self.path.stat().st_size if self._f.closed else self._f.tell()

    @property
    def closed(self) -> bool:
        return self._f.closed

    def close(self) -> None:
        """fsync the tail, then close.  Idempotent: double-close (and close
        after a failed rotation left the handle dead) is a no-op."""
        if not self._f.closed:
            self.sync()
            self._f.close()


def read_wal(path: Union[str, Path],
             expect_epoch: Optional[int] = None,
             ) -> Tuple[List[WalRecord], int, int]:
    """Decode every intact record of a WAL file.

    Returns ``(records, next_seq, intact_bytes)``: the complete-prefix
    records, the sequence number an appender should continue from, and the
    byte offset of the first torn/garbage byte (== file size when the file
    is clean).  A missing file reads as empty at epoch ``expect_epoch``.
    Raises only on a wrong FILE header (wrong epoch or magic) — that is a
    wiring bug, not a crash artifact; everything after a valid header
    degrades gracefully to "torn tail".
    """
    path = Path(path)
    if not path.exists():
        return [], 0, 0
    blob = path.read_bytes()
    if len(blob) < _FILE_HDR.size:
        return [], 0, 0                 # torn before the header completed
    magic, version, epoch = _FILE_HDR.unpack_from(blob, 0)
    if magic != _FILE_MAGIC or version != _FORMAT_VERSION:
        raise ValueError(f"{path} is not a v{_FORMAT_VERSION} WAL file")
    if expect_epoch is not None and epoch != expect_epoch:
        raise ValueError(f"{path} holds epoch {epoch}, expected {expect_epoch}")

    records: List[WalRecord] = []
    off = _FILE_HDR.size
    intact = off
    while off + _REC_HDR.size <= len(blob):
        rmagic, seq, kind, plen, crc = _REC_HDR.unpack_from(blob, off)
        end = off + _REC_HDR.size + plen
        if (rmagic != _REC_MAGIC or seq != len(records)
                or end > len(blob)):
            break                       # torn or foreign bytes: stop here
        payload = blob[off + _REC_HDR.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        try:
            rows, ids = _decode(kind, payload)
        except (ValueError, struct.error):
            break
        records.append(WalRecord(seq=seq, kind=kind, rows=rows, ids=ids))
        off = end
        intact = off
    return records, len(records), intact


class WalFrameCursor:
    """Incremental reader of one WAL file's records from a seq position —
    the replica catch-up path (DESIGN.md §8.2): the primary's WAL doubles
    as the retransmission buffer, so a replica that lost shipped frames
    pulls the gap straight out of the journal.

    ``read()`` returns every intact ``(seq, kind, payload)`` appended since
    the last call.  The cursor keeps a byte offset and only ever advances
    past COMPLETE records, so a trailing partial record — an append still
    in flight from a live primary, or a genuinely torn crash tail — just
    pauses it: the next ``read()`` re-examines the same bytes and resumes
    if the record completed.  Foreign bytes / CRC mismatch / seq mismatch
    pause it the same way (and stay paused forever), matching ``read_wal``'s
    torn-tail contract.  A missing file reads as empty.
    """

    def __init__(self, path: Union[str, Path], expect_epoch: Optional[int] = None,
                 start_seq: int = 0):
        self.path = Path(path)
        self.expect_epoch = expect_epoch
        self.next_seq = int(start_seq)
        self._offset: Optional[int] = None    # None until the header is read
        self._skip_seq = int(start_seq)       # records to skip before start_seq

    def read(self, max_records: Optional[int] = None
             ) -> List[Tuple[int, int, bytes]]:
        """Intact ``(seq, kind, payload)`` frames available past the cursor."""
        if not self.path.exists():
            return []
        blob = self.path.read_bytes()
        if self._offset is None:
            if len(blob) < _FILE_HDR.size:
                return []                     # header still incomplete
            magic, version, epoch = _FILE_HDR.unpack_from(blob, 0)
            if magic != _FILE_MAGIC or version != _FORMAT_VERSION:
                raise ValueError(f"{self.path} is not a v{_FORMAT_VERSION} WAL file")
            if self.expect_epoch is not None and epoch != self.expect_epoch:
                raise ValueError(f"{self.path} holds epoch {epoch}, "
                                 f"expected {self.expect_epoch}")
            self._offset = _FILE_HDR.size
            self._seen = 0                    # records parsed from the top
        out: List[Tuple[int, int, bytes]] = []
        off = self._offset
        while off + _REC_HDR.size <= len(blob):
            if max_records is not None and len(out) >= max_records:
                break
            rmagic, seq, kind, plen, crc = _REC_HDR.unpack_from(blob, off)
            end = off + _REC_HDR.size + plen
            if rmagic != _REC_MAGIC or seq != self._seen or end > len(blob):
                break                         # torn / in-flight / foreign tail
            payload = blob[off + _REC_HDR.size:end]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                break
            try:
                _decode(kind, payload)        # validate before advancing
            except (ValueError, struct.error):
                break
            if seq >= self._skip_seq:
                out.append((seq, kind, payload))
                self.next_seq = seq + 1
            self._seen += 1
            off = end
            self._offset = off
        return out
