"""Shipped-frame codec for WAL replication (DESIGN.md §8.2).

A shipped frame wraps one unit of the primary's history in its own
CRC-guarded envelope, so a frame torn or corrupted IN TRANSIT is detected
at the replica independently of the on-disk WAL framing:

    frame := magic "CSF1" | u8 kind | u64 epoch | u64 seq
             | u32 payload_len | u32 crc32(payload) | payload

Kinds
-----
``F_WRITE``      — one WAL record.  ``(epoch, seq)`` are the record's WAL
    coordinates; the payload is ``u8 wal_kind | wal_payload`` — the EXACT
    bytes the journal holds, so the replica decodes with the appender's
    arithmetic (``storage.wal.decode_record``) and applies through the
    ordinary ``insert(rows, ids=...)`` / ``delete`` paths.
``F_ROTATE``     — the compaction control frame.  Keyed at
    ``(old_epoch, old_final_seq)`` — i.e. exactly where the next in-order
    frame slot of the old epoch would be — so the reorder buffer sequences
    it for free.  Payload carries ``new_epoch`` and whether the primary's
    compaction relearned FDs; a replica whose own §5 trigger already fired
    treats it as absorbed, one that rotated manually on the primary
    replays ``compact(relearn=...)`` verbatim (§8.2 epoch handoff).
``F_HEARTBEAT``  — primary liveness + shipped frontier
    ``(epoch, seq == records logged this epoch)`` plus a wall timestamp;
    replicas date their health from it and measure lag against it.

All integers little-endian, like the WAL format this protocol extends.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

__all__ = ["Frame", "FrameError", "encode_frame", "decode_frame",
           "frame_nbytes", "write_frame", "rotate_frame", "heartbeat_frame",
           "unpack_write", "unpack_rotate", "unpack_heartbeat",
           "F_WRITE", "F_ROTATE", "F_HEARTBEAT"]

_MAGIC = b"CSF1"
_HDR = struct.Struct("<4sBQQII")      # magic, kind, epoch, seq, plen, crc
_ROTATE_PAYLOAD = struct.Struct("<QB")    # new_epoch, relearned
_HEARTBEAT_PAYLOAD = struct.Struct("<d")  # send time (time.time())

F_WRITE = 1
F_ROTATE = 2
F_HEARTBEAT = 3


class FrameError(ValueError):
    """Torn, truncated or corrupt shipped frame — the transit-damage signal
    a replica counts and repairs via catch-up (never by guessing)."""


@dataclasses.dataclass(frozen=True)
class Frame:
    kind: int
    epoch: int
    seq: int
    payload: bytes

    @property
    def key(self):
        """Total order of the shipped stream: ``(epoch, seq)``."""
        return (self.epoch, self.seq)


def encode_frame(frame: Frame) -> bytes:
    return _HDR.pack(_MAGIC, frame.kind, frame.epoch, frame.seq,
                     len(frame.payload),
                     zlib.crc32(frame.payload) & 0xFFFFFFFF) + frame.payload


def frame_nbytes(frame: Frame) -> int:
    """Encoded wire size of ``frame`` — the unit of byte-lag accounting."""
    return _HDR.size + len(frame.payload)


def decode_frame(data: bytes) -> Frame:
    """Decode one shipped frame; raises ``FrameError`` on any damage —
    short header, bad magic, short payload, trailing garbage, CRC
    mismatch — exactly the failures in-flight truncation produces."""
    if len(data) < _HDR.size:
        raise FrameError(f"frame truncated to {len(data)} bytes")
    magic, kind, epoch, seq, plen, crc = _HDR.unpack_from(data, 0)
    if magic != _MAGIC:
        raise FrameError("bad frame magic")
    if len(data) != _HDR.size + plen:
        raise FrameError(f"frame payload {len(data) - _HDR.size} bytes, "
                         f"header says {plen}")
    payload = data[_HDR.size:]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameError("frame payload CRC mismatch")
    return Frame(kind=kind, epoch=epoch, seq=seq, payload=payload)


# --------------------------------------------------------------------- #
# Constructors for the three frame kinds
# --------------------------------------------------------------------- #
def write_frame(epoch: int, seq: int, wal_kind: int, wal_payload: bytes) -> Frame:
    """Wrap one WAL record (exact journal bytes) for shipping."""
    return Frame(F_WRITE, epoch, seq, bytes([wal_kind]) + wal_payload)


def unpack_write(frame: Frame):
    """-> (wal_kind, wal_payload)."""
    return frame.payload[0], frame.payload[1:]


def rotate_frame(old_epoch: int, old_final_seq: int, new_epoch: int,
                 relearned: bool) -> Frame:
    return Frame(F_ROTATE, old_epoch, old_final_seq,
                 _ROTATE_PAYLOAD.pack(new_epoch, int(bool(relearned))))


def unpack_rotate(frame: Frame):
    """-> (new_epoch, relearned)."""
    new_epoch, relearned = _ROTATE_PAYLOAD.unpack(frame.payload)
    return int(new_epoch), bool(relearned)


def heartbeat_frame(epoch: int, seq: int, now: float) -> Frame:
    return Frame(F_HEARTBEAT, epoch, seq, _HEARTBEAT_PAYLOAD.pack(now))


def unpack_heartbeat(frame: Frame) -> float:
    """-> primary send time."""
    return float(_HEARTBEAT_PAYLOAD.unpack(frame.payload)[0])
