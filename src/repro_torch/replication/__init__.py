"""Replication plane: WAL-shipped read replicas + health-checked failover
(DESIGN.md §8).

The durability plane (§7) made one process restartable; this package makes
the index SURVIVE the process.  The primary's journal — already a complete,
bit-exact history — doubles as the replication log:

``frames``     — the shipped-frame codec: CRC-guarded envelopes around
                 exact WAL record bytes (``F_WRITE``), the
                 compaction-rotation control frame (``F_ROTATE``), and
                 liveness (``F_HEARTBEAT``)
``transport``  — the socket-shaped delivery contract, its in-process
                 implementation, and ``FaultyTransport``: scripted wire
                 damage (drop / dup / reorder / tear / delay / error)
                 driven by a ``runtime.failure.FaultPlan``
``ship``       — ``ReplicationHub``: the primary-side fan-out hooked into
                 ``storage.Durability``, plus the pull/catch-up and
                 seeding paths (the journal is the retransmission buffer)
``replica``    — ``Replica``: ordered apply through the ordinary write
                 paths; bit-identical at its applied ``(epoch, next_seq)``
                 frontier under ANY fault schedule (§8.7 invariant)
``failover``   — ``ReplicatedServer``: bounded-staleness read routing over
                 healthy replicas, degradation to primary-serves-reads,
                 and no-data-loss promotion of the most-caught-up replica

The protocol is numpy + stdlib and synchronous; only the replicas' reads
touch the card (their device plans, ``replica_backend="device"`` on
``"cuda"`` by default).  Determinism is the point:
one ``FaultPlan`` schedule reproduces an entire partial-failure scenario,
which is what lets the tests assert bit-identity instead of "eventually
looks right".
"""
from .frames import (F_HEARTBEAT, F_ROTATE, F_WRITE, Frame, FrameError,
                     decode_frame, encode_frame, frame_nbytes,
                     heartbeat_frame, rotate_frame, unpack_heartbeat,
                     unpack_rotate, unpack_write, write_frame)
from .transport import (FaultyTransport, InProcTransport, Transport,
                        TransportError)
from .ship import ReplicationHub, seed_state
from .replica import Replica, ReplicationError
from .failover import ReplicatedServer

__all__ = [
    "Frame", "FrameError", "F_WRITE", "F_ROTATE", "F_HEARTBEAT",
    "encode_frame", "decode_frame", "frame_nbytes", "write_frame",
    "rotate_frame", "heartbeat_frame", "unpack_write", "unpack_rotate",
    "unpack_heartbeat",
    "Transport", "InProcTransport", "FaultyTransport", "TransportError",
    "ReplicationHub", "seed_state",
    "Replica", "ReplicationError",
    "ReplicatedServer",
]
