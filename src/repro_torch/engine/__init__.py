"""Batched query execution engine (DESIGN.md §2, §4, §5).

The per-call path (``COAXIndex.query``) answers one rect per Python
round-trip; this package turns B queries into one translation pass, one
directory probe and one fused scan, and wraps that in an admission/drain
server.  Under the mutable lifecycle (§5) the server also admits
inserts/deletes, flushed at wave boundaries so every wave sees one
snapshot+delta state.

``BatchQueryExecutor`` — wave-sliced ``query_batch`` driver with per-wave stats
``QueryServer``        — submit rects/writes, drain in priority/FIFO waves
``DevicePlan``         — device-resident serving plane for one grid (§4)
``CoaxDevicePlan``     — the COAX plan: primary + outlier + delta/tombstone
                         segments in ONE dispatch of ``fused_scan`` launches
                         per wave, hits compacted into device-resident
                         buffers and drained one wave behind the submit
                         (double-buffered by executor/server)
"""
from .device import CoaxDevicePlan, DevicePlan
from .executor import BatchQueryExecutor, WaveStats, split_hits
from .server import PendingQuery, QueryServer

__all__ = [
    "BatchQueryExecutor",
    "WaveStats",
    "split_hits",
    "QueryServer",
    "PendingQuery",
    "DevicePlan",
    "CoaxDevicePlan",
]
