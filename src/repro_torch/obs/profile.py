"""Device profiling hooks (DESIGN.md §10.2, profiling layer).

``profile(logdir)`` gates an optional ``torch.profiler`` trace capture
around a block of device waves — the host and CUDA timelines land in
``logdir/trace.json`` (Chrome trace format, readable in Perfetto).  The
context is a strict no-op (and never raises) when the profiler is
unavailable or a capture is already active, so call sites can wrap hot
paths unconditionally.  The cheap per-wave counters (``transfer_bytes``,
``dispatches``, ``compile_count``) do NOT live here — they fold into the
metrics registry from the device plan itself (§10.1).
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, Optional

__all__ = ["profile"]

_active = threading.Lock()    # one capture at a time, process-wide


@contextlib.contextmanager
def profile(logdir: Optional[str], enabled: bool = True) -> Iterator[bool]:
    """Capture a ``torch.profiler`` trace into ``logdir`` over the block.

    Yields True when a capture actually started (profiler available, no
    other capture running, ``enabled`` and ``logdir`` truthy), False
    otherwise — callers may branch on it but never need to.  CUDA
    activity is recorded only when a card is present."""
    if not enabled or not logdir:
        yield False
        return
    if not _active.acquire(blocking=False):
        yield False                       # nested/concurrent: outer wins
        return
    prof = None
    try:
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except Exception:                 # pragma: no cover - no profiler
            prof = None
        yield prof is not None
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except Exception:             # pragma: no cover
                pass
        _active.release()
