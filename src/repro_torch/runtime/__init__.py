"""Runtime utilities of the port.

``failure`` — graceful shutdown, bounded retry, straggler detection and
deterministic fault injection (``FaultPlan``), the schedule the
replication plane's transport, replicas and primary read their injected
faults from.  Pure stdlib, a copy of the JAX package's module of the same
name, so the port imports nothing of it.
"""
from .failure import (FailureInjector, FaultPlan, GracefulShutdown,
                      StragglerDetector, retry)

__all__ = ["GracefulShutdown", "retry", "StragglerDetector",
           "FailureInjector", "FaultPlan"]
