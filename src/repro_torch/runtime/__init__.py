"""Runtime utilities of the port.

``failure`` — graceful shutdown, bounded retry, straggler detection and
deterministic fault injection (``FaultPlan``), the schedule the
replication plane's transport, replicas and primary read their injected
faults from.  Pure stdlib, a copy of the JAX package's module of the same
name, so the port imports nothing of it.

``router`` and ``serve_loop`` — the LM serving path: the COAX request
router (admission is a range query, one ``fused_scan`` wave on the device
backend) and the wave-batched ``Server``.  Import them from their modules (they pull in the model
plane).
"""
from .failure import (FailureInjector, FaultPlan, GracefulShutdown,
                      StragglerDetector, retry)

__all__ = ["GracefulShutdown", "retry", "StragglerDetector",
           "FailureInjector", "FaultPlan"]
