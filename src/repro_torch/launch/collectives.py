"""Collective-communication volume of a step, counted as it runs.

The counterpart of ``repro.launch.hloparse``.  The reference parses the
compiled HLO of an SPMD module for its collectives; eager torch has no
HLO, so this module watches the collectives a step issues instead: every
``_c10d_functional`` op (what DTensor's redistributions and the port's
own all-reduces lower to) and every ``c10d`` op, on the local tensors of
one rank.  Per device and per op type it sums the RESULT bytes of each
collective (the reference's convention: an all-gather counts its
gathered output, a reduce-scatter its scattered one, each result once;
the ``wait_tensor`` that completes an async collective counts nothing),
under the reference's names.

``CollectiveCounter`` keeps the tally; the dry run's counter
(``launch.dryrun.StepCounter``, a dispatch mode that sees every op of a
step on one rank's local tensors) hands it each op (``record``).
``CommDebugMode`` only counts calls; the bytes come from each
collective's local output.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

__all__ = ["COLLECTIVE_OPS", "collective_kind", "result_bytes",
           "CollectiveCounter"]

# (namespace, op) -> the reference's collective names (``hloparse``)
COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced_"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}


def collective_kind(func) -> Optional[str]:
    """The reference's name of the collective ``func`` (an ``OpOverload``)
    is, or None."""
    schema = func._schema.name                     # "ns::op"
    ns, _, op = schema.partition("::")
    return COLLECTIVE_OPS.get((ns, op))


def result_bytes(func, args, out) -> int:
    """Bytes of a collective's result on this rank: its output tensors,
    or, for the in-place ``c10d`` ops, the tensors they write (their first
    argument; a ``recv_`` receives into it, a ``send`` counts the tensors
    it sends)."""
    ns = func._schema.name.partition("::")[0]
    if ns == "c10d":
        out = args[0]
    flat, _ = tree_flatten(out)
    return sum(t.numel() * t.element_size() for t in flat
               if isinstance(t, torch.Tensor))


class CollectiveCounter:
    """The collectives of a step, per op type: result bytes of this rank
    (``per_op``) and calls (``calls``).  ``totals()`` is
    ``hloparse.collective_bytes``' ``(total, per op)``."""

    def __init__(self):
        self.per_op: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    def record(self, func, args, out) -> bool:
        """Add ``func``'s result bytes if it is a collective; whether it
        was."""
        kind = collective_kind(func)
        if kind is None:
            return False
        self.per_op[kind] = self.per_op.get(kind, 0) + result_bytes(
            func, args, out)
        self.calls[kind] = self.calls.get(kind, 0) + 1
        return True

    def totals(self) -> Tuple[int, Dict[str, int]]:
        return sum(self.per_op.values()), dict(self.per_op)
