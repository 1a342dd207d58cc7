"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain torch
versions.

``fused_scan`` — probe + sort band + filter + hit compaction of one
segment, the serving plane's one kernel (``engine.device``, DESIGN.md §4);
``csrc/fused_scan.cu`` is its source, ``build`` compiles it with ``nvcc``
at first use.  ``ref`` holds the plain versions the tests compare with and
the wrappers run on CPU tensors; ``ops`` the padded standalone entries.
"""
from .fused_scan import fused_scan
from .ops import fused_range_scan
from . import ref

__all__ = ["fused_scan", "fused_range_scan", "ref"]
