"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain torch
versions.

``fused_scan`` — probe + sort band + filter + hit compaction of one
segment, the serving plane's one kernel (``engine.device``, DESIGN.md §4).
``range_scan``, ``range_scan_batch`` (paper §6 scans), ``grid_histogram``
and ``margin_split`` (Algorithm 1's bucketing and split) sit behind the
standalone entries of ``ops``, the counterparts of ``repro.kernels``.
``csrc/<kernel>.cu`` are the sources, ``build`` compiles them with ``nvcc``
at first use.  ``ref`` holds the plain versions the tests compare with and
the wrappers run on CPU tensors.
"""
from .fused_scan import fused_scan
from .grid_histogram import grid_histogram
from .margin_split import margin_split
from .ops import (bucket_histogram, fused_range_scan, range_scan_batch_query,
                  range_scan_query, split_by_margin)
from .range_scan import range_scan
from .range_scan_batch import range_scan_batch
from . import ref

__all__ = ["range_scan_query", "range_scan_batch_query", "fused_range_scan",
           "fused_scan", "bucket_histogram", "split_by_margin", "range_scan",
           "range_scan_batch", "grid_histogram", "margin_split", "ref"]
