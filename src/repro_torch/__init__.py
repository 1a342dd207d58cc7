"""COAX on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Host-side planning (soft-FD learning, translation, grid files, the delta
plane, executor and server) is numpy, as in ``repro``; the device plane
(``engine.device``) holds torch tensors and runs the hand-written CUDA
kernels of ``kernels`` on ``device="cuda"`` (the default) or their plain
torch versions on ``device="cpu"``.  The LM serving path of ``repro``
(``configs``, the dense decoder of ``models``, ``runtime.router`` /
``serve_loop`` and ``launch.serve``) is plain torch on the same device,
with admission through the COAX index.
"""
from .core import COAXIndex, CoaxConfig, GridFile
from .engine import BatchQueryExecutor, QueryServer

__all__ = ["COAXIndex", "CoaxConfig", "GridFile", "BatchQueryExecutor",
           "QueryServer"]
