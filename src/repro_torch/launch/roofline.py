"""Roofline terms for the NVIDIA H100 SXM (structural, from the dry run's
per-device counts).

    compute    = FLOPs_per_device / peak_FLOPs
    memory     = bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / link_bw

The port of ``repro.launch.roofline``, with the H100 in place of the
reference's TPU v5e.  The dry run (``launch.dryrun``) counts each
device's own work, so no /chips normalisation is needed.

MODEL_FLOPS uses the standard 6·N·D (train) / 2·N·D (inference) accounting
with N = active non-embedding parameters and D = tokens processed per step;
MODEL_FLOPS / counted FLOPs exposes remat recompute and redundant work.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig, ShapeConfig

__all__ = ["H100_SXM", "roofline", "model_flops"]

# NVIDIA H100 SXM5 80GB, from NVIDIA's "H100 Tensor Core GPU" data sheet
# (https://resources.nvidia.com/en-us-tensor-core/nvidia-tensor-core-gpu-datasheet):
# bfloat16 tensor-core peak 1,979 TFLOP/s with 2:4 sparsity, so 989e12
# dense; HBM3 3.35 TB/s; NVLink 900 GB/s a card, both directions together
# (450e9 a direction), within one eight-card HGX node.  A 16x16 mesh of
# H100s spans 32 such nodes, so its collectives cross nodes, over one
# NVIDIA ConnectX-7 a card (ConnectX-7 data sheet: 400 Gb/s InfiniBand
# NDR, 50e9 B/s a direction): the collective term divides by that rate.
H100_SXM = {
    "peak_flops": 989e12,   # bf16 dense FLOP/s per card
    "hbm_bw": 3.35e12,      # bytes/s per card
    "link_bw": 50e9,        # bytes/s per card between nodes (ConnectX-7)
    "nvlink_bw": 450e9,     # bytes/s per card and direction inside a node
}


def model_flops(cfg: ModelConfig, shape: ShapeConfig, active_params: int,
                embed_params: int) -> float:
    """Useful model FLOPs per step (global, all chips)."""
    n = max(active_params - embed_params, 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch


def roofline(flops_per_device: float, bytes_per_device: float,
             coll_bytes_per_device: float, hw: Dict[str, float] = H100_SXM
             ) -> Dict[str, float]:
    compute = flops_per_device / hw["peak_flops"]
    memory = bytes_per_device / hw["hbm_bw"]
    collective = coll_bytes_per_device / hw["link_bw"]
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])
    step_time = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant[0],
        "step_time_bound_s": step_time,
    }
