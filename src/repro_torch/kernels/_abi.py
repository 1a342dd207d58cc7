"""What the ctypes-bound kernel wrappers share: declaring a kernel's C entry,
checking its operands, and launching it on torch's current stream.

Each ``csrc/<kernel>.cu`` exports an ``extern "C"`` entry that enqueues its
work on the stream it is given and returns the CUDA error code, plus
``coax_error_string``.  Nothing here builds or loads a library at import.
"""
from __future__ import annotations

import ctypes

import torch

VP, I = ctypes.c_void_p, ctypes.c_int

# dynamic shared memory one block may take on Hopper (H100, H200)
SMEM_LIMIT = 232_448


def entry(kernel: str, fn: str, argtypes):
    """The library of ``kernel`` (built first if needed) and its C function
    ``fn`` with the ABI declared: ``argtypes`` plus the stream, returning
    an ``int`` error code."""
    from .build import load
    lib = load(kernel)
    func = getattr(lib, fn)
    if func.argtypes is None:          # first use: declare the ABI
        func.argtypes = [*argtypes, VP]
        func.restype = I
        lib.coax_error_string.argtypes = [I]
        lib.coax_error_string.restype = ctypes.c_char_p
    return lib, func


def check(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned(t):
    """``t``, or a fresh copy when its data is not 16-byte aligned (kernels
    that read whole rows or planes as 16-byte vectors need the start on a
    16-byte boundary)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def launch(kernel: str, fn: str, argtypes, device, *args) -> None:
    """Call ``fn`` of ``kernel`` with ``args`` (tensors pass their data
    pointers) on ``device``'s current stream; raise if the launch fails."""
    lib, func = entry(kernel, fn, argtypes)
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = func(*vals, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({lib.coax_error_string(rc).decode()})")
