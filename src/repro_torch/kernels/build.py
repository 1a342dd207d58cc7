"""Build and load the hand-written CUDA kernels of this package.

Each kernel is a ``csrc/*.cu`` source with a plain ``extern "C"`` entry,
compiled by ``nvcc`` into a shared library and loaded with ``ctypes``.
Libraries land in ``build/repro_torch/`` at the repository root, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing builds at import: the first call of a
kernel's wrapper on a CUDA tensor does (``load``), or ``build_all`` starts
one ``nvcc`` per kernel, all at once.

``-Xptxas -v`` reports each kernel's registers, shared memory and spills;
the report is kept beside the library (``build_log``).  No fast math, and
``-ftz=false`` explicitly: the kernels compare float32 rows exactly, and a
flushed subnormal would compare as zero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "build_all", "load",
           "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# kernel name -> its sources under csrc/
SOURCES: Dict[str, tuple] = {"fused_scan": ("fused_scan.cu",)}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-ftz=false")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every named kernel (default: all) that is not built yet, one
    ``nvcc`` process per kernel, all started together.  Raises with the
    compiler's output when any build fails.  Returns name -> library."""
    names = list(SOURCES if names is None else names)
    todo = [name for name in names if not _target(name).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)          # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def build_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` report of kernel ``name``'s build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
