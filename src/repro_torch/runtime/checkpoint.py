"""Checkpointing: atomic, async, in the reference's on-disk format.

The port of ``repro.runtime.checkpoint``.  A checkpoint is the directory
``step_<8 digits>`` holding ``arrays.npz`` and ``MANIFEST.json``, staged
and renamed into place by ``storage.atomic`` (a crash mid-write never
corrupts the newest complete checkpoint; restore scans for the newest
complete manifest), with bounded retention (``keep``).

The format is the reference's, so either package restores the other's:

- a tree is nested dicts (and lists/tuples) whose leaves are torch
  tensors, numpy arrays or numbers; its npz keys are the ``//``-joined
  key paths, dict keys sorted as ``jax.tree`` flattens them;
- a ``models.convert.Stacked`` leaf (the port's per-layer tensors of one
  reference leaf) is written as one ``(L, ...)`` array, so the port's
  model saves as ``params//layers//attn//wq`` with the reference's shape;
- bfloat16 leaves travel as 2-byte void, as the reference's npz holds
  them, with ``"bfloat16"`` in the manifest's ``leaves``.

``restore(template)`` copies into the template's tensors IN PLACE, on
their device (a ``Stacked`` leaf layer by layer); other leaves come back
as host numpy arrays cast to the template's dtype.  Every key is checked
before anything is written.

On a mesh a checkpoint stays mesh-independent both ways: a DTensor leaf
is written as its full tensor (``full_tensor``, a collective every rank
joins), by rank 0 only, and a DTensor leaf of the template is restored
by copying this rank's chunk of the full array into its local tensor.
``restore(..., shardings=...)`` places the other leaves: each loaded
array whose entry in ``shardings`` is a ``(mesh, placements)`` pair comes
back as a DTensor on that mesh (the reference's ``device_put`` onto a
sharding).  Under ``torch.distributed`` a blocking save and every restore
end or start at a barrier, so no rank reads a checkpoint rank 0 is still
writing.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.partitioning import is_dtensor
from ..distributed.sharding import local_chunk
from ..models.convert import Stacked
from ..storage import atomic

__all__ = ["Checkpointer", "latest_step"]

_SEP = "//"


def _items(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)) and not isinstance(node, Stacked):
        return list(enumerate(node))
    return None


def _flatten(tree) -> Dict[str, Any]:
    flat, stack = {}, [((), tree)]
    while stack:
        path, node = stack.pop()
        items = _items(node)
        if items is None:
            flat[_SEP.join(str(p) for p in path)] = node
            continue
        stack.extend((path + (k,), v) for k, v in reversed(items))
    return flat


def _unflatten_like(template, flat: Dict[str, Any], path=()):
    items = _items(template)
    if items is None:
        return flat[_SEP.join(str(p) for p in path)]
    out = {k: _unflatten_like(v, flat, path + (k,)) for k, v in items}
    if isinstance(template, dict):
        return out
    return type(template)(out[i] for i in range(len(template)))


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _rank() -> int:
    return dist.get_rank() if _distributed() else 0


def _barrier() -> None:
    if _distributed():
        dist.barrier()


def _tensor_host(t: torch.Tensor):
    """A host copy of ``t`` as numpy (bfloat16 as 2-byte void), with the
    dtype's name; a DTensor's full tensor."""
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), name
    return t.numpy(), name


def _host(leaf):
    """(numpy array to store, dtype name for the manifest)."""
    if isinstance(leaf, Stacked):
        parts = [_tensor_host(t) for t in leaf]
        return np.stack([a for a, _ in parts]), parts[0][1]
    if isinstance(leaf, torch.Tensor):
        return _tensor_host(leaf)
    v = np.array(leaf)                   # a copy: the caller may mutate it
    return v, str(v.dtype)


def _as_tensor(v: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if v.dtype.kind == "V":              # npz round-trips bfloat16 as void
        if v.dtype.itemsize != 2 or dtype.itemsize != 2:
            raise ValueError(f"{v.dtype} does not hold {dtype}")
        ints = np.ascontiguousarray(v).view(np.int16)
        return torch.from_numpy(ints).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(v))


def _copy_into(t: torch.Tensor, full: torch.Tensor) -> None:
    """Copy the full array into ``t``; into a DTensor's local tensor, this
    rank's chunk of it."""
    if is_dtensor(t):
        t.to_local().copy_(local_chunk(full, t.device_mesh, t.placements))
    else:
        t.copy_(full)


def _placed(v: np.ndarray, sharding):
    """The loaded array as a DTensor on ``sharding`` = (mesh, placements)."""
    from torch.distributed.tensor import DTensor
    mesh, place = sharding
    full = _as_tensor(v, torch.bfloat16).to(mesh.device_type)
    return DTensor.from_local(local_chunk(full, mesh, place), mesh,
                              list(place), run_check=False,
                              shape=full.shape, stride=full.stride())


def _sharding_leaves(tree, path=()) -> Dict[str, Any]:
    """{npz key: (mesh, placements)} of a ``shardings`` tree (nested dicts
    whose leaves are the pairs)."""
    if not isinstance(tree, dict):
        return {_SEP.join(str(p) for p in path): tree}
    out = {}
    for k, v in tree.items():
        out.update(_sharding_leaves(v, path + (k,)))
    return out


@torch.no_grad()
def _restore_leaf(t, v: np.ndarray, sharding=None):
    if isinstance(t, Stacked):
        for i, ti in enumerate(t):
            _copy_into(ti, _as_tensor(v[i], ti.dtype))
        return t
    if isinstance(t, torch.Tensor):
        _copy_into(t, _as_tensor(v, t.dtype))
        return t
    if sharding is not None:
        return _placed(_restore_leaf(t, v), sharding)
    if not hasattr(t, "dtype"):
        return np.asarray(v)
    want = np.dtype(t.dtype)
    if v.dtype.kind == "V" and v.dtype.itemsize == want.itemsize:
        return v.view(want)
    return v.astype(want)


def _shape(t):
    if isinstance(t, Stacked):
        return (len(t),) + tuple(t[0].shape)
    return tuple(np.shape(t)) if hasattr(t, "shape") else None


def latest_step(directory) -> Optional[int]:
    entries = atomic.complete_entries(Path(directory), "step_")
    return entries[-1][0][0] if entries else None


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, *, extra: Optional[dict] = None) -> Path:
        """Blocking atomic save (flushes any in-flight async save first).
        Under ``torch.distributed`` every rank calls it, rank 0 writes."""
        self.wait()
        flat = self._host_flat(tree)
        path = self.dir / f"step_{step:08d}"
        if _rank() == 0:
            path = self._write(step, flat, extra or {})
        _barrier()
        return path

    def save_async(self, step: int, tree, *,
                   extra: Optional[dict] = None) -> None:
        """Device->host copy now; disk write on a background thread (rank
        0's only)."""
        self.wait()  # one in-flight save at a time
        flat = self._host_flat(tree)
        if _rank() != 0:
            return

        def work():
            try:
                self._write(step, flat, extra or {})
            except BaseException as e:  # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # ------------------------------------------------------------------ #
    @staticmethod
    def _host_flat(tree) -> Dict[str, tuple]:
        return {k: _host(v) for k, v in _flatten(tree).items()}

    def _write(self, step: int, flat: Dict[str, tuple], extra: dict) -> Path:
        def stage(tmp: Path) -> None:
            np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
            manifest = {
                "step": step,
                "time": time.time(),
                "leaves": {k: {"shape": list(a.shape), "dtype": name}
                           for k, (a, name) in flat.items()},
                "extra": extra,
            }
            (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))

        final = atomic.stage_and_rename(self.dir / f"step_{step:08d}", stage)
        atomic.retain(self.dir, "step_", self.keep)
        return final

    # ------------------------------------------------------------------ #
    def restore(self, template, step: Optional[int] = None,
                shardings=None) -> Any:
        """Restore into the structure of ``template``: its tensors (and
        ``Stacked`` leaves; a DTensor's local chunk) are overwritten in
        place and returned; other leaves come back as host numpy cast to
        the template's dtype, or, where ``shardings`` (a tree like the
        template's) holds a ``(mesh, placements)`` pair, as a DTensor on
        it.  Keys of the checkpoint the template does not name are left
        unread."""
        self.wait()
        _barrier()
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        want = _flatten(template)
        with np.load(path / "arrays.npz") as z:
            arrays = {}
            for key, t in want.items():
                if key not in z.files:
                    raise KeyError(f"checkpoint missing leaf '{key}'")
                arrays[key] = z[key]
                shape = _shape(t)
                if (isinstance(t, (torch.Tensor, Stacked))
                        and arrays[key].shape != shape):
                    raise ValueError(f"'{key}': shape {arrays[key].shape} "
                                     f"in the checkpoint, {shape} here")
        places = _sharding_leaves(shardings) if shardings is not None else {}
        out = {k: _restore_leaf(t, arrays.pop(k), places.get(k))
               for k, t in want.items()}
        return _unflatten_like(template, out)

    def manifest(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else latest_step(self.dir)
        path = self.dir / f"step_{step:08d}" / "MANIFEST.json"
        return json.loads(path.read_text())
