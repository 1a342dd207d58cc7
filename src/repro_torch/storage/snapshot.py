"""Versioned on-disk snapshots of a ``COAXIndex`` epoch (DESIGN.md §7.3).

Layout — one directory per snapshot, published atomically
(``storage.atomic``):

    <dir>/epoch_<epoch:08d>_<wal_seq:012d>/
        manifest.json       # format version, structure, scalars, config
        arrays.npz          # every array payload, exact dtypes

``wal_seq`` is the number of WAL records already FOLDED INTO the snapshot:
an epoch snapshot written at build/compaction carries ``wal_seq=0`` (the
epoch's WAL is empty or freshly rotated); a mid-epoch checkpoint
(``Durability.checkpoint``) carries the journal position, so restore
replays only the records the snapshot has not absorbed.  "Newest" orders
by ``(epoch, wal_seq)`` — exactly the prefix-of-history ordering.

Scalar floats (config knobs, FD model slopes/margins) live in the JSON
manifest: ``json`` emits ``repr``-shortest floats, which round-trip IEEE
float64 exactly, so nothing about the restored index is approximate.
Array payloads keep their dtypes through ``np.savez``.

The snapshot captures the FULL index state — epoch arrays in their exact
order (the order feeds compaction's sampling rng, so it is part of the
bit-identity contract), both grid directories, soft-FD groups and margins,
outlier bboxes, the live delta planes and the Bayesian drift trackers'
sufficient statistics (``COAXIndex.state``).  Restoring is pure
deserialisation: no re-sort, no re-quantile, no relearn (§7.3 warm-restart
argument).  The format is the reference package's: the same manifest keys,
npz array names and dtypes, so either package restores the other's
snapshots.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from ..core import COAXIndex
from . import atomic

__all__ = ["SNAPSHOT_PREFIX", "MANIFEST_NAME", "FORMAT_VERSION",
           "snapshot_name", "write_snapshot", "load_snapshot",
           "latest_snapshot", "read_manifest", "snapshot_nbytes"]

SNAPSHOT_PREFIX = "epoch_"
MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1


def snapshot_name(epoch: int, wal_seq: int) -> str:
    return f"{SNAPSHOT_PREFIX}{epoch:08d}_{wal_seq:012d}"


def _grid_meta(meta: dict) -> dict:
    return {k: (list(v) if isinstance(v, (list, tuple)) else v)
            for k, v in meta.items()}


def require_device(backend: str, device) -> None:
    """Raise before any work when the device backend is asked for a device
    that is absent: a restored index never degrades quietly to the host."""
    if backend == "device":
        from ..engine.device import _resolve_device
        _resolve_device(device)


def pack_state(state: dict) -> Tuple[dict, dict]:
    """``COAXIndex.state()`` -> (manifest doc, npz array dict), with the
    reference package's manifest keys, npz array names and dtypes."""
    groups = state["groups"]
    keys = [(gi, dep) for gi, g in enumerate(groups) for dep in g["dependents"]]
    fd_models = (np.asarray([list(groups[gi]["models"][dep]) for gi, dep in keys],
                            np.float64)
                 if keys else np.empty((0, 4)))
    xtx, xty = state["tracker_xtx"], state["tracker_xty"]
    has_bbox = state["outlier_lo"] is not None
    arrays = {
        "data": state["data"],
        "row_ids": state["row_ids"],
        "p__rows": state["primary"]["rows"],
        "p__row_ids": state["primary"]["row_ids"],
        "p__offsets": state["primary"]["offsets"],
        "p__edges": state["primary"]["inner_edges"],
        "o__rows": state["outlier"]["rows"],
        "o__row_ids": state["outlier"]["row_ids"],
        "o__offsets": state["outlier"]["offsets"],
        "o__edges": state["outlier"]["inner_edges"],
        "dp__rows": state["delta_primary"]["rows"],
        "dp__ids": state["delta_primary"]["ids"],
        "dp__dead": state["delta_primary"]["dead"],
        "do__rows": state["delta_outlier"]["rows"],
        "do__ids": state["delta_outlier"]["ids"],
        "do__dead": state["delta_outlier"]["dead"],
        "fd_models": fd_models,
        "tracker_xtx": np.stack(xtx) if len(xtx) else np.empty((0, 2, 2)),
        "tracker_xty": np.stack(xty) if len(xty) else np.empty((0, 2)),
        "tracker_lam": np.asarray(state["tracker_lam"], np.float64),
        "x_scale": np.asarray(state["x_scale"], np.float64),
    }
    if has_bbox:
        arrays["outlier_lo"] = state["outlier_lo"]
        arrays["outlier_hi"] = state["outlier_hi"]
    manifest = {
        "format": "coax-snapshot",
        "version": FORMAT_VERSION,
        "kind": "coax",
        "time": time.time(),
        "epoch": int(state["epoch"]),
        "wal_seq": 0,                     # overwritten by write_snapshot
        "compactions": int(state["compactions"]),
        "next_id": int(state["next_id"]),
        "primary_ratio": float(state["primary_ratio"]),
        "n_dims": int(state["data"].shape[1]),
        "base_rows": int(state["data"].shape[0]),
        "has_outlier_bbox": has_bbox,
        "config": state["config"],
        "groups": [{"predictor": int(g["predictor"]),
                    "dependents": [int(d) for d in g["dependents"]]}
                   for g in groups],
        "primary_meta": _grid_meta(state["primary"]["meta"]),
        "outlier_meta": _grid_meta(state["outlier"]["meta"]),
        "delta": {
            "primary": {"n_log_dead": int(state["delta_primary"]["n_log_dead"]),
                        "n_base_dead": int(state["delta_primary"]["n_base_dead"]),
                        "organized": int(state["delta_primary"].get("organized", 0))},
            "outlier": {"n_log_dead": int(state["delta_outlier"]["n_log_dead"]),
                        "n_base_dead": int(state["delta_outlier"]["n_base_dead"]),
                        "organized": int(state["delta_outlier"].get("organized", 0))},
        },
        # amortized-trigger counters (DESIGN.md §5.3): check timing is part
        # of the §7.3 bit-identity contract, so it must survive restore
        "write_units": int(state["write_units"]),
        "spill_pending": bool(state["spill_pending"]),
        "trigger_checks": int(state["trigger_checks"]),
        # violation-mass counters: the contamination side of the drift gate
        "viol_total": [int(v) for v in state["viol_total"]],
        "viol_bad": [int(v) for v in state["viol_bad"]],
    }
    return manifest, arrays


def unpack_state(manifest: dict, arrays: dict) -> dict:
    """(manifest, npz arrays) -> the plain data ``COAXIndex.from_state``
    takes (``config`` and ``groups`` as dicts, models as tuples)."""
    if manifest.get("format") != "coax-snapshot":
        raise ValueError("not a coax snapshot manifest")
    if manifest.get("version") != FORMAT_VERSION:
        raise ValueError(f"snapshot format v{manifest.get('version')} "
                         f"unsupported (reader is v{FORMAT_VERSION})")
    fd_models = np.asarray(arrays["fd_models"], np.float64)
    groups = []
    i = 0
    for gdoc in manifest["groups"]:
        deps = [int(d) for d in gdoc["dependents"]]
        models = {}
        for dep in deps:
            models[dep] = tuple(float(v) for v in fd_models[i])
            i += 1
        groups.append({"predictor": int(gdoc["predictor"]),
                       "dependents": deps, "models": models})

    def grid(prefix: str, meta: dict) -> dict:
        return {"rows": arrays[f"{prefix}__rows"],
                "row_ids": arrays[f"{prefix}__row_ids"],
                "offsets": arrays[f"{prefix}__offsets"],
                "inner_edges": arrays[f"{prefix}__edges"],
                "meta": meta}

    def delta(prefix: str, counters: dict) -> dict:
        return {"rows": arrays[f"{prefix}__rows"],
                "ids": arrays[f"{prefix}__ids"],
                "dead": arrays[f"{prefix}__dead"],
                "n_log_dead": counters["n_log_dead"],
                "n_base_dead": counters["n_base_dead"],
                # pre-LSM snapshots: fully-unorganized log (L0 only)
                "organized": counters.get("organized", 0)}

    n_groups = len(groups)
    vt = manifest.get("viol_total", [])
    vb = manifest.get("viol_bad", [])
    if len(vt) != n_groups or len(vb) != n_groups:
        vt = vb = [0] * n_groups          # pre-counter snapshot
    has_bbox = manifest["has_outlier_bbox"]
    return {
        "data": arrays["data"],
        "row_ids": arrays["row_ids"],
        "next_id": manifest["next_id"],
        "epoch": manifest["epoch"],
        "compactions": manifest["compactions"],
        "primary_ratio": manifest["primary_ratio"],
        "config": dict(manifest["config"]),
        "groups": groups,
        "primary": grid("p", manifest["primary_meta"]),
        "outlier": grid("o", manifest["outlier_meta"]),
        "outlier_lo": arrays["outlier_lo"] if has_bbox else None,
        "outlier_hi": arrays["outlier_hi"] if has_bbox else None,
        "delta_primary": delta("dp", manifest["delta"]["primary"]),
        "delta_outlier": delta("do", manifest["delta"]["outlier"]),
        "tracker_xtx": arrays["tracker_xtx"],
        "tracker_xty": arrays["tracker_xty"],
        "tracker_lam": arrays["tracker_lam"],
        "x_scale": arrays["x_scale"],
        "write_units": manifest.get("write_units", 0),
        "spill_pending": manifest.get("spill_pending", False),
        "trigger_checks": manifest.get("trigger_checks", 0),
        "viol_total": list(vt),
        "viol_bad": list(vb),
    }


# --------------------------------------------------------------------- #
def write_snapshot(index: COAXIndex, directory: Union[str, Path],
                   wal_seq: int = 0, keep: Optional[int] = None) -> Path:
    """Atomically publish a full-state snapshot of ``index`` under
    ``directory``; ``wal_seq`` stamps how many WAL records the state
    already contains.  ``keep`` (None = unbounded) prunes the oldest
    complete snapshots beyond that count."""
    manifest, arrays = pack_state(index.state())
    manifest["wal_seq"] = int(wal_seq)
    directory = Path(directory)

    def stage(tmp: Path) -> None:
        np.savez(tmp / "arrays.npz", **arrays)
        # manifest last: its presence is the completeness marker (§7.1)
        (tmp / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))

    final = atomic.stage_and_rename(
        directory / snapshot_name(index.epoch, int(wal_seq)), stage)
    if keep is not None:
        atomic.retain(directory, SNAPSHOT_PREFIX, keep, MANIFEST_NAME)
    return final


def latest_snapshot(directory: Union[str, Path]) -> Optional[Path]:
    """Newest COMPLETE snapshot directory by (epoch, wal_seq), or None.
    Half-staged ``.tmp.*`` litter and manifest-less directories never
    qualify (the §7.1 completeness scan)."""
    return atomic.latest_complete(Path(directory), SNAPSHOT_PREFIX,
                                  MANIFEST_NAME)


def read_manifest(snapshot_path: Union[str, Path]) -> dict:
    return json.loads((Path(snapshot_path) / MANIFEST_NAME).read_text())


def load_snapshot(snapshot_path: Union[str, Path], backend: str = "device",
                  device_opts: Optional[dict] = None, device: str = "cuda",
                  ) -> Tuple[COAXIndex, dict]:
    """Deserialise one snapshot directory -> (index, manifest) on the torch
    ``device`` (raises first when the device backend's device is absent).
    The WAL tail, if any, is the caller's job (``storage.restore``)."""
    require_device(backend, device)
    snapshot_path = Path(snapshot_path)
    manifest = read_manifest(snapshot_path)
    with np.load(snapshot_path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    state = unpack_state(manifest, arrays)
    return COAXIndex.from_state(state, backend=backend,
                                device_opts=device_opts,
                                device=device), manifest


def snapshot_nbytes(snapshot_path: Union[str, Path]) -> int:
    """Total on-disk bytes of one snapshot directory."""
    return sum(p.stat().st_size for p in Path(snapshot_path).iterdir())
