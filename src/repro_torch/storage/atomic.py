"""The ONE atomic-persistence idiom of the durability plane (DESIGN.md §7.1).

Every durable artifact — index snapshots (``storage.snapshot``) and the
sharded partitioner spec — is written the same way:

1. **stage**: the payload is written into a sibling ``.tmp.<nonce>.<name>``
   directory (or file), never into the final path;
2. **rename**: one ``os.rename``/``os.replace`` publishes it — POSIX renames
   within a directory are atomic, so a crash at ANY byte of the write leaves
   either the old complete artifact or the new complete artifact, never a
   torn one;
3. **scan**: readers recognise an artifact as *complete* only when its
   manifest file exists (the manifest is the last thing staged before the
   rename), and restore from the NEWEST complete one — half-staged ``.tmp``
   litter from a crash is invisible to them and swept opportunistically;
4. **retain**: bounded retention deletes the oldest complete artifacts
   beyond ``keep``, never the newest.

Names carry their ordering: ``<prefix><int>[_<int>...]`` with zero-padded
fields, so "newest" is the lexicographic/tuple max of the parsed integer
key (snapshots order by (epoch, wal_seq)).
"""
from __future__ import annotations

import os
import shutil
import uuid
from pathlib import Path
from typing import Callable, List, Optional, Tuple

__all__ = [
    "stage_and_rename",
    "replace_file",
    "fsync_dir",
    "parse_key",
    "complete_entries",
    "latest_complete",
    "retain",
    "sweep_stale_tmp",
]

_TMP_MARK = ".tmp."
_OLD_MARK = ".old."


def fsync_dir(path: Path) -> None:
    """fsync a DIRECTORY so a rename/unlink inside it is durable, not just
    ordered — the other half of the atomic-publish contract (a rename the
    parent never persisted can vanish at power loss even though the process
    saw it).  Best-effort on filesystems that refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def stage_and_rename(final: Path, write_fn: Callable[[Path], None]) -> Path:
    """Write an artifact directory atomically: stage via ``write_fn(tmp)``,
    then rename ``tmp`` -> ``final`` (replacing any previous ``final``).

    ``write_fn`` receives the empty staging directory and must write the
    manifest LAST — completeness is judged by the manifest's existence.
    On any exception the staging directory is removed and nothing at
    ``final`` changes.

    Durability ordering: every staged file is fsynced (then the staging
    dir, then — after the rename — the parent dir), so by the time a later
    operation can observe the artifact as published, its CONTENT is on
    stable storage too; a power cut never yields a "complete" manifest
    with torn payload, nor a durable follow-up (e.g. a WAL unlink) whose
    prerequisite snapshot evaporated.
    """
    final = Path(final)
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = final.parent / f"{_TMP_MARK}{uuid.uuid4().hex[:8]}.{final.name}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    try:
        write_fn(tmp)
        for p in sorted(tmp.rglob("*")):
            if p.is_file():
                with open(p, "rb") as f:
                    os.fsync(f.fileno())
        fsync_dir(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    backup = None
    if final.exists():
        # never rmtree-before-rename: a crash in between would leave
        # NEITHER artifact.  Rename the old one aside (atomic), publish,
        # then discard; ``sweep_stale_tmp`` repairs the tiny window where
        # only the ``.old.`` backup exists by renaming it back.
        backup = final.parent / f"{_OLD_MARK}{uuid.uuid4().hex[:8]}.{final.name}"
        os.rename(final, backup)
    os.rename(tmp, final)
    fsync_dir(final.parent)
    if backup is not None:
        shutil.rmtree(backup, ignore_errors=True)
    return final


def replace_file(path: Path, data: bytes) -> Path:
    """Atomically (re)write a single file: stage bytes in a sibling tmp
    file, fsync, ``os.replace`` into place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f"{_TMP_MARK}{uuid.uuid4().hex[:8]}.{path.name}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return path


def parse_key(name: str, prefix: str) -> Optional[Tuple[int, ...]]:
    """``"epoch_00000002_000000000015"`` with prefix ``"epoch_"`` ->
    ``(2, 15)``; None when the name does not parse."""
    if not name.startswith(prefix):
        return None
    try:
        return tuple(int(part) for part in name[len(prefix):].split("_"))
    except ValueError:
        return None


def complete_entries(directory: Path, prefix: str,
                     manifest: str = "MANIFEST.json",
                     ) -> List[Tuple[Tuple[int, ...], Path]]:
    """All COMPLETE artifacts under ``directory`` matching ``prefix``,
    sorted oldest -> newest by parsed integer key.  Complete = the manifest
    file exists (the rename published it); ``.tmp.*`` staging litter never
    qualifies."""
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        if p.name.startswith(_TMP_MARK):
            continue
        key = parse_key(p.name, prefix)
        if key is not None and (p / manifest).exists():
            out.append((key, p))
    out.sort(key=lambda kp: kp[0])
    return out


def latest_complete(directory: Path, prefix: str,
                    manifest: str = "MANIFEST.json") -> Optional[Path]:
    """Path of the newest complete artifact, or None."""
    entries = complete_entries(directory, prefix, manifest)
    return entries[-1][1] if entries else None


def retain(directory: Path, prefix: str, keep: int,
           manifest: str = "MANIFEST.json") -> int:
    """Delete the oldest complete artifacts beyond ``keep``; returns how
    many were removed.  Incomplete artifacts are never counted or touched
    (``sweep_stale_tmp`` handles staging litter)."""
    entries = complete_entries(directory, prefix, manifest)
    doomed = entries[: max(len(entries) - keep, 0)]
    for _, p in doomed:
        shutil.rmtree(p, ignore_errors=True)
    return len(doomed)


def sweep_stale_tmp(directory: Path) -> int:
    """Repair and sweep crash litter; returns how many entries were
    handled.  ``.old.<nonce>.<name>`` backups (a publish died between its
    two renames) are renamed BACK to ``<name>`` when nothing was published
    there — restoring the displaced complete artifact — and deleted when
    the publish did land.  ``.tmp.*`` staging litter is removed.  Safe any
    time recovery owns the directory: a live stage uses a fresh nonce and
    renames away before anyone else can observe it."""
    directory = Path(directory)
    if not directory.exists():
        return 0
    n = 0
    for p in list(directory.iterdir()):
        if p.name.startswith(_OLD_MARK):
            original = directory / p.name[len(_OLD_MARK) + 9:]  # strip nonce.
            if original.exists():
                shutil.rmtree(p, ignore_errors=True)
            else:
                os.rename(p, original)
            n += 1
    for p in list(directory.iterdir()):
        if p.name.startswith(_TMP_MARK):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)
            n += 1
    return n
