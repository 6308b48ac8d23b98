"""Crash-safe filesystem primitives of the durable store — a copy of
``repro.store.atomic`` (pure Python, no jax), kept in this package so
that ``repro_torch`` imports nothing of ``repro``.

Everything durable is written with one protocol:

1. write the payload to a sibling ``<final>.tmp-<pid>`` path,
2. flush + ``fsync`` the payload,
3. ``rename`` over the final path (atomic on POSIX),
4. ``fsync`` the parent directory so the rename itself is durable.

A crash at any point leaves either the old state or the new state visible
— never a torn file — plus, at worst, a stale ``.tmp-<pid>`` sibling that
:func:`sweep_stale_tmp` removes on the next startup.

Every fsync/rename boundary reports a labelled crash point to an optional
:class:`repro_torch.store.faults.FaultInjector`, so the recovery test
suite can enumerate and kill at every one of them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Callable, List, Optional

# stale siblings left by crashed writers: in-flight tmp payloads,
# half-deleted ``.rm`` garbage, displaced ``.old-<pid>`` predecessors
_STALE_RE = re.compile(r"\.(tmp-\d+|old-\d+|rm)$")


def _hit(faults, label: str) -> None:
    if faults is not None:
        faults.hit(label)


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it survives power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, *, faults=None,
                       label: str = "file") -> None:
    """Atomically replace ``path`` with ``data`` (tmp → fsync → rename).

    Crash points: ``<label>:pre-fsync``, ``<label>:pre-rename``,
    ``<label>:post-rename``.
    """
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        _hit(faults, f"{label}:pre-fsync")
        os.fsync(f.fileno())
    _hit(faults, f"{label}:pre-rename")
    os.replace(tmp, path)
    _hit(faults, f"{label}:post-rename")
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_json(path: str, obj, *, faults=None,
                      label: str = "json") -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1, sort_keys=True)
                       .encode("utf-8"), faults=faults, label=label)


def atomic_write_dir(final: str, populate: Callable[[str], None], *,
                     faults=None, label: str = "dir") -> None:
    """Materialize a directory atomically: ``populate(tmp)`` fills a
    ``<final>.tmp-<pid>`` staging dir, every file in it is fsynced, then
    the whole dir renames into place.  Readers never observe a partially
    written directory."""
    tmp = f"{final}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    populate(tmp)
    _hit(faults, f"{label}:pre-fsync")
    for name in os.listdir(tmp):
        p = os.path.join(tmp, name)
        if os.path.isfile(p):
            fd = os.open(p, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    _hit(faults, f"{label}:pre-rename")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _hit(faults, f"{label}:post-rename")
    fsync_dir(os.path.dirname(os.path.abspath(final)))


def sweep_stale_tmp(root: str, *, skip_live_pid: bool = True) -> List[str]:
    """Remove crash leftovers (``*.tmp-<pid>``, ``*.old-<pid>``, ``*.rm``
    files and directories) anywhere under ``root``.  Returns the removed
    paths.  ``skip_live_pid`` keeps this process's own in-flight tmp
    writes (a concurrent writer thread's) untouched."""
    removed: List[str] = []
    if not os.path.isdir(root):
        return removed
    me = f"-{os.getpid()}"
    for dirpath, dirnames, filenames in os.walk(root, topdown=True):
        doomed = []
        for name in list(dirnames) + filenames:
            m = _STALE_RE.search(name)
            if not m:
                continue
            if skip_live_pid and m.group(1).startswith("tmp") \
                    and name.endswith(me):
                continue
            doomed.append(name)
        for name in doomed:
            p = os.path.join(dirpath, name)
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
                if name in dirnames:
                    dirnames.remove(name)  # don't descend into it
            else:
                try:
                    os.unlink(p)
                except OSError:
                    continue
            removed.append(p)
    return removed


def read_json(path: str) -> Optional[dict]:
    """Load a JSON file written by :func:`atomic_write_json`; ``None`` if
    absent (a crash before the first atomic publish)."""
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
