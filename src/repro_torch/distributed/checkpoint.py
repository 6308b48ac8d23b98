"""Checkpointing: save/restore with manifest + atomic rename and an async
writer thread — the port of the JAX package's
``distributed/checkpoint.py``, in its on-disk format.

Layout per step::

    <dir>/step_0000042.tmp-<pid>/   (written)  ->  <dir>/step_0000042/
        manifest.json     {step, keys, shapes, dtypes, time}
        arrays.npz        one entry per flattened key path

Key paths are the JAX package's: dict keys and ``NamedTuple`` fields
joined by ``/`` (``params/embed``, ``opt/step``, ``opt/mu/final_norm``).
A list of units — the port's ``params["units"]`` — is written stacked
along a leading axis, as the JAX package's scanned units are
(``params/units/l0/wq`` is (n_units, d, H, hd)), so either package
restores the other's checkpoints.  A ``Params`` module is written as its
nested dict; ``AdamWState`` as its three fields.  Arrays are logical
host copies, so a restore may target another device (``device=``).

Under a mesh of ranks the checkpoints stay logical: ``AsyncCheckpointer``
given the mesh and the placement's specs gathers the ``Params`` of the
tree on the main thread, one leaf at a time in one fixed order, every
rank joining each gather (over "data" and "model" alike).  Rank 0 copies
each whole leaf to the host as soon as it is gathered and the other
ranks drop it, so no rank's device holds more than one whole leaf beside
its shards; rank 0 alone hands the arrays to its writer thread, which
issues no collective.  A restore
reads whole arrays; ``fault_tolerance.resume_or_init(mesh=)`` cuts each
rank's shards from them by the new mesh's placement.

The atomic tmp-pid → fsync → rename protocol is ``store.atomic``'s.  A
writer that crashes mid-save leaves a stale ``step_*.tmp-<pid>`` (or
``.old-<pid>`` / ``.rm``) directory behind; ``sweep_stale`` removes them
and runs on the startup paths (``AsyncCheckpointer``,
``fault_tolerance.resume_or_init``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.hamming import resolve_device
from ..models.layers import Params
from ..store.atomic import atomic_write_dir, sweep_stale_tmp
from .sharding import _map_params, _map_state, gather_whole

Tree = Any

_STEP_RE = re.compile(r"^step_(\d{7})$")


def sweep_stale(ckpt_dir: str) -> List[str]:
    """Garbage-collect leftovers of crashed writers: ``step_*.tmp-<pid>``
    staging dirs, ``.old-<pid>`` displaced predecessors, and half-deleted
    ``.rm`` dirs.  This process's own in-flight tmp writes (a live
    ``AsyncCheckpointer`` thread) are left alone.  Returns removed paths."""
    return sweep_stale_tmp(ckpt_dir)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Tree, leaf, prefix: str = "") -> Dict[str, Any]:
    """{key path: leaf(tensor)}; a list's items are flattened alike and
    stacked per key along a new leading axis."""
    if isinstance(tree, Params):
        return _flatten(tree.tree(), leaf, prefix)
    if _is_namedtuple(tree):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple, nn.ModuleList)):
        parts = [_flatten(u, leaf, prefix) for u in tree]
        if not parts:
            return {}
        stack = torch.stack if torch.is_tensor(
            next(iter(parts[0].values()))) else np.stack
        return {k: stack([p[k] for p in parts]) for k in parts[0]}
    else:
        return {prefix.rstrip("/"): leaf(tree)}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, leaf, f"{prefix}{k}/"))
    return out


def _host(x) -> np.ndarray:
    """A host copy of a leaf (a copy even of a CPU tensor: the train loop
    updates its tensors in place while a writer thread holds this)."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _write(ckpt_dir: str, step: int, arrays: Dict[str, np.ndarray]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:07d}")
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        "time": time.time(),
    }

    def populate(tmp: str) -> None:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)

    if os.path.exists(final):  # overwrite-resume: displace, don't destroy
        os.rename(final, final + f".old-{os.getpid()}")
    atomic_write_dir(final, populate, label="checkpoint")
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree) -> str:
    """Synchronous save; returns the final path.  Atomic: the directory
    appears under its final name only when complete (staged + fsynced +
    renamed by ``store.atomic.atomic_write_dir``)."""
    return _write(ckpt_dir, step, _flatten(tree, _host))


def _host_state(tree: Tree, mesh, specs: dict, keep: bool) -> Tree:
    """``tree`` with every ``Params`` a nested dict of its leaves gathered
    whole by ``specs`` (``sharding.train_specs`` of the whole
    parameters), one leaf at a time, and copied to the host at once where
    ``keep`` (the writer; elsewhere each leaf is dropped, None).  A
    collective on every rank, in ``named_parameters`` order."""
    def leaf(name, x):
        whole = gather_whole(x, specs[name], mesh)
        return _host(whole) if keep else None
    return _map_state(tree, lambda p: _map_params(p, leaf, as_params=False))


def is_writer(mesh) -> bool:
    """Whether this rank writes the checkpoints of ``mesh`` (rank 0: every
    coordinate 0; the one process when there is no mesh)."""
    return mesh is None or not any(mesh.coord(a) for a in mesh.axis_names)


class AsyncCheckpointer:
    """Copies the tensors to the host synchronously (a device-to-host
    copy), then writes on a background thread so the train loop never
    blocks on disk.  Under ``mesh`` (module doc) every rank calls
    ``save`` with the placement's ``specs``; only rank 0 writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3, *, mesh=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.mesh = mesh
        self.writer = is_writer(mesh)
        self._pending: List[threading.Thread] = []
        if self.writer:
            sweep_stale(ckpt_dir)   # GC a crashed predecessor's leftovers

    def save(self, step: int, tree: Tree, specs: Optional[dict] = None
             ) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            if specs is None:
                raise ValueError("a checkpoint under a mesh of "
                                 f"{self.mesh.size} ranks needs the "
                                 "placement's specs to gather its shards")
            tree = _host_state(tree, self.mesh, specs, self.writer)
        if not self.writer:
            return
        arrays = _flatten(tree, lambda x: x if isinstance(x, np.ndarray)
                          else _host(x))
        t = threading.Thread(target=self._write, args=(step, arrays),
                             daemon=True)
        t.start()
        self._pending.append(t)

    def _write(self, step: int, arrays: Dict[str, np.ndarray]) -> None:
        _write(self.ckpt_dir, step, arrays)
        self._gc()

    def _gc(self) -> None:
        steps = list_checkpoints(self.ckpt_dir)
        for s in steps[:-self.keep]:
            path = os.path.join(self.ckpt_dir, f"step_{s:07d}")
            tmp = path + ".rm"
            try:
                os.rename(path, tmp)
            except OSError:
                continue
            for root, dirs, files in os.walk(tmp, topdown=False):
                for fn in files:
                    os.unlink(os.path.join(root, fn))
                for d in dirs:
                    os.rmdir(os.path.join(root, d))
            os.rmdir(tmp)

    def wait(self) -> None:
        """Block until this rank's writes are on disk; under a mesh of
        several ranks every rank waits for rank 0's (a barrier), so a
        restart that follows reads the same latest step on every rank."""
        for t in self._pending:
            t.join()
        self._pending.clear()
        if self.mesh is not None and self.mesh.size > 1:
            dist.barrier()


def list_checkpoints(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _rebuild(ref: Tree, data, prefix: str, idx: tuple, dev) -> Tree:
    """``ref``'s structure with each leaf read from ``data[key][idx]``."""
    if isinstance(ref, Params):
        return Params(_rebuild(ref.tree(), data, prefix, idx, dev))
    if _is_namedtuple(ref):
        return type(ref)(*(_rebuild(getattr(ref, f), data, f"{prefix}{f}/",
                                    idx, dev) for f in ref._fields))
    if isinstance(ref, dict):
        return {k: _rebuild(v, data, f"{prefix}{k}/", idx, dev)
                for k, v in ref.items()}
    if isinstance(ref, (list, tuple, nn.ModuleList)):
        return [_rebuild(u, data, prefix, idx + (i,), dev)
                for i, u in enumerate(ref)]
    arr = np.asarray(data[prefix.rstrip("/")][idx])
    return torch.from_numpy(np.array(arr)).to(device=dev, dtype=ref.dtype)


def restore_checkpoint(ckpt_dir: str, step: int, abstract_tree: Tree, *,
                       device="cuda") -> Tree:
    """Restore into the structure of ``abstract_tree`` (tensors whose
    shapes and dtypes are the targets', e.g. ``model.abstract_params``
    on the ``meta`` device), each leaf on ``device``."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:07d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = _flatten(abstract_tree, lambda x: x)
    missing = sorted(set(want) - set(manifest["keys"]))
    if missing:
        raise ValueError(f"checkpoint at step {step} lacks keys: {missing[:5]}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        data = {k: npz[k] for k in want}
    for key, ref in want.items():
        if tuple(data[key].shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {data[key].shape} != expected "
                             f"{tuple(ref.shape)}")
    return _rebuild(abstract_tree, data, "", (), dev)
