"""Meshes of ranks: the port of the JAX package's ``launch/mesh.py`` on a
``torch.distributed`` process group.

A mesh names the axes of the process group's ranks, laid out row-major
(rank = Σ coord[i] · stride[i]): ``("data",)`` for data parallelism,
``("data", "model")`` or ``("pod", "data", "model")`` as in the JAX
package.  ``Mesh`` carries what the sharding rules read (``axis_names``
and ``shape``, a dict of axis sizes, as a JAX ``Mesh`` has them), this
rank's coordinates, one process group per axis (a
``torch.distributed.device_mesh.DeviceMesh`` over the group, in
``device_mesh``) and the explicit collectives the SPMD bodies call.
``AbstractMesh`` is the shape alone: ``make_production_mesh`` keeps the
reference's 256- and 512-rank meshes as one, so the sharding rules and
the dry-run read them without that many ranks.  ``CountingMesh`` is an
``AbstractMesh`` with coordinates (0 by default) whose collectives
compute nothing: ``all_reduce`` returns its input, ``all_gather`` an
empty tensor of the gathered shape, and each call is recorded in
``Mesh.stats``' form — so the tensor-parallel dense layers, the
expert-parallel MoE, the sequence-split decode, the global loss and the
gradient reductions run at one rank's
shapes of a 256- or 512-rank mesh with no process group (the dry-run,
``launch/dryrun.py``).

Every function here starts nothing when the module is imported.
``init_distributed`` starts the process group from the environment that
``python -m torch.distributed.run`` sets; a process it did not start
serves as a mesh of one rank, and a collective over an axis of size 1 is
the identity.

The collectives are ``torch.distributed``'s own on either backend.
gloo's documentation lists only broadcast and all-reduce for CUDA
tensors, but the torch of the H100 machine (2.11) runs all-gather,
all-gather-into-tensor and reduce-scatter on them too (``chip_smoke.py``
phase 15 (b) checks which, every run), so no collective is written out
in other terms and no tensor is moved to the host around one (gloo
stages CUDA tensors through the host itself).  ``Mesh.stats`` counts
each collective's calls, bytes and host seconds.
"""

from __future__ import annotations

import datetime
import gc
import math
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..distributed.sharding import batch_coord, dp_shards  # noqa: F401

DEFAULT_TIMEOUT_S = 60.0


class AbstractMesh:
    """Axis names and sizes with no process group behind them."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} against axes "
                             f"{tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


class Mesh(AbstractMesh):
    """This rank's view of a mesh over the process group (or of a mesh of
    one rank when no group was started)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_mesh=None):
        super().__init__(shape, axes)
        self.device_mesh = device_mesh
        rank = dist.get_rank() if device_mesh is not None else 0
        self.coords: Dict[str, int] = {}
        for a in reversed(self.axis_names):
            self.coords[a] = rank % self.shape[a]
            rank //= self.shape[a]
        self.stats: Dict[str, list] = {}    # op -> [calls, bytes, seconds]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def _record(self, op: str, nbytes: int, t0: float) -> None:
        s = self.stats.setdefault(op, [0, 0, 0.0])
        s[0] += 1
        s[1] += nbytes
        s[2] += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """``x`` reduced (``"sum"`` or ``"max"``) over the ranks along
        ``axes`` (one name or several), in place; ``x`` itself."""
        for axis in ([axes] if isinstance(axes, str) else axes):
            if self.shape.get(axis, 1) == 1:
                continue
            t0 = time.perf_counter()
            dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op],
                            group=self.group(axis))
            self._record(f"all_reduce_{op}:{axis}",
                         x.numel() * x.element_size(), t0)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim``, in the
        order of their coordinates (``jax.lax.all_gather(..., tiled=True)``);
        every rank's ``x`` has the same shape."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return x
        t0 = time.perf_counter()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=self.group(axis))
        self._record(f"all_gather:{axis}", n * x.numel() * x.element_size(),
                     t0)
        return torch.cat(parts, dim=dim)


class CountingMesh(AbstractMesh):
    """One rank's view of a mesh with no group behind it (module doc).
    ``stats`` is ``Mesh.stats``' (seconds 0); ``calls`` lists every call
    as (op, axis, operand bytes, result bytes, result shape)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 coords: Optional[Dict[str, int]] = None):
        super().__init__(shape, axes)
        self.coords: Dict[str, int] = dict(
            coords or {a: 0 for a in self.axis_names})
        self.stats: Dict[str, list] = {}
        self.calls: list = []

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def _record(self, op: str, axis: str, stat: int, operand: int,
                result: int, shape) -> None:
        s = self.stats.setdefault(f"{op}:{axis}", [0, 0, 0.0])
        s[0] += 1
        s[1] += stat
        self.calls.append((op, axis, operand, result, tuple(shape)))

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        for axis in ([axes] if isinstance(axes, str) else axes):
            if self.shape.get(axis, 1) > 1:
                nb = x.numel() * x.element_size()
                self._record(f"all_reduce_{op}", axis, nb, nb, nb, x.shape)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        n = self.shape.get(axis, 1)
        if n == 1:
            return x
        shape = list(x.shape)
        shape[dim] *= n
        nb = x.numel() * x.element_size()
        self._record("all_gather", axis, n * nb, nb, n * nb, shape)
        return x.new_empty(shape)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh: 16 x 16 = 256 ranks a pod; the
    multi-pod variant prepends a pure-DP "pod" axis (2 pods = 512).  An
    ``AbstractMesh``: axis names and sizes, no group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over every rank of the started process group
    (a ``DeviceMesh`` with one group per axis); with no group started,
    only a mesh of one rank."""
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs a started process "
                               "group (launch.mesh.init_distributed)")
        return Mesh(shape, axes)
    if n != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} over {dist.get_world_size()} "
                         "ranks")
    from torch.distributed.device_mesh import DeviceMesh

    # the CUDA device was chosen by init_distributed: a "cpu" DeviceMesh
    # sets none (two ranks may share one card), an "nccl" one keeps it
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = DeviceMesh(kind, torch.arange(n).reshape(tuple(shape)),
                             mesh_dim_names=tuple(axes))
    return Mesh(shape, axes, device_mesh)


def make_host_mesh(model_ranks: int = 1) -> Mesh:
    """Every rank of the process group on a ("data",) axis; one rank when
    no group was started.  With ``model_ranks`` above 1 the ranks as a
    (ranks / model_ranks, model_ranks) mesh over ("data", "model")
    (``launch.serve`` and ``launch.train`` take it as ``--model-ranks``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model_ranks == 1:
        return make_mesh((n,), ("data",))
    if n % model_ranks:
        raise ValueError(f"{model_ranks} model ranks do not divide the {n} "
                         "ranks")
    return make_mesh((n // model_ranks, model_ranks), ("data", "model"))


def default_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when every rank of this host has a card of its own,
    ``gloo`` when ranks share a card or run on the CPU (NCCL refuses two
    ranks on one device: "Duplicate GPU detected")."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device="cuda", *, backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Start the process group of ``python -m torch.distributed.run``
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR`` / ``MASTER_PORT``) or of an explicit ``init_method``
    with ``rank`` and ``world_size``.  Returns False, starting nothing,
    in a process that the launcher did not start.

    On CUDA each rank takes card ``LOCAL_RANK`` modulo the cards present
    (ranks beyond the cards share them).  ``backend`` defaults to
    ``default_backend``'s choice; ``timeout_s`` bounds every collective,
    so a lost peer fails the run instead of hanging it.  Rank 0 prints
    the backend."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already started")
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        torch.cuda.init()
    backend = backend or default_backend(dev, local_world)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        cards = (f", {torch.cuda.device_count()} card(s) on this host"
                 if dev.type == "cuda" else "")
        print(f"process group: backend {backend}, {world_size} ranks "
              f"({local_world} on this host{cards}), timeout {timeout_s:g} s",
              flush=True)
    return True


def shutdown_distributed(*, clean: bool = True) -> None:
    """Destroy the process group once every rank is done with it, and
    with it every group's worker threads.

    After a run that ended normally (``clean``) every rank first meets
    at a barrier, so that no rank closes its gloo pairs while a peer
    still has traffic on them.  A rank that leaves on an error passes
    ``clean=False`` and destroys the group at once, since its peers may
    never reach the barrier.

    ``destroy_process_group`` drops c10d's references to the groups, but
    a mesh's ``DeviceMesh`` holds them from reference cycles, so they
    lived on until the collector ran, often at interpreter exit.  There
    a gloo worker thread that released a finished collective's tensor
    (whose Python object it then had to free) asked for the GIL of a
    finalising interpreter, was ended by it and aborted the rank
    (SIGABRT after all its output; ROADMAP Queue 3, F12).  Collecting
    here frees those groups now: their destructors join the worker
    threads while the interpreter still runs, so none outlives the
    teardown."""
    if clean:
        dist.barrier()
    dist.destroy_process_group()
    gc.collect()
