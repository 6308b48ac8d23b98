"""Sharding rules: logical axes -> mesh axes, parameter, cache and batch
specs — the port of the JAX package's ``distributed/sharding.py``.

The physical mesh is ``(pod, data, model)`` (multi-pod) or
``(data, model)`` (single pod).  Logical axes used by the rules:

  * ``batch``  -> ("pod", "data")  — activation batch, MoE dispatch groups
  * ``data``   -> "data"           — FSDP shard axis for parameters
  * ``model``  -> "model"          — tensor parallel (heads / ffn / vocab /
                                      experts / SSM heads)

A spec is a tuple with one entry per dimension — None, a mesh axis, or a
tuple of axes — the content of the JAX package's ``PartitionSpec``; an
axis absent from the mesh, or one that does not divide the dimension, is
dropped (the dimension stays whole).  ``local_shard`` cuts one rank's
slice of a tensor by its spec.

The port's parameters hold the units unstacked (``units[u]["l{pos}"]``,
``models/model.py``), so a unit leaf has one dimension fewer than its
JAX counterpart, which carries a leading ``n_units`` axis; its rule is
the JAX leaf's rule without that axis's entry.

``dp_shards`` and ``batch_coord`` give a mesh's data-parallel shard
count and this rank's index among them (the models split the batch by
them; ``launch.mesh`` re-exports them as the JAX package's module has
``dp_shards``).

Placement is explicit in eager PyTorch.  The JAX package's
``constrain`` — the activation annotation from which GSPMD derives the
tensor parallelism of the dense layers — has no counterpart here: no
automatic partitioner would read it, and each rank holds the dense
weights whole.  What runs sharded are the two explicit-SPMD bodies of the
reference: the MoE block under expert parallelism (``moe_sharded.py``,
its expert and FSDP shards cut by ``moe_sharded.shard_moe_params``) and
the sequence-sharded decode cache (``decode_sp.py``); the data axis
splits the batch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Sequence, Tuple

import torch

_LOGICAL = {
    "batch": ("pod", "data"),
    "data": ("data",),
    "fsdp": ("data",),
    "model": ("model",),
    "expert": ("model",),
}

_GLOBAL_MESH = None

Spec = Tuple[Any, ...]


def set_global_mesh(mesh) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh():
    return _GLOBAL_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """The model's entry points run under ``mesh`` inside the block."""
    prev = get_global_mesh()
    set_global_mesh(mesh)
    try:
        yield mesh
    finally:
        set_global_mesh(prev)


def dp_shards(mesh) -> int:
    """Number of data-parallel shards (pod x data axes)."""
    return math.prod(mesh.shape[a] for a in ("pod", "data")
                     if a in mesh.axis_names)


def batch_coord(mesh) -> int:
    """This rank's index among the data-parallel shards (pod-major)."""
    i = 0
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            i = i * mesh.shape[a] + mesh.coord(a)
    return i


def _resolve(spec: Sequence, mesh, shape: Tuple[int, ...]) -> Spec:
    """Logical spec -> per-dimension mesh axes, dropping axes that are
    absent from the mesh or that do not divide the dimension."""
    out = []
    for dim, name in enumerate(spec):
        if name is None:
            out.append(None)
            continue
        axes = []
        for logical in ([name] if isinstance(name, str) else list(name)):
            axes.extend(a for a in _LOGICAL.get(logical, (logical,))
                        if a in mesh.axis_names)
        total = 1
        for a in axes:
            total *= mesh.shape[a]
        if axes and total > 1 and shape[dim] % total == 0:
            out.append(tuple(axes) if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter specs (path-based rules)
# ---------------------------------------------------------------------------

def _param_logical(path_names: Tuple[str, ...], ndim: int) -> Tuple:
    """Logical spec for one parameter leaf of ``ndim`` dimensions.  The
    rules are written for the unstacked rank and get ``None`` prepended
    for any extra leading axes (the JAX package's rule, unchanged)."""
    name = path_names[-1]
    in_moe = "moe" in path_names or "router" in path_names

    base = None
    if name == "embed":
        base = ("model", "data")                 # (V, d) vocab-TP + FSDP
    elif name == "lm_head":
        base = ("data", "model")                 # (d, V)
    elif name in ("wq", "wk", "wv"):
        base = ("data", "model", None)           # (d, H, hd)
    elif name == "wo":
        base = ("model", None, "data")           # (H, hd, d)
    elif name == "router":
        base = ("data", None)                    # (d, E) — replicated over model
    elif name in ("w_gate", "w_up"):
        base = ("model", "data", None) if in_moe else ("data", "model")
    elif name == "w_down":
        base = ("model", None, "data") if in_moe else ("model", "data")
    elif name in ("wz", "wx"):
        base = ("data", "model")                 # (d, d_inner)
    elif name in ("wB", "wC", "wdt"):
        base = ("data", None)
    elif name == "out_proj":
        base = ("model", "data")                 # (d_inner, d)
    elif name == "conv_x":
        base = (None, "model")                   # (K, d_inner)
    if base is None:
        base = (None,) * ndim                    # norms, biases, A_log, ...
    if len(base) < ndim:
        base = (None,) * (ndim - len(base)) + tuple(base)
    return base


def leaf_logical(name: str, ndim: int) -> Tuple:
    """The logical spec of the port's parameter ``name`` (a dotted
    ``named_parameters`` name): a leaf under ``units`` takes its JAX
    counterpart's rule, whose leaf carries the ``n_units`` axis, without
    that axis's entry."""
    names = tuple(name.split("."))
    if names[0] == "units":
        return _param_logical(names, ndim + 1)[1:]
    return _param_logical(names, ndim)


def param_specs(params, mesh) -> dict:
    """``{name: spec}`` for every parameter of a ``Params`` (real or on
    the ``meta`` device), in ``named_parameters`` order."""
    return {name: _resolve(leaf_logical(name, p.dim()), mesh, tuple(p.shape))
            for name, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# cache / batch specs
# ---------------------------------------------------------------------------

def _cache_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _cache_leaves(v, path + (str(k),))
    elif hasattr(tree, "_fields"):                  # a NamedTuple (SSMCache)
        for k in tree._fields:
            yield from _cache_leaves(getattr(tree, k), path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _cache_leaves(v, path + (str(i),))
    else:
        yield path, tree


def cache_specs(cache, mesh, kv_shard: str = "heads") -> dict:
    """``{path: spec}`` for the port's decode caches (a list over units;
    the path joins the unit index and the keys with "/").  KV leaves are
    (B, S, Kv, hd); SSM conv (B, K-1, C) and state (B, H, P, N) — batch
    over (pod, data), heads/channels over model (or the SEQUENCE axis
    over model when kv_shard="seq"), with the divisibility fallback: the
    JAX package's rules without its leading ``n_units`` entry."""
    out = {}
    for path, leaf in _cache_leaves(cache):
        if leaf.dim() == 4:         # KV cache or SSM state
            if "state" in path or kv_shard == "seq":
                spec = ("batch", "model", None, None)
            else:
                spec = ("batch", None, "model", None)
        elif leaf.dim() == 3:       # conv window (B, K-1, C)
            spec = ("batch", None, "model")
        else:
            spec = (None,) * leaf.dim()
        out["/".join(path)] = _resolve(spec, mesh, tuple(leaf.shape))
    return out


def batch_specs(batch: dict, mesh) -> dict:
    """``{key: spec}``: each leaf's leading axis over the batch axes."""
    return {k: _resolve(("batch",) + (None,) * (v.dim() - 1), mesh,
                        tuple(v.shape))
            for k, v in batch.items()}


def replicated(mesh) -> Spec:
    """The spec of a value every rank holds whole."""
    return ()


def local_shard(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec`` (a resolved spec: mesh
    axes per dimension), a view.  An entry of several axes splits the
    dimension major-to-minor in their order, as JAX lays it out."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + mesh.coord(a)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {axes} ({n} ranks)")
        x = x.narrow(dim, i * (size // n), size // n)
    return x

