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

``train_specs`` is the training placement: ``param_specs`` without the
"model" entries of the dense leaves (the port has no tensor parallelism,
so each model rank holds a dense leaf's data shard whole), FSDP over
"data" kept, and the MoE leaves as the expert-parallel body reads them
(``moe_sharded.MOE_SPECS``: experts over "model", FSDP over "data").
``shard_state`` cuts a whole ``Params`` / ``AdamWState`` tree into this
rank's shards by it, ``gather_state`` gathers the shards back whole.

``dp_shards`` and ``batch_coord`` give a mesh's data-parallel shard
count and this rank's index among them (the models split the batch by
them; ``launch.mesh`` re-exports them as the JAX package's module has
``dp_shards``).

Placement is explicit in eager PyTorch.  The JAX package's
``constrain`` — the activation annotation from which GSPMD derives the
tensor parallelism of the dense layers — has no counterpart here: no
automatic partitioner would read it, and each model rank holds a dense
leaf's data shard whole.  What runs sharded are the two explicit-SPMD
bodies of the reference — the MoE block under expert parallelism
(``moe_sharded.py``) and the sequence-sharded decode cache
(``decode_sp.py``) — and FSDP over "data": the model gathers each
unit's shards as it runs it (``models/model.py``); the data axis splits
the batch.
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


# ---------------------------------------------------------------------------
# the training placement
# ---------------------------------------------------------------------------

def train_specs(params, mesh) -> dict:
    """``{name: spec}`` of the training placement for every parameter of a
    whole ``Params`` (real or ``meta``), in ``named_parameters`` order:

      * a leaf of a MoE block (``...moe.router``, ``...moe.w_gate``,
        ``...moe.shared.w_up``, ...) takes ``moe_sharded.MOE_SPECS``'
        rule: the router FSDP over "data" and replicated over "model",
        the experts over "model" on E and over "data" on d;
      * any other leaf takes ``param_specs``' rule without its "model"
        entries: FSDP over "data" where the rules put it, whole over
        "model" (no tensor parallelism), whole wherever "data" does not
        divide the dimension (the divisibility fallback).
    """
    from ..models.moe_sharded import MOE_SPECS   # moe_sharded imports us

    out = {}
    for name, p in params.named_parameters():
        _, moe, rest = name.partition(".moe.")
        shape = tuple(p.shape)
        if moe:
            out[name] = _resolve(MOE_SPECS[rest], mesh, shape)
        else:
            spec = _resolve(leaf_logical(name, p.dim()), mesh, shape)
            out[name] = tuple(None if e == "model" else e for e in spec)
    return out


def split_axes(spec: Sequence) -> Tuple[str, ...]:
    """The mesh axes that split a leaf under ``spec``, in mesh order of
    first appearance."""
    axes = []
    for entry in spec:
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            if a not in axes:
                axes.append(a)
    return tuple(axes)


def gather_whole(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The whole tensor from this rank's shard ``x`` under ``spec``:
    ``local_shard``'s inverse, every rank of the split axes joining (the
    minor axis of a several-axis entry first)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in reversed((entry,) if isinstance(entry, str) else entry):
            x = mesh.all_gather(x, a, dim=dim)
    return x


def _map_params(params, fn, *, as_params: bool = True):
    """A ``Params`` (``as_params=False``: the nested dict) of ``fn(name,
    tensor)`` over every leaf of ``params``, in ``named_parameters``
    order and under its names."""
    from ..models.layers import Params

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(u, f"{prefix}{i}.") for i, u in enumerate(tree)]
        return fn(prefix[:-1], tree)

    tree = walk(params.tree(), "")
    return Params(tree) if as_params else tree


def _map_state(tree, fn_params):
    """``tree`` with every ``Params`` in it (a dict's values, a
    NamedTuple's fields) replaced by ``fn_params(params)``; other leaves
    (the optimizer's step) unchanged."""
    from ..models.layers import Params

    if isinstance(tree, Params):
        return fn_params(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_state(getattr(tree, f), fn_params)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_state(v, fn_params) for k, v in tree.items()}
    return tree


def shard_state(tree, mesh):
    """This rank's shards of a whole state tree (a ``Params``, an
    ``AdamWState``, or a dict of them), each ``Params`` cut by its
    ``train_specs`` (read from its whole shapes): each leaf that is cut
    a contiguous copy, each leaf kept whole the same tensor."""
    def leaf(spec, x):
        if not any(spec):
            return x
        return local_shard(x, spec, mesh).clone(
            memory_format=torch.contiguous_format)

    def cut(params):
        specs = train_specs(params, mesh)
        return _map_params(params, lambda n, x: leaf(specs[n], x))
    return _map_state(tree, cut)


def gather_state(tree, mesh, specs: dict):
    """``shard_state``'s inverse: every ``Params`` of ``tree`` gathered
    whole by ``specs`` (``train_specs`` of the whole parameters).  A
    collective on every rank, leaf by leaf in ``named_parameters``
    order, so every rank must call it at the same point."""
    return _map_state(tree, lambda params: _map_params(
        params, lambda n, x: gather_whole(x, specs[n], mesh)))


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

