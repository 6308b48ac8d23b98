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

``train_specs`` is the placement every entry point runs on under a mesh
(training and serving alike): ``param_specs`` — FSDP over "data", the
dense leaves over "model" (heads, ffn, vocabulary, the SSM's d_inner)
with the divisibility fallback — and the MoE leaves as the
expert-parallel body reads them (``moe_sharded.MOE_SPECS``: experts over
"model", FSDP over "data").  ``shard_state`` cuts a whole ``Params`` /
``AdamWState`` tree into this rank's shards by it, ``gather_state``
gathers the shards back whole.

``dp_shards`` and ``batch_coord`` give a mesh's data-parallel shard
count and this rank's index among them (the models split the batch by
them; ``launch.mesh`` re-exports them as the JAX package's module has
``dp_shards``).

Placement is explicit in eager PyTorch.  The JAX package annotates the
activations with ``constrain`` and GSPMD derives the tensor-parallel
program of the dense layers from the parameters' placement; here that
program is written out for one rank (``models/model.py``,
``models/ssm.py``) with the collectives below, the way the reference
writes its two explicit-SPMD bodies (the expert-parallel MoE,
``moe_sharded.py``, and the sequence-split decode, ``decode_sp.py``):

  * ``_ToModel`` — the identity, whose backward sums the gradient over
    "model" — takes a replicated activation, or a leaf every model rank
    holds whole, into a region where each rank computes its slice;
  * ``_FromModel`` — a sum over "model", whose backward is the identity —
    brings the ranks' partial products out of it (the Megatron pair);
  * ``_GatherModel`` gathers the ranks' slices whole (the logits the
    entry points return); its backward keeps the rank's slice;
  * ``_GatherData`` is FSDP's gather over "data"; its backward sums the
    gradient over "data" and keeps the rank's slice.
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
    """``{name: spec}`` of the placement for every parameter of a whole
    ``Params`` (real or ``meta``), in ``named_parameters`` order:

      * a leaf of a MoE block (``...moe.router``, ``...moe.w_gate``,
        ``...moe.shared.w_up``, ...) takes ``moe_sharded.MOE_SPECS``'
        rule: the router FSDP over "data" and replicated over "model",
        the experts over "model" on E and over "data" on d;
      * any other leaf takes ``param_specs``' rule: FSDP over "data" and
        tensor parallel over "model" where the rules put them, whole on
        any dimension the axis does not divide (the divisibility
        fallback).
    """
    from ..models.moe_sharded import MOE_SPECS   # moe_sharded imports us

    out = {}
    for name, p in params.named_parameters():
        _, moe, rest = name.partition(".moe.")
        rule = MOE_SPECS[rest] if moe else leaf_logical(name, p.dim())
        out[name] = _resolve(rule, mesh, tuple(p.shape))
    return out


def model_ranks(mesh) -> int:
    """The size of ``mesh``'s "model" axis (1 with no mesh or no axis)."""
    return 1 if mesh is None else mesh.shape.get("model", 1)


def model_slice(n: int, mesh) -> Tuple[int, int]:
    """[lo, hi): this model rank's slice of a dimension of ``n`` that the
    "model" axis splits (the caller checked that it divides)."""
    m = model_ranks(mesh)
    i = mesh.coord("model") if m > 1 else 0
    return i * (n // m), (i + 1) * (n // m)


class _ToModel(torch.autograd.Function):
    """Identity on each of ``xs``; the backward sums their gradients over
    "model", in one flat all-reduce."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return xs if len(xs) > 1 else xs[0]

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        flat = ctx.mesh.all_reduce(flat, "model")
        return (None,) + tuple(x.view_as(g) for x, g in zip(
            flat.split([g.numel() for g in gs]), gs))


class _FromModel(torch.autograd.Function):
    """All-reduce (sum) over "model"; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """All-gather over "model" on ``dim``; the backward keeps this rank's
    slice (the gathered tensor's consumers run on every rank alike)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        return mesh.all_gather(x.contiguous(), "model", dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coord("model")
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None


class _GatherData(torch.autograd.Function):
    """All-gather over "data" on ``dim``; the backward sums the gradient
    over "data" and keeps this rank's slice (a reduce-scatter), copied so
    that the whole gradient is freed once the slice is taken."""

    @staticmethod
    def forward(ctx, w, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, w.shape[dim]
        return mesh.all_gather(w, "data", dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce(g.contiguous(), "data")
        i = ctx.mesh.coord("data")
        return g.narrow(ctx.dim, i * ctx.size, ctx.size).clone(), None, None


def to_model(mesh, *xs):
    """``xs`` into a model-parallel region (``_ToModel``); themselves when
    ``mesh`` has no "model" axis to sum over or nothing needs a
    gradient."""
    if model_ranks(mesh) == 1 or not (torch.is_grad_enabled() and any(
            x.requires_grad for x in xs)):
        return xs if len(xs) > 1 else xs[0]
    return _ToModel.apply(mesh, *xs)


def from_model(x, mesh):
    """The ranks' partial ``x`` summed over "model" (``_FromModel``)."""
    return x if model_ranks(mesh) == 1 else _FromModel.apply(x, mesh)


def gather_model(x, mesh, dim: int):
    """The ranks' slices of ``x`` on ``dim`` gathered whole
    (``_GatherModel``)."""
    return x if model_ranks(mesh) == 1 else _GatherModel.apply(x, mesh, dim)


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

