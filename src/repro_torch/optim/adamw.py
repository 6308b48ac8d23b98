"""AdamW + cosine schedule + global-norm clipping — the port of the JAX
package's ``optim/adamw.py``.

Parameters are a ``models.layers.Params`` of float32 masters; the
moments ``mu`` and ``nu`` are ``Params`` of the same structure (so
checkpoints name them as the JAX package's pytrees), and ``step`` an
int32 0-d tensor on the parameters' device.  The arithmetic is the JAX
package's, in float32 and in the same order (``m/b1c``,
``sqrt(vhat) + eps``, weight decay on the tensors whose JAX counterpart
has two or more dimensions: the units' per-layer vectors too, which the
JAX package's unit stack makes 2-D — ROADMAP F8, mirrored), so one
update lies within a float32 ulp or two of it.  Unlike
the JAX package, ``adamw_update`` writes the parameters and moments in
place (no second copy of either) and returns the same objects.

Gradients are a sequence of tensors in ``params.parameters()`` order, or
a nested dict / list / ``Params`` of that structure.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Tuple

import torch
from torch import nn

from ..models.layers import Params, jax_ndim

Tree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Params           # f32, like params
    nu: Params           # f32, like params


class Hyper(NamedTuple):
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree: Tree) -> List[torch.Tensor]:
    """A tree's tensors in order: a module's parameters in registration
    order, a dict's values in insertion order, a sequence's items."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _zeros_like(params: Params) -> Params:
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zeros(u) for u in tree]
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    return Params(zeros(params.tree()))


def adamw_init(params: Params) -> AdamWState:
    """Zero moments beside ``params`` (on their devices) and step 0."""
    dev = next(params.parameters()).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_zeros_like(params), nu=_zeros_like(params))


def abstract_opt_state(params: Params) -> AdamWState:
    """``adamw_init``'s state for ``model.abstract_params``' parameters:
    shapes and dtypes on the ``meta`` device."""
    return adamw_init(params)


def cosine_lr(step: torch.Tensor, h: Hyper) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(h.warmup_steps, 1)
    t = torch.clamp((step - h.warmup_steps)
                    / max(h.total_steps - h.warmup_steps, 1), 0.0, 1.0)
    cos = h.min_lr_frac + (1 - h.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return h.base_lr * torch.where(step < h.warmup_steps, warm, cos)


def global_norm(tree: Tree, *, mesh=None, split=None) -> torch.Tensor:
    """The global L2 norm of ``tree``'s leaves.  Under a mesh the leaves
    are the rank's shards and ``split`` gives, leaf by leaf, the mesh
    axes that split it (``distributed.sharding.split_axes``): each
    group of leaves split alike sums its squares, the sum is reduced
    over the axes that split the group — never over those that
    replicate it, where it would count m times — and the groups are
    added, so every rank holds the same norm."""
    xs = leaves(tree)
    if mesh is None or not any(split):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in xs))
    groups: dict = {}
    for x, axes in zip(xs, split):
        groups.setdefault(tuple(axes), []).append(
            torch.sum(torch.square(x.to(torch.float32))))
    total = 0.0
    for axes in sorted(groups):              # the same order on every rank
        part = sum(groups[axes])
        total = total + (mesh.all_reduce(part, axes) if axes else part)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float, *, mesh=None,
                        split=None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(the grads scaled to a global norm of at most ``max_norm``, as a
    list in ``leaves`` order; the norm before).  ``mesh`` and ``split``
    as ``global_norm``'s: the scale is one number on every rank."""
    norm = global_norm(grads, mesh=mesh, split=split)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale for g in leaves(grads)], norm


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Params,
                 h: Hyper, *, mesh=None, split=None
                 ) -> Tuple[Params, AdamWState, dict]:
    """One clipped AdamW step, written into ``params``, ``state.mu`` and
    ``state.nu``.  Returns (params, the new state, {"lr", "grad_norm"}).
    Under a mesh (``mesh``, ``split``: ``global_norm``'s) the tensors are
    the rank's shards and the gradients already reduced over the ranks;
    the norm is the global one and the update stays elementwise on the
    shard."""
    grads = [g.to(torch.float32) for g in leaves(grads)]
    grads, gnorm = clip_by_global_norm(grads, h.clip_norm, mesh=mesh,
                                       split=split)
    step = state.step + 1
    lr = cosine_lr(step, h)
    b1c = 1 - h.b1 ** step.to(torch.float32)
    b2c = 1 - h.b2 ** step.to(torch.float32)
    named = list(params.named_parameters())
    ms, vs = leaves(state.mu), leaves(state.nu)
    if not len(named) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"{len(grads)} grads and {len(ms)}/{len(vs)} "
                         f"moments for {len(named)} parameters")
    for (name, p), g, m, v in zip(named, grads, ms, vs):
        m.mul_(h.b1).add_((1 - h.b1) * g)
        v.mul_(h.b2).add_((1 - h.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + h.eps)
        if jax_ndim(name, p) >= 2:  # the reference's matrices (F8)
            delta = delta + h.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
