"""Train / serve step factories — the port of the JAX package's
``train/steps.py``.

``make_train_step``: microbatched gradient accumulation (a Python loop,
float32 sums scaled by 1/n), per-unit remat inside the model, bf16
compute from float32 master parameters: the cast runs inside the
differentiated function, so the masters receive float32 gradients.
The AdamW update (``optim.adamw``) then writes the masters and the
moments in place.  ``make_eval_step``, ``make_prefill_step`` and
``make_decode_step`` run the same cast without gradients.

Every step takes ``moe_groups`` as the JAX package's do and runs under
the caller's mesh (``distributed.sharding.use_mesh``; ``models/model.py``
says what a mesh changes).  Under a mesh the train step takes this
rank's shards of the training placement (``distributed.sharding.
shard_state`` cuts the parameters and the optimizer state alike)
and this rank's rows of the batch (``batch_coord``); microbatches split
those rows.  The model's tensor-parallel regions already sum over
"model" every gradient that needs it (``models/model.py``: a leaf every
model rank holds whole but reads in a region enters it through
``_ToModel``), so no leaf is summed over "model" here.  After the
backward:

  * the leaves kept whole over "data" (the norms, the biases, any leaf
    the divisibility fallback leaves whole, the leaves split only over
    "model") have their gradients summed over "pod" and "data", in one
    flat all-reduce;
  * the FSDP and expert leaves, whose gathers' backward already summed
    over "data", are summed over "pod" (a pure data-parallel axis);
  * the clip's norm is the global one (``optim.adamw.global_norm``,
    a leaf split over "model" counted once, its squares summed over
    "model"); the update stays elementwise on the rank's shards.

The gradients' reduction carries float32 (the masters' gradients); the
gathers' own backward carries the compute type.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..distributed.sharding import get_global_mesh, split_axes
from ..models import model as M
from ..models.config import ModelConfig
from ..models.layers import Params, jax_ndim
from ..optim.adamw import AdamWState, Hyper, adamw_update


def cast_for_compute(params: Params, dtype=torch.bfloat16):
    """f32 master -> ``dtype`` compute copies of the leaves whose JAX
    counterpart is a matrix (``layers.jax_ndim`` >= 2: the units' per-layer
    vectors too, which the JAX package's unit stack makes 2-D — ROADMAP
    F8, mirrored; the top-level norm and the hybrid's unstacked shared
    block keep their vectors).  Returns ``params`` itself when nothing is
    to be cast, so a step handed an already-cast copy does no work.
    Under autograd, with masters that require grad, the copy is a nested
    dict of tensors (read like ``Params``) whose casts are differentiated
    back to the masters; otherwise a ``Params`` of detached copies."""
    def cast(tree, name):
        if isinstance(tree, dict):
            return {k: cast(v, f"{name}{k}.") for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(u, f"{name}{i}.") for i, u in enumerate(tree)]
        if tree.dtype == torch.float32 and jax_ndim(name, tree) >= 2:
            return tree.to(dtype)
        return tree

    if dtype == torch.float32 or not any(
            p.dtype == torch.float32 and jax_ndim(n, p) >= 2
            for n, p in params.named_parameters()):
        return params
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in params.parameters()):
        return cast(params.tree(detach=False), "")
    return Params(cast(params.tree(), ""))


def _split_microbatches(batch: Dict, num: int):
    """The batch's leading axis cut into ``num`` equal microbatches."""
    def split(x):
        if x.shape[0] % num:
            raise ValueError(f"batch {tuple(x.shape)} does not split into "
                             f"{num} microbatches")
        return x.reshape((num, x.shape[0] // num) + tuple(x.shape[1:]))
    split_batch = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split_batch.items()} for i in range(num)]


def _sum_over(mesh, grads: list, axes) -> list:
    """``grads`` summed over ``axes`` in one flat all-reduce (a no-op
    where every axis has size 1)."""
    if not grads or all(mesh.shape.get(a, 1) == 1 for a in axes):
        return grads
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), axes)
    return [x.view_as(g) for x, g in zip(flat.split([g.numel()
                                                     for g in grads]),
                                         grads)]


def _reduce_grads(cfg: ModelConfig, mesh, names: list, grads: list):
    """The rank's gradients summed over the ranks that hold the same
    slice (module doc); returns them and each leaf's split axes."""
    specs, _ = M.placement(cfg, mesh)
    split = [split_axes(specs[n]) for n in names]
    whole = [i for i, s in enumerate(split) if "data" not in s]
    cut = [i for i, s in enumerate(split) if "data" in s]
    out = list(grads)
    for idx, axes in ((whole, ("pod", "data")), (cut, ("pod",))):
        for i, g in zip(idx, _sum_over(mesh, [grads[i] for i in idx], axes)):
            out[i] = g
    return out, split


def make_train_step(cfg: ModelConfig, hyper: Hyper, *,
                    num_microbatches: int = 1, moe_groups: int = 1,
                    remat: bool = True,
                    compute_dtype=torch.bfloat16) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` a ``Params`` of float32 masters (made trainable
    here) and ``opt_state`` from ``optim.adamw_init``.  Both are updated
    in place and returned; ``metrics`` holds 0-d device tensors
    ``loss``, ``lr`` and ``grad_norm``.  Under the caller's mesh both are
    the rank's shards and ``batch`` its rows (module doc); the metrics
    are the global batch's, the same on every rank."""

    def loss_and_grads(params, leaves, mb):
        with torch.enable_grad():
            params_c = cast_for_compute(params, compute_dtype)
            loss = M.loss_fn(params_c, cfg, mb, moe_groups=moe_groups,
                             remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(params: Params, opt_state: AdamWState, batch: Dict):
        params.requires_grad_(True)
        leaves = list(params.parameters())
        if num_microbatches == 1:
            loss, grads = loss_and_grads(params, leaves, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for mb in _split_microbatches(batch, num_microbatches):
                mb_loss, mb_grads = loss_and_grads(params, leaves, mb)
                loss = loss + mb_loss
                grads = [a + g.to(torch.float32)
                         for a, g in zip(grads, mb_grads)]
            inv = 1.0 / num_microbatches
            loss = loss * inv
            grads = [g * inv for g in grads]
        mesh, split = get_global_mesh(), None
        if mesh is not None:
            names = [n for n, _ in params.named_parameters()]
            grads, split = _reduce_grads(cfg, mesh, names, grads)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  hyper, mesh=mesh,
                                                  split=split)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, moe_groups: int = 1,
                   compute_dtype=torch.bfloat16) -> Callable:
    """eval_step(params, batch) -> the loss, a 0-d float32 tensor (under
    a mesh the global batch's, from the rank's shards and rows)."""
    @torch.no_grad()
    def eval_step(params, batch):
        params_c = cast_for_compute(params, compute_dtype)
        return M.loss_fn(params_c, cfg, batch, moe_groups=moe_groups)
    return eval_step


def make_prefill_step(cfg: ModelConfig, *, moe_groups: int = 1,
                      s_max: Optional[int] = None,
                      compute_dtype=torch.bfloat16) -> Callable:
    def prefill_step(params, batch):
        params_c = cast_for_compute(params, compute_dtype)
        return M.prefill(params_c, cfg, batch, s_max=s_max,
                         moe_groups=moe_groups)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, moe_groups: int = 1,
                     compute_dtype=torch.bfloat16) -> Callable:
    """serve_step: one new token against the caches."""
    def decode_step(params, tokens, cache, cache_len):
        params_c = cast_for_compute(params, compute_dtype)
        return M.decode_step(params_c, cfg, tokens, cache, cache_len,
                             moe_groups=moe_groups)
    return decode_step
