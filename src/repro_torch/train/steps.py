"""Train / serve step factories — the port of the JAX package's
``train/steps.py``.

``make_train_step``: microbatched gradient accumulation (a Python loop,
float32 sums scaled by 1/n), per-unit remat inside the model, bf16
compute from float32 master parameters: the cast runs inside the
differentiated function, so the masters receive float32 gradients.
The AdamW update (``optim.adamw``) then writes the masters and the
moments in place.  ``make_eval_step``, ``make_prefill_step`` and
``make_decode_step`` run the same cast without gradients.

The prefill and decode steps take ``moe_groups`` as the JAX package's
do and run under the caller's mesh (``distributed.sharding.use_mesh``;
``models/model.py`` says what a mesh changes).  Training under a mesh
of several ranks (the gradient reduction over the data axis) is not
ported yet, and the train and eval steps route each MoE block as one
group.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

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


def make_train_step(cfg: ModelConfig, hyper: Hyper, *,
                    num_microbatches: int = 1, remat: bool = True,
                    compute_dtype=torch.bfloat16) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` a ``Params`` of float32 masters (made trainable
    here) and ``opt_state`` from ``optim.adamw_init``.  Both are updated
    in place and returned; ``metrics`` holds 0-d device tensors
    ``loss``, ``lr`` and ``grad_norm``."""

    def loss_and_grads(params, leaves, mb):
        with torch.enable_grad():
            params_c = cast_for_compute(params, compute_dtype)
            loss = M.loss_fn(params_c, cfg, mb, remat=remat)
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
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  hyper)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *,
                   compute_dtype=torch.bfloat16) -> Callable:
    """eval_step(params, batch) -> the loss, a 0-d float32 tensor."""
    @torch.no_grad()
    def eval_step(params, batch):
        params_c = cast_for_compute(params, compute_dtype)
        return M.loss_fn(params_c, cfg, batch)
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
