"""Serve step factories — the port of the JAX package's ``train/steps.py``
for the serving path: bf16 compute copies of f32 master parameters, and
the prefill and decode steps.  The train and eval steps come with
training (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..models.layers import Params


def cast_for_compute(params: Params, dtype=torch.bfloat16) -> Params:
    """f32 master -> ``dtype`` compute copies (matrices only; norms and
    vectors keep their dtype).  Returns ``params`` itself when nothing is
    to be cast, so a step handed an already-cast copy does no work."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(u) for u in tree]
        if tree.dtype == torch.float32 and tree.dim() >= 2:
            return tree.to(dtype)
        return tree

    if dtype == torch.float32 or not any(
            p.dtype == torch.float32 and p.dim() >= 2
            for p in params.parameters()):
        return params
    return Params(cast(params.tree()))


def make_prefill_step(cfg: ModelConfig, *, s_max: Optional[int] = None,
                      compute_dtype=torch.bfloat16) -> Callable:
    def prefill_step(params, batch):
        params_c = cast_for_compute(params, compute_dtype)
        return M.prefill(params_c, cfg, batch, s_max=s_max)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *,
                     compute_dtype=torch.bfloat16) -> Callable:
    """serve_step: one new token against the caches."""
    def decode_step(params, tokens, cache, cache_len):
        params_c = cast_for_compute(params, compute_dtype)
        return M.decode_step(params_c, cfg, tokens, cache, cache_len)
    return decode_step
