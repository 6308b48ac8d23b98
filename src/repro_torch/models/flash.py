"""Flash attention over the CUDA kernel: the forward of the JAX package's
``models/flash.py`` ``flash_attention``.

The GQA repeat and the 1/√D pre-scale (in q's dtype) happen here; the
(B, S, H, D) tensors are handed to ``kernels.ops.flash_attention_fwd``
as (B, H, S, D) views — the kernel reads them through strides and masks
the ragged kv edge itself, so nothing is padded.  On a CPU tensor the
wrapper runs the plain version.

The FA-2 backward (an ``autograd.Function``) and ``set_tile_dtype`` come
with training (ROADMAP Queue 1 item 10); until then a tensor that
requires grad is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from .layers import _repeat_kv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, cap: float = 0.0,
                    q_block: int = 1024, kv_block: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Drop-in replacement for ``layers.blockwise_attention``, same
    signature and semantics: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D)
    -> (B, Sq, Hq, D) in v's dtype.  ``q_block`` and ``kv_block`` only
    decide, as in the JAX package, whether a non-causal ragged kv is
    refused; the kernel's tiles are its own."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet (training: ROADMAP Queue 1 "
            "item 10); call it under torch.no_grad()")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, Hq // Hkv)
    v = _repeat_kv(v, Hq // Hkv)
    kb = min(kv_block, Skv)
    if (-Skv) % kb and not causal:
        raise ValueError("non-causal flash path requires kv length to be a "
                         "multiple of kv_block")
    q = q * torch.tensor(1.0 / np.sqrt(D), dtype=q.dtype)
    out = ops.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, cap=cap, scale=1.0,
                                  q_offset=q_offset)
    return out.transpose(1, 2).to(v.dtype)
