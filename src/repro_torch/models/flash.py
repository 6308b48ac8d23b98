"""Flash attention over the CUDA kernels: the port of the JAX package's
``models/flash.py`` ``flash_attention`` with its FA-2 backward.

The GQA repeat and the 1/√D pre-scale (in q's dtype) happen here, as
autograd operations, so their gradients (the sum over a kv head's
repeats, the scale) are autograd's, as they are JAX's.  The (B, S, H, D)
tensors are handed to the kernels as (B, H, S, D) views — the kernels
read and write through strides and mask the ragged kv edge themselves,
so nothing is padded.

``_FlashAttention`` is the ``autograd.Function`` that runs when a
gradient will be asked for: its forward runs
``kernels.ops.flash_attention_fwd(..., return_lse=True)`` and saves
(q, k, v, out, lse); its backward runs ``kernels.ops.flash_attention_bwd``.
Without one (serving) the forward runs alone, with no lse.  On a CPU
tensor both wrappers run their plain versions.

Under tensor parallelism the model hands it a rank's heads (q of its
H / m heads, k and v of the KV heads those map to), so the repeat and
the kernels run at the local head counts.

``set_tile_dtype`` has the meaning of the JAX package's: bfloat16 tiles
round P (and dS) and the operands they multiply to bfloat16; the
log-sum-exp statistics stay float32 in either mode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from .layers import _repeat_kv

# probability tiles: float32 = exact (the default, as in the JAX package);
# bfloat16 rounds them as its TILE_DTYPE does.
TILE_DTYPE = torch.float32


def set_tile_dtype(dtype) -> None:
    global TILE_DTYPE
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tile dtype must be float32 or bfloat16, got "
                         f"{dtype}")
    TILE_DTYPE = dtype


class _FlashAttention(torch.autograd.Function):
    """(B, H, S, D) flash attention and its FA-2 backward; ``kw`` the
    wrappers' keywords (``scale`` 1: q comes pre-scaled)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse,
                                             dout.to(out.dtype), **ctx.kw)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, cap: float = 0.0,
                    q_block: int = 1024, kv_block: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Drop-in replacement for ``layers.blockwise_attention``, same
    signature and semantics, differentiable: q (B, Sq, Hq, D), k and v
    (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in v's dtype.  ``q_block`` and
    ``kv_block`` only decide, as in the JAX package, whether a non-causal
    ragged kv is refused; the kernels' tiles are their own."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, Hq // Hkv)
    v = _repeat_kv(v, Hq // Hkv)
    kb = min(kv_block, Skv)
    if (-Skv) % kb and not causal:
        raise ValueError("non-causal flash path requires kv length to be a "
                         "multiple of kv_block")
    q = q * torch.tensor(1.0 / np.sqrt(D), dtype=q.dtype)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(causal=causal, window=window, cap=cap, scale=1.0,
              q_offset=q_offset, tile_bf16=TILE_DTYPE == torch.bfloat16)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = _FlashAttention.apply(q, k, v, kw)
    else:                            # serving: no lse, no saved tensors
        out = ops.flash_attention_fwd(q, k, v, **kw)
    return out.transpose(1, 2).to(v.dtype)
