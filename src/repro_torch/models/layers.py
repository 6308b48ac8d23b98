"""Core NN layers: RMSNorm, RoPE, GQA attention (global / sliding-window,
softcap, blockwise-streaming), gated MLP — the port of the JAX package's
``models/layers.py``.

Activations keep the JAX layout, (B, S, H, D).  ``blockwise_attention``
is the plain online-softmax attention (``attn_impl="ref"``);
``flash.flash_attention`` is the same function over the CUDA kernel.
``decode_attention`` and the matrix products are plain PyTorch, as the
JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu}[name]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a ``(1 + scale)`` gain, computed in float32."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (torch.tanh(x / cap) * cap).to(x.dtype) if cap else x


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)       # no host-to-device copy


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Split
    halves, float32 inside."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs      # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise attention (the plain prefill path)
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) of a (B, S, H, D) tensor."""
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0, cap: float = 0.0,
                        q_block: int = 1024, kv_block: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``window`` > 0 restricts to a sliding window (gemma2 local layers).
    ``q_offset``: absolute position of q[0] (decode with cache).
    Returns (B, Sq, Hq, D) in v's dtype.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, Hq // Hkv)
    v = _repeat_kv(v, Hq // Hkv)

    qb = min(q_block, Sq)
    kb = min(kv_block, Skv)
    pq, pk = (-Sq) % qb, (-Skv) % kb
    q, k, v = _pad_seq(q, pq), _pad_seq(k, pk), _pad_seq(v, pk)
    nq, nk = (Sq + pq) // qb, (Skv + pk) // kb

    scale = 1.0 / np.sqrt(D)
    q = (q * scale).to(q.dtype)
    dev = q.device
    q_pos_base = torch.arange(qb, device=dev)
    k_pos_base = torch.arange(kb, device=dev)

    outs = []
    for qi in range(nq):
        qblk = q[:, qi * qb:(qi + 1) * qb].to(torch.float32)
        q_pos = q_offset + qi * qb + q_pos_base                  # (qb,)
        m = torch.full((B, Hq, qb), -torch.inf, device=dev)
        l = torch.zeros((B, Hq, qb), device=dev)
        acc = torch.zeros((B, Hq, qb, D), device=dev)
        for ki in range(nk):
            kblk = k[:, ki * kb:(ki + 1) * kb].to(torch.float32)
            vblk = v[:, ki * kb:(ki + 1) * kb].to(torch.float32)
            k_pos = ki * kb + k_pos_base                          # (kb,)
            s = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk)
            s = softcap(s, cap) if cap else s
            mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                       vblk)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2))                          # (B, qb, H, D)
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(v.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, cap: float = 0.0,
                     window: int = 0) -> torch.Tensor:
    """Single-step attention against a (B, S_max, Hkv, D) cache.

    q: (B, 1, Hq, D); ``cache_len``: int, scalar or (B,) valid prefix
    length (the new token is already written at position cache_len-1).
    ``window`` > 0 restricts to the trailing sliding window.
    """
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    n_rep = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    qh = (q[:, 0] * scale).reshape(B, Hkv, n_rep, D)
    s = torch.einsum("bgrd,bsgd->bgrs", qh.to(torch.float32),
                     k_cache.to(torch.float32))
    s = softcap(s, cap) if cap else s
    pos = torch.arange(k_cache.shape[1], device=q.device)
    # an int stays on the host: a device copy of it would wait for the card
    clen = (cache_len.reshape(-1, 1) if torch.is_tensor(cache_len)
            else cache_len)
    valid = pos[None, :] < clen
    if window:
        valid &= pos[None, :] >= (clen - window)
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """The gated MLP.  Given a rank's ffn slices of the three matrices
    (tensor parallelism) it returns that slice's partial product; the
    caller sums it over "model" (``model._mlp``)."""
    h = act_fn(act)(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def jax_ndim(name: str, p: torch.Tensor) -> int:
    """The rank of the JAX package's counterpart of the parameter
    ``name`` (a dotted ``named_parameters`` name): a leaf under ``units``
    carries the leading ``n_units`` axis of the JAX unit stack there."""
    return p.dim() + (name.split(".", 1)[0] == "units")


def normal(generator: torch.Generator | None, *shape) -> torch.Tensor:
    """Standard normal draws from ``generator`` on its device; with no
    generator, an empty tensor of that shape on the ``meta`` device (the
    shapes of ``model.abstract_params``)."""
    if generator is None:
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device)


def scaled_normal(generator: torch.Generator | None, scale: float, dtype,
                  *shape) -> torch.Tensor:
    """``normal`` draws times ``scale``, cast to ``dtype``; with no
    generator an empty ``meta`` tensor of that shape and dtype.  No
    arithmetic runs on ``meta``: torch's elementwise ops there import its
    compiler stack, seconds of host time on the first call."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (normal(generator, *shape) * scale).to(dtype)


def mlp_init(generator: torch.Generator | None, d_model: int, d_ff: int,
             dtype) -> dict:
    """The gated MLP's three matrices, drawn from ``generator`` (on its
    device) as the JAX package scales them."""
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(d_ff)
    return {
        "w_gate": scaled_normal(generator, s_in, dtype, d_model, d_ff),
        "w_up": scaled_normal(generator, s_in, dtype, d_model, d_ff),
        "w_down": scaled_normal(generator, s_out, dtype, d_ff, d_model),
    }


class Params(nn.Module):
    """A module read like the JAX package's parameter dicts: ``p["wq"]``,
    ``"post_ln1" in p``.  Built from a nested dict of tensors (a list
    becomes a ``ModuleList``); the tensors become parameters without a
    copy.  The serving path holds no gradients, so they do not require
    them; ``requires_grad_()`` makes them the trainable float32 masters
    of a train step (``train.steps.make_train_step`` does)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(u) for u in val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self, detach: bool = True) -> dict:
        """The nested dict of tensors this module holds (``detach=False``:
        the parameters themselves, so what is computed from them is
        differentiated back to them)."""
        out = {name: p.data if detach else p
               for name, p in self._parameters.items()}
        for name, mod in self._modules.items():
            out[name] = ([u.tree(detach) for u in mod]
                         if isinstance(mod, nn.ModuleList)
                         else mod.tree(detach))
        return out
