"""Sequence-parallel decode attention — the port of the JAX package's
``models/decode_sp.py`` (its ``shard_map`` body, written out for one
rank of a ``launch.mesh.Mesh``).

GQA models with few KV heads (yi-9b kv=4, command-r/chameleon kv=8)
cannot split their KV caches by head across a wide "model" axis; the
cache is split over the SEQUENCE axis instead: each model rank holds an
S/m slice at its true KV-head count, computes partial attention over its
slice, and the ranks combine with the distributed softmax (a MAX
all-reduce of the row maxima, then one SUM all-reduce of the numerators
and denominators) — O(B·H·D) bytes a layer.

The new token's K/V is written, in place, only by the rank that owns
slot ``cache_len``; the other ranks' slices are unchanged.

Under tensor parallelism of the attention (``heads_split``) q holds the
model rank's heads, and k_new / v_new its KV heads where "model" splits
them: the reference's body takes them with every head
(``in_specs`` ``P(batch, None, None, None)``), so they are gathered over
"model" first (one all-gather of the three), and the rank keeps its
heads of the output for its slice of ``wo``.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import softcap as _softcap


def decode_attention_seq_sharded(q, k_new, v_new, k_cache, v_cache,
                                 cache_len: int, mesh, *, cap: float = 0.0,
                                 heads_split: bool = False):
    """q: (B, 1, Hq, D); k_new/v_new: (B, 1, Kv, D); caches: this rank's
    (B, S/m, Kv, D) slices of the sequence axis, the model rank's
    coordinate giving their offset.  Returns (attn (B, 1, Hq, D),
    k_cache, v_cache), the caches written in place.  ``heads_split``
    (module doc): q and the returned attention are the rank's Hq / m
    heads."""
    B, S_loc, Kv, D = k_cache.shape
    if heads_split:                     # one gather of q ‖ k_new ‖ v_new
        h_loc, k_loc = q.shape[2], k_new.shape[2]
        parts = [q] if k_loc == Kv else [q, k_new, v_new]
        g = mesh.all_gather(torch.cat(parts, dim=2)[None], "model", dim=0)
        g = g.movedim(0, 2)             # (B, 1, m, heads of a rank, D)
        q = g[..., :h_loc, :].reshape(B, 1, -1, D)
        if k_loc != Kv:
            k_new = g[..., h_loc:h_loc + k_loc, :].reshape(B, 1, Kv, D)
            v_new = g[..., h_loc + k_loc:, :].reshape(B, 1, Kv, D)
    Hq = q.shape[2]
    rep = Hq // Kv
    offset = mesh.coord("model") * S_loc
    cache_len = int(cache_len)

    # write the new key/value if this rank owns slot `cache_len`
    slot = cache_len - offset
    if 0 <= slot < S_loc:
        k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)

    # partial attention over the local slice
    scale = 1.0 / np.sqrt(D)
    qh = (q[:, 0] * scale).reshape(B, Kv, rep, D)
    s = torch.einsum("bgrd,bsgd->bgrs", qh.to(torch.float32),
                     k_cache.to(torch.float32))
    s = _softcap(s, cap) if cap else s
    pos = offset + torch.arange(S_loc, device=q.device)
    valid = pos[None, :] <= cache_len
    s = torch.where(valid[:, None, None, :], s, -torch.inf)

    m = mesh.all_reduce(s.amax(dim=-1), "model", op="max")
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid[:, None, None, :], torch.exp(s - m_safe[..., None]),
                    0.0)
    num = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.to(torch.float32))
    nd = mesh.all_reduce(torch.cat([num, p.sum(dim=-1)[..., None]], dim=-1),
                         "model")                           # num ‖ den
    out = nd[..., :D] / torch.clamp(nd[..., D:], min=1e-30)
    out = out.reshape(B, 1, Hq, D).to(q.dtype)
    if heads_split:
        i = mesh.coord("model")
        out = out[:, :, i * h_loc:(i + 1) * h_loc]
    return out, k_cache, v_cache
