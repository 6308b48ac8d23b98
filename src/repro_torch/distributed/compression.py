"""Gradient compression for a cross-node all-reduce — the port of the JAX
package's ``distributed/compression.py``.

int8 + error feedback: per-tensor symmetric quantization with a residual
buffer, so the quantization error is re-injected next step.
``compress`` runs before the all-reduce, ``decompress`` after; the int8
payload is ~4x fewer bytes than float32.  On one card nothing calls it
on the train path; it keeps ``distributed/`` whole.  Trees are nested
dicts and lists of tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..optim.adamw import leaves

Tree = Any


class CompressedGrads(NamedTuple):
    q: Tree        # int8 payloads
    scale: Tree    # f32 per-tensor scales


def _map(fn: Callable, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def init_error_feedback(params: Tree) -> Tree:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compress(grads: Tree, error: Tree) -> Tuple[CompressedGrads, Tree]:
    """Quantize grads+error to int8; returns payload and the new residual."""
    def one(g, e):
        g = g.to(torch.float32) + e
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        residual = g - q.to(torch.float32) * scale
        return q, scale, residual

    out = _map(one, grads, error)
    return (CompressedGrads(q=_field(out, 0), scale=_field(out, 1)),
            _field(out, 2))


def _field(out, i: int):
    """Field ``i`` of every (q, scale, residual) leaf of ``out``."""
    if isinstance(out, dict):
        return {k: _field(v, i) for k, v in out.items()}
    if isinstance(out, list):
        return [_field(v, i) for v in out]
    return out[i]


def decompress(c: CompressedGrads) -> Tree:
    return _map(lambda q, s: q.to(torch.float32) * s, c.q, c.scale)


def compressed_bytes(c: CompressedGrads) -> int:
    qs = leaves(c.q)
    return sum(x.numel() for x in qs) + 4 * len(qs)
