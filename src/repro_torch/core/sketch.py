"""Similarity-preserving hashing: b-bit minhash (paper §I, §VI-A).

``bbit_minhash`` [Li & König, WWW'10] maps sets to length-L strings over
Σ=[0, 2^b): L independent min-wise hashes ``h_j(x) = mix32(a_j·x + c_j)``
over uint32 arithmetic, keeping the low b bits of each minimum — the
*b-bit sketches* the index consumes.  Collision probability per
position ≈ J + (1-J)/2^b for Jaccard J.

The JAX package draws (a, c) from a ``jax.random`` key, whose bits torch
cannot reproduce; here the hash parameters are explicit (L,) tensors, so
one set of parameters gives the same sketches in both packages.
``hash_params`` draws fresh ones from a ``torch.Generator`` in the same
ranges (a odd in [1, 2^31), c in [0, 2^31)).

uint32 multiplies wrap mod 2^32, and a product of two 32-bit values
reaches 2^64, past int64.  ``_mul32`` splits one factor into 16-bit
halves so that every partial product stays below 2^48, then masks: no
step relies on int64 overflow.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_INT32_MAX = 2 ** 31 - 1


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 tensors/ints holding uint32 values."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_params(L: int, generator: torch.Generator | None = None,
                device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``(a, c)``: (L,) int64 tensors, a odd in [1, 2^31), c in
    [0, 2^31) — the ranges of the JAX package's ``_hash_params``."""
    a = torch.randint(1, _INT32_MAX, (L,), generator=generator,
                      dtype=torch.int64, device=device) | 1
    c = torch.randint(0, _INT32_MAX, (L,), generator=generator,
                      dtype=torch.int64, device=device)
    return a, c


def _params(params, L: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    a, c = ((p if isinstance(p, torch.Tensor)
             else torch.from_numpy(np.array(p, dtype=np.int64)))
            .to(device=device, dtype=torch.int64) & _M32 for p in params)
    if a.shape != (L,) or c.shape != (L,):
        raise ValueError(f"hash parameters must be two ({L},) vectors, got "
                         f"{tuple(a.shape)} and {tuple(c.shape)}")
    return a, c


def bbit_minhash(params, items: torch.Tensor, mask: torch.Tensor, *,
                 L: int, b: int) -> torch.Tensor:
    """b-bit minhash of a batch of sets.

    params: ``(a, c)``, the (L,) uint32 hash parameters (tensors or
            arrays; ``hash_params`` draws them);
    items:  (batch, max_items) int32 feature ids (padded);
    mask:   (batch, max_items) bool validity;
    returns (batch, L) uint8 sketches over [0, 2^b), on ``items``'
    device.  The (batch, max_items, L) int64 intermediate is the memory
    cost: callers chunk the batch.
    """
    items = torch.as_tensor(items)
    mask = torch.as_tensor(mask, device=items.device)
    a, c = _params(params, L, items.device)
    x = items.to(torch.int64) & _M32                      # uint32 view
    hashed = _mix32((_mul32(x[:, :, None], a) + c) & _M32)
    hashed = torch.where(mask[:, :, None], hashed, _M32)
    mins = hashed.amin(dim=1)                             # (batch, L)
    return (mins & ((1 << b) - 1)).to(torch.uint8)


def jaccard(items_a, mask_a, items_b, mask_b) -> torch.Tensor:
    """Exact Jaccard between two padded sets — the oracle for minhash.
    items_*: (batch, max_items) int32 ids; mask_*: (batch, max_items)
    bool validity -> (batch,) float32."""
    items_a, items_b = torch.as_tensor(items_a), torch.as_tensor(items_b)
    mask_a = torch.as_tensor(mask_a, device=items_a.device)
    mask_b = torch.as_tensor(mask_b, device=items_a.device)
    ia = torch.where(mask_a, items_a, -1)
    ib = torch.where(mask_b, items_b.to(items_a.device), -2)
    inter = (ia[:, :, None] == ib[:, None, :]).any(dim=2) & mask_a
    ni = inter.sum(dim=1, dtype=torch.int32)
    nu = (mask_a.sum(dim=1, dtype=torch.int32)
          + mask_b.sum(dim=1, dtype=torch.int32) - ni)
    # float64 division of the counts, rounded once: the IEEE float32
    # quotient on every backend
    ratio = (ni.to(torch.float64) / nu.to(torch.float64)).to(torch.float32)
    return torch.where(nu > 0, ratio, 0.0)


def sketch_tokens(params, tokens: torch.Tensor, *, L: int,
                  b: int) -> torch.Tensor:
    """Sketch token sequences: each (batch, seq) int32 row is the *set*
    of its non-negative token ids (negative = padding), as in the
    paper's Review preprocessing."""
    tokens = torch.as_tensor(tokens)
    return bbit_minhash(params, torch.clamp(tokens, min=0), tokens >= 0,
                        L=L, b=b)
