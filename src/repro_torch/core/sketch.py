"""Similarity-preserving hashing: b-bit minhash and 0-bit CWS (paper §I,
§VI-A).

Both map vectorial data to length-L strings over Σ=[0, 2^b) — the
*b-bit sketches* the index consumes.

* ``bbit_minhash`` [Li & König, WWW'10]: for sets, L independent
  min-wise hashes ``h_j(x) = mix32(a_j·x + c_j)`` over uint32
  arithmetic, keeping the low b bits of each minimum.  Collision
  probability per position ≈ J + (1-J)/2^b for Jaccard J.
* ``zbit_cws`` [Li, KDD'15]: 0-bit consistent weighted sampling for
  non-negative weighted vectors (the paper's SIFT and GIST datasets);
  per hash the Ioffe-CWS argmin feature id i* is kept and its low b bits
  form the character.  Approximates the min-max kernel
  (``minmax_kernel``).

The JAX package draws its parameters from a ``jax.random`` key, whose
bits torch cannot reproduce; here they are explicit tensors, so one set
of parameters gives the same sketches in both packages.  ``hash_params``
draws minhash's (a, c) from a ``torch.Generator`` in the same ranges (a
odd in [1, 2^31), c in [0, 2^31)), ``cws_params`` the CWS draws (r, c,
β) in the same distributions (Gamma(2, 1) as the sum of two Exp(1), and
U(0, 1)).

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


def cws_params(L: int, dim: int, generator: torch.Generator | None = None,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Draw the Ioffe-CWS parameters ``(r, c, beta)``: (L, dim) float32
    tensors, r and c ~ Gamma(2, 1) (each the sum of two Exp(1) draws, as
    in the JAX package) and beta ~ U(0, 1)."""
    def gamma2():
        e = torch.empty((2, L, dim), dtype=torch.float32, device=device)
        return e.exponential_(generator=generator).sum(0)
    r = gamma2()
    c = gamma2()
    beta = torch.rand((L, dim), generator=generator, dtype=torch.float32,
                      device=device)
    return r, c, beta


# (rows, L, dim) float32 elements of one chunk of the CWS intermediate
# (256 MiB each; the chunk holds a few of them at once)
CWS_CHUNK_ELEMS = 1 << 26


def zbit_cws(params, weights: torch.Tensor, *, L: int, b: int) -> torch.Tensor:
    """0-bit consistent weighted sampling of non-negative vectors.

    params:  ``(r, c, beta)``, (L, dim) float32 tensors or arrays
             (``cws_params`` draws them);
    weights: (batch, dim) float, >= 0;
    returns (batch, L) uint8 sketches over [0, 2^b), on ``weights``'
    device.

    Ioffe-CWS per hash j and feature i, in float32 as the JAX package
    computes it: t = floor(ln w_i / r + beta); ln y = r (t - beta);
    ln a = ln c - ln y - r; the character is the low b bits of
    k* = argmin_i ln a (the first on ties), features with w = 0 excluded
    (+inf).  Rows are processed in chunks of at most ``CWS_CHUNK_ELEMS``
    (rows·L·dim) elements, so the (batch, L, dim) intermediate stays
    bounded; the chunking changes no result (rows are independent).
    """
    weights = torch.as_tensor(weights)
    dev = weights.device
    r, c, beta = (torch.as_tensor(p if isinstance(p, torch.Tensor)
                                  else np.array(p, dtype=np.float32)).to(
        device=dev, dtype=torch.float32) for p in params)
    batch, dim = weights.shape
    if r.shape != (L, dim) or c.shape != (L, dim) or beta.shape != (L, dim):
        raise ValueError(f"CWS parameters must be three ({L}, {dim}) "
                         f"tensors, got {tuple(r.shape)}, {tuple(c.shape)} "
                         f"and {tuple(beta.shape)}")
    log_c = torch.log(c)
    out = torch.empty((batch, L), dtype=torch.uint8, device=dev)
    rows = max(1, CWS_CHUNK_ELEMS // max(1, L * dim))
    for lo in range(0, batch, rows):
        w = weights[lo:lo + rows].to(torch.float32)
        logw = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-30)),
                           -torch.inf)                      # (rows, dim)
        t = torch.floor(logw[:, None, :] / r + beta)        # (rows, L, dim)
        lny = r * (t - beta)
        lna = log_c - lny - r
        lna = torch.where(torch.isfinite(logw)[:, None, :], lna, torch.inf)
        kstar = torch.argmin(lna, dim=-1)                   # (rows, L)
        out[lo:lo + rows] = (kstar & ((1 << b) - 1)).to(torch.uint8)
    return out


def minmax_kernel(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Exact min-max kernel — the oracle of ``zbit_cws``.
    wa, wb: (..., dim) float, >= 0 -> (...,) in [0, 1] (0.0 where both
    are all zero)."""
    wa, wb = torch.as_tensor(wa), torch.as_tensor(wb)
    num = torch.minimum(wa, wb).sum(dim=-1)
    den = torch.maximum(wa, wb).sum(dim=-1)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1), 0.0)
