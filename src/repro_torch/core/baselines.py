"""Comparison methods from the paper's experiments (§VI-C): SIH, MIH,
HmSearch-style, and the exhaustive linear scan.

These are the baselines the paper beats (SIH blowing up exponentially in
τ and b, MIH winning at large τ, HmSearch trading memory for filter
time).  Their inverted indexes are host numpy structures, as in the JAX
package: a lexicographically sorted key array (the raw sketch bytes
viewed as numpy ``void`` scalars, memcmp order) queried by binary
search, and signature enumeration on the host.  Verification goes
through the candidate verify kernel (``hamming_distances_gather``) on
the index's device; the linear scan through ``hamming_distances``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import cost_model
from .hamming import as_words, pack_vertical, resolve_device


def _as_void(rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    return rows.view(np.dtype((np.void, rows.shape[1]))).reshape(-1)


def _vertical(sketches: np.ndarray, b: int, device) -> torch.Tensor:
    """(n, L) sketches -> (b, W, n) int32 bit-view planes on ``device``."""
    return as_words(np.transpose(pack_vertical(sketches, b), (1, 2, 0)),
                    device)


def _verify(full_vert: torch.Tensor, b: int, q: np.ndarray, ids: np.ndarray,
            tau: int, n: int) -> np.ndarray:
    """(n,) bool mask of the candidate ``ids`` within ``tau`` of ``q``:
    one ``hamming_distances_gather`` launch reads their columns through
    the ids (m = 1, every slot valid)."""
    dev = full_vert.device
    cand = torch.from_numpy(ids.astype(np.int32)).to(dev)[None]   # (1, k)
    counts = torch.full((1,), len(ids), dtype=torch.int32, device=dev)
    dist = ops.hamming_distances_gather(full_vert, _vertical(q[None], b, dev),
                                        cand, counts)[0]
    mask = np.zeros(n, dtype=bool)
    mask[ids[dist.cpu().numpy() <= tau]] = True
    return mask


@dataclasses.dataclass
class LinearScan:
    """Exhaustive vertical-format scan through the ``hamming_distances``
    kernel."""

    full_vert: torch.Tensor   # (b, W, n) int32 bit-views
    b: int
    L: int
    n: int

    @staticmethod
    def build(sketches: np.ndarray, b: int, device="cuda") -> "LinearScan":
        device = resolve_device(device)
        n, L = sketches.shape
        return LinearScan(full_vert=_vertical(sketches, b, device), b=b, L=L,
                          n=n)

    def distances(self, qs: np.ndarray) -> torch.Tensor:
        """(m, L) queries -> (m, n) int32 Hamming distances."""
        return ops.hamming_distances(
            self.full_vert, _vertical(np.asarray(qs), self.b,
                                      self.full_vert.device))

    def search(self, q: np.ndarray, tau: int) -> np.ndarray:
        """(L,) query -> (n,) bool mask of the ids within ``tau``."""
        return (self.distances(np.asarray(q)[None])[0] <= tau).cpu().numpy()

    def array_bytes(self) -> int:
        return self.full_vert.numel() * self.full_vert.element_size()


# ---------------------------------------------------------------------------
# signature enumeration (shared by SIH / MIH)
# ---------------------------------------------------------------------------

def enumerate_signatures(q: np.ndarray, b: int, tau: int,
                         limit: Optional[int] = None) -> Tuple[np.ndarray, bool]:
    """All strings within Hamming distance τ of q (Eq. 3 enumeration).

    Returns (signatures, truncated).  ``limit`` emulates the paper's 10 s
    SIH timeout: enumeration stops once ``limit`` signatures exist.
    """
    L = len(q)
    A = 1 << b
    out = [q[None, :].copy()]
    count = 1
    deltas = np.arange(1, A, dtype=np.uint8)
    for k in range(1, min(tau, L) + 1):
        for pos in itertools.combinations(range(L), k):
            # all (A-1)^k character-replacement combos, vectorized
            grids = np.meshgrid(*([deltas] * k), indexing="ij")
            combo = np.stack([g.reshape(-1) for g in grids], axis=1)
            sig = np.repeat(q[None, :], combo.shape[0], axis=0)
            for j, p in enumerate(pos):
                # in int64: at b = 8, A = 256 does not fit q's uint8
                sig[:, p] = (q[p].astype(np.int64) + combo[:, j]) % A
            out.append(sig)
            count += combo.shape[0]
            if limit is not None and count > limit:
                return np.concatenate(out, axis=0)[:limit], True
    return np.concatenate(out, axis=0), False


class _SortedInvertedIndex:
    """Sorted-key inverted index: key -> contiguous id range (CSR)."""

    def __init__(self, keys: np.ndarray, ids: Optional[np.ndarray] = None):
        n = keys.shape[0]
        ids = ids if ids is not None else np.arange(n, dtype=np.int64)
        void = _as_void(keys)
        order = np.argsort(void, kind="stable")
        self.sorted_void = void[order]
        self.ids_sorted = ids[order]
        uniq_mask = (np.concatenate([[True], self.sorted_void[1:]
                                     != self.sorted_void[:-1]])
                     if n > 1 else np.ones(n, bool))
        self.uniq = self.sorted_void[uniq_mask]
        starts = np.flatnonzero(uniq_mask)
        self.offsets = np.concatenate([starts, [n]]).astype(np.int64)
        self.key_bytes = keys.shape[1]

    def lookup_many(self, queries: np.ndarray) -> np.ndarray:
        """(m, key_len) query rows -> concatenated candidate ids."""
        qv = _as_void(queries)
        pos = np.searchsorted(self.uniq, qv)
        pos_c = np.minimum(pos, len(self.uniq) - 1) if len(self.uniq) else pos
        hit = np.zeros(len(qv), dtype=bool)
        if len(self.uniq):
            hit = self.uniq[pos_c] == qv
        out = [self.ids_sorted[self.offsets[p]:self.offsets[p + 1]]
               for p in pos_c[hit]]
        return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)

    def nbytes(self) -> int:
        return (self.uniq.size * self.key_bytes + self.ids_sorted.nbytes
                + self.offsets.nbytes)


# ---------------------------------------------------------------------------
# SIH — single-index hashing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SIH:
    index: _SortedInvertedIndex
    b: int
    L: int
    n: int

    @staticmethod
    def build(sketches: np.ndarray, b: int) -> "SIH":
        n, L = np.asarray(sketches).shape
        return SIH(index=_SortedInvertedIndex(np.asarray(sketches, np.uint8)),
                   b=b, L=L, n=n)

    def search(self, q: np.ndarray, tau: int,
               limit: Optional[int] = 2_000_000) -> Tuple[np.ndarray, bool]:
        """Returns (mask, truncated); truncated=True is the paper's
        timeout."""
        sigs, truncated = enumerate_signatures(np.asarray(q, np.uint8),
                                               self.b, tau, limit)
        mask = np.zeros(self.n, dtype=bool)
        mask[self.index.lookup_many(sigs)] = True
        return mask, truncated

    def array_bytes(self) -> int:
        return self.index.nbytes()


# ---------------------------------------------------------------------------
# MIH — multi-index hashing (Norouzi et al., adapted to b-bit sketches)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MIH:
    indexes: List[_SortedInvertedIndex]
    bounds: List[Tuple[int, int]]
    full_vert: torch.Tensor
    b: int
    L: int
    n: int
    m: int

    @staticmethod
    def build(sketches: np.ndarray, b: int, m: int, device="cuda") -> "MIH":
        device = resolve_device(device)
        sketches = np.asarray(sketches, np.uint8)
        n, L = sketches.shape
        bounds, indexes, lo = [], [], 0
        for Lj in cost_model._block_lengths(L, m):
            hi = lo + Lj
            indexes.append(_SortedInvertedIndex(sketches[:, lo:hi]))
            bounds.append((lo, hi))
            lo = hi
        return MIH(indexes=indexes, bounds=bounds,
                   full_vert=_vertical(sketches, b, device), b=b, L=L, n=n,
                   m=m)

    def search(self, q: np.ndarray, tau: int,
               limit: Optional[int] = 2_000_000
               ) -> Tuple[np.ndarray, bool, int]:
        """Filter blocks at the MIH thresholds, verify with the kernel.
        Returns (mask, truncated, n_candidates)."""
        q = np.asarray(q, np.uint8)
        taus = cost_model.block_thresholds(tau, self.m, mih_style=True)
        cand: List[np.ndarray] = []
        truncated = False
        for idx, (lo, hi), tj in zip(self.indexes, self.bounds, taus):
            sigs, tr = enumerate_signatures(q[lo:hi], self.b, tj, limit)
            truncated |= tr
            cand.append(idx.lookup_many(sigs))
        ids = np.unique(np.concatenate(cand)) if cand else np.zeros(0, np.int64)
        if ids.size == 0:
            return np.zeros(self.n, bool), truncated, 0
        return (_verify(self.full_vert, self.b, q, ids, tau, self.n),
                truncated, int(ids.size))

    def array_bytes(self) -> int:
        return sum(ix.nbytes() for ix in self.indexes) \
            + self.full_vert.numel() * self.full_vert.element_size()


# ---------------------------------------------------------------------------
# HmSearch-style (Zhang et al.): τ^j ∈ {0, 1} blocks, 1-wildcard variants
# registered at index time — a fast filter at a heavy memory cost
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HmSearch:
    indexes: List[_SortedInvertedIndex]
    bounds: List[Tuple[int, int]]
    full_vert: torch.Tensor
    b: int
    L: int
    n: int
    m: int

    @staticmethod
    def _variant_keys(block: np.ndarray) -> np.ndarray:
        """Keys [block with position p zeroed | p+1] for each wildcard
        position p, plus [block | 0] for the exact entry.  The trailing
        position byte keeps variants from colliding with real characters
        (a plain 255 wildcard byte would collide at b=8)."""
        n, Lj = block.shape
        keys = [np.concatenate([block, np.zeros((n, 1), np.uint8)], axis=1)]
        for p in range(Lj):
            v = block.copy()
            v[:, p] = 0
            keys.append(np.concatenate([v, np.full((n, 1), p + 1, np.uint8)],
                                       axis=1))
        return np.concatenate(keys, axis=0)

    @staticmethod
    def build(sketches: np.ndarray, b: int, tau: int,
              device="cuda") -> "HmSearch":
        """m = ⌊τ/2⌋ + 1 blocks, so by pigeonhole some block has at most
        one mismatch; every 1-wildcard variant of every block string is
        registered."""
        device = resolve_device(device)
        sketches = np.asarray(sketches, np.uint8)
        n, L = sketches.shape
        m = tau // 2 + 1
        bounds, indexes, lo = [], [], 0
        for Lj in cost_model._block_lengths(L, m):
            hi = lo + Lj
            keys = HmSearch._variant_keys(sketches[:, lo:hi])
            ids = np.tile(np.arange(n, dtype=np.int64), Lj + 1)
            indexes.append(_SortedInvertedIndex(keys, ids))
            bounds.append((lo, hi))
            lo = hi
        return HmSearch(indexes=indexes, bounds=bounds,
                        full_vert=_vertical(sketches, b, device), b=b, L=L,
                        n=n, m=m)

    def search(self, q: np.ndarray, tau: int) -> Tuple[np.ndarray, int]:
        """Returns (mask, n_candidates)."""
        q = np.asarray(q, np.uint8)
        cand = [idx.lookup_many(HmSearch._variant_keys(q[lo:hi][None, :]))
                for idx, (lo, hi) in zip(self.indexes, self.bounds)]
        ids = np.unique(np.concatenate(cand)) if cand else np.zeros(0, np.int64)
        if ids.size == 0:
            return np.zeros(self.n, bool), 0
        return _verify(self.full_vert, self.b, q, ids, tau, self.n), \
            int(ids.size)

    def array_bytes(self) -> int:
        return sum(ix.nbytes() for ix in self.indexes) \
            + self.full_vert.numel() * self.full_vert.element_size()
