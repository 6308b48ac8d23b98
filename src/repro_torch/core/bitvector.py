"""Succinct bit vector with rank/select — the substrate of every bST layer.

``rank`` is a gather from a per-word cumulative popcount table plus a
popcount of the residual word; ``select`` a ``torch.searchsorted`` over
the same table plus an in-word select over the word's 32 lanes (the
argmax of the first hit).  Both are batched: the trie traversal issues
them for a whole frontier at once.

Words are int32 bit-views of the uint32 payload words; every shift runs
on the int64 widening masked to 32 bits (torch's uint32 has no shifts
and its int32 shift is arithmetic).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.ref import popcount32
from .hamming import as_words

WORD_BITS = 32
_WORD_SHIFT = 5
_WORD_MASK = 31
_M32 = 0xFFFFFFFF


def _lanes(word: torch.Tensor) -> torch.Tensor:
    """(...,) int32 words -> (..., 32) int64 bits, LSB first."""
    lane = torch.arange(WORD_BITS, dtype=torch.int64, device=word.device)
    return ((word.to(torch.int64) & _M32)[..., None] >> lane) & 1


def _select_in_word(word: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Lane of the ``residual``-th (1-indexed) set bit of each word; 0 if
    the word has fewer set bits."""
    bits = _lanes(word)
    cs = torch.cumsum(bits, dim=-1)
    hit = (cs >= residual[..., None]) & (bits == 1)
    return torch.argmax(hit.to(torch.uint8), dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BitVector:
    """Packed bit array with rank/select support.

    Attributes:
      words: int32[W]   — packed payload (uint32 bit-views), LSB-first.
      cum:   int32[W+1] — exclusive cumulative popcount; ``cum[w]`` is the
             number of set bits strictly before word ``w``.
      length: python int — logical number of bits.
    """

    words: torch.Tensor
    cum: torch.Tensor
    length: int

    @staticmethod
    def from_bits(bits: np.ndarray) -> "BitVector":
        """Build on the CPU from a host-side 0/1 array (index build runs in
        numpy; ``.to(device)`` moves it)."""
        bits = np.asarray(bits, dtype=np.uint8)
        n = int(bits.shape[0])
        n_words = max(1, (n + WORD_BITS - 1) // WORD_BITS)
        padded = np.zeros(n_words * WORD_BITS, dtype=np.uint8)
        padded[:n] = bits
        lanes = padded.reshape(n_words, WORD_BITS)
        weights = (1 << np.arange(WORD_BITS, dtype=np.uint64)).astype(np.uint64)
        words = (lanes.astype(np.uint64) * weights).sum(axis=1).astype(np.uint32)
        pops = lanes.sum(axis=1).astype(np.int64)
        cum = np.zeros(n_words + 1, dtype=np.int32)
        np.cumsum(pops, out=cum[1:])
        return BitVector(words=as_words(words, "cpu"),
                         cum=torch.from_numpy(cum), length=n)

    def to(self, device) -> "BitVector":
        return BitVector(self.words.to(device), self.cum.to(device),
                         self.length)

    def nbits(self) -> int:
        """Storage cost in bits (payload + rank directory)."""
        return int(self.words.shape[0]) * 32 + int(self.cum.shape[0]) * 32

    def rank(self, i: torch.Tensor) -> torch.Tensor:
        """Number of set bits in positions [0, i) — exclusive rank; ``i``
        is clipped to [0, length]."""
        i = torch.clamp(i.to(torch.int32), 0, self.length)
        w = i >> _WORD_SHIFT
        r = i & _WORD_MASK
        base = self.cum[w]
        word = self.words[torch.clamp(w, max=self.words.shape[0] - 1)]
        mask = (1 << r.to(torch.int64)) - 1          # r == 0 -> empty mask
        partial = popcount32(word.to(torch.int64) & mask)
        return base + torch.where(r > 0, partial, 0)

    def select(self, k: torch.Tensor) -> torch.Tensor:
        """Position (0-indexed) of the k-th set bit, k 1-indexed as in the
        paper; out-of-range k returns ``length``."""
        k = k.to(torch.int32)
        total = self.cum[-1]
        valid = (k >= 1) & (k <= total)
        k_safe = torch.minimum(torch.clamp(k, min=1), torch.clamp(total, min=1))
        # word containing the k-th one: last w with cum[w] < k
        w = torch.searchsorted(self.cum, k_safe, right=False).to(torch.int32) - 1
        w = torch.clamp(w, 0, self.words.shape[0] - 1)
        inword = _select_in_word(self.words[w], k_safe - self.cum[w])
        pos = (w << _WORD_SHIFT) + inword
        return torch.where(valid, pos, self.length)

    def select0(self, k: torch.Tensor) -> torch.Tensor:
        """Position of the k-th *zero* bit (k 1-indexed); ``length`` if out
        of range.  Runs over the complement cumsum ``32·w − cum[w]``."""
        k = k.to(torch.int32)
        n_words_ = self.words.shape[0]
        word_idx = torch.arange(n_words_ + 1, dtype=torch.int32,
                                device=self.cum.device)
        cum0 = (word_idx << _WORD_SHIFT) - self.cum  # zeros before word w
        total0 = self.length - self.cum[-1]          # zeros within length
        valid = (k >= 1) & (k <= total0)
        k_safe = torch.minimum(torch.clamp(k, min=1), torch.clamp(total0, min=1))
        w = torch.searchsorted(cum0, k_safe, right=False).to(torch.int32) - 1
        w = torch.clamp(w, 0, n_words_ - 1)
        inword = _select_in_word(~self.words[w], k_safe - cum0[w])
        pos = (w << _WORD_SHIFT) + inword
        return torch.where(valid, pos, self.length)

    def get(self, i: torch.Tensor) -> torch.Tensor:
        """Bit at position i (0 for out-of-range)."""
        i = i.to(torch.int32)
        ok = (i >= 0) & (i < self.length)
        i_safe = torch.clamp(i, 0, max(self.length - 1, 0))
        w = i_safe >> _WORD_SHIFT
        r = (i_safe & _WORD_MASK).to(torch.int64)
        bit = ((self.words[w].to(torch.int64) & _M32) >> r) & 1
        return torch.where(ok, bit.to(torch.int32), 0)
