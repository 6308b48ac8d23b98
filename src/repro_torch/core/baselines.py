"""Comparison methods from the paper's experiments (§VI-C).

This slice of the port carries the exhaustive linear scan, the no-index
floor and the exact brute-force reference of the trie search; the
signature-enumeration baselines (SIH, MIH, HmSearch) come later.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from .hamming import as_words, pack_vertical, resolve_device


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
        planes = pack_vertical(sketches, b)
        return LinearScan(full_vert=as_words(np.transpose(planes, (1, 2, 0)),
                                             device), b=b, L=L, n=n)

    def distances(self, qs: np.ndarray) -> torch.Tensor:
        """(m, L) queries -> (m, n) int32 Hamming distances."""
        qv = as_words(np.transpose(pack_vertical(np.asarray(qs), self.b),
                                   (1, 2, 0)), self.full_vert.device)
        return ops.hamming_distances(self.full_vert, qv)

    def search(self, q: np.ndarray, tau: int) -> np.ndarray:
        """(L,) query -> (n,) bool mask of the ids within ``tau``."""
        return (self.distances(np.asarray(q)[None])[0] <= tau).cpu().numpy()

    def array_bytes(self) -> int:
        return self.full_vert.numel() * self.full_vert.element_size()
