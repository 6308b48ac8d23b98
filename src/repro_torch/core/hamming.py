"""Vertical-format bit-parallel Hamming distance (paper §V-C).

A b-bit sketch of length L over Σ=[0, 2^b) is transposed into *b bit
planes*: plane ``i`` holds the i-th significant bit of every character,
packed LSB-first into ``ceil(L/32)`` 32-bit words.  Two sketches differ
at a position iff *any* plane differs there, so

    ham = popcount( OR_{i<b} ( s'[i] XOR q'[i] ) )

— the layout the CUDA kernels in ``repro_torch.kernels`` stream.

The host packers (``pack_vertical``/``unpack_vertical``) are copies of
``repro.core.hamming``'s numpy functions and return uint32; on the device
the words are int32 bit-views of the same uint32 values (``as_words``).
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def as_words(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words -> int32 bit-view tensor on ``device``."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:      # torch tensors may be written to
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


def n_words(L: int) -> int:
    return (L + WORD_BITS - 1) // WORD_BITS


def pack_vertical(sketches: np.ndarray, b: int) -> np.ndarray:
    """(n, L) uint8/int sketches -> (n, b, W) uint32 bit planes (host-side).

    Index order (n, b, W) keeps a single sketch's planes contiguous.
    """
    sketches = np.asarray(sketches)
    if sketches.ndim == 1:
        sketches = sketches[None, :]
    n, L = sketches.shape
    W = n_words(L)
    assert sketches.max(initial=0) < (1 << b), "character out of alphabet range"
    planes = np.zeros((n, b, W), dtype=np.uint32)
    pos = np.arange(L)
    word_idx = pos // WORD_BITS
    bit_idx = (pos % WORD_BITS).astype(np.uint32)
    for i in range(b):
        plane_bits = ((sketches >> i) & 1).astype(np.uint32)  # (n, L)
        # scatter-add each bit into its word
        contrib = plane_bits << bit_idx  # (n, L)
        for w in range(W):
            sel = word_idx == w
            if sel.any():
                planes[:, i, w] = contrib[:, sel].sum(axis=1, dtype=np.uint64).astype(np.uint32)
    return planes


def unpack_vertical(planes: np.ndarray, b: int, L: int) -> np.ndarray:
    """Inverse of :func:`pack_vertical`: (n, b, W) uint32 bit planes ->
    (n, L) uint8 sketches (host-side).

    >>> sk = np.array([[3, 0, 1, 2]], np.uint8)
    >>> bool((unpack_vertical(pack_vertical(sk, 2), 2, 4) == sk).all())
    True
    """
    planes = np.asarray(planes, dtype=np.uint32)
    n = planes.shape[0]
    pos = np.arange(L)
    word_idx = pos // WORD_BITS
    bit_idx = (pos % WORD_BITS).astype(np.uint32)
    out = np.zeros((n, L), np.uint8)
    for i in range(b):
        bits = (planes[:, i, word_idx] >> bit_idx) & np.uint32(1)  # (n, L)
        out |= (bits.astype(np.uint8) << i)
    return out


def pack_vertical_torch(sketches: torch.Tensor, b: int) -> torch.Tensor:
    """Device version of :func:`pack_vertical`: (n, L) integer sketches
    -> (n, b, W) int32 bit-views of the same words.  The word sums run in
    int64 (no uint32 shifts in torch) and wrap to int32 at the end."""
    if sketches.dim() == 1:
        sketches = sketches[None, :]
    n, L = sketches.shape
    W = n_words(L)
    s = torch.zeros((n, W * WORD_BITS), dtype=torch.int64,
                    device=sketches.device)
    s[:, :L] = sketches
    s = s.reshape(n, W, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=s.device)
    planes = torch.stack([(((s >> i) & 1) << shifts).sum(dim=-1)
                          for i in range(b)], dim=1)       # (n, b, W)
    return torch.where(planes >= 1 << 31, planes - (1 << 32),
                       planes).to(torch.int32)
