"""Vertical-format bit-parallel Hamming distance (paper §V-C).

A b-bit sketch of length L over Σ=[0, 2^b) is transposed into *b bit
planes*: plane ``i`` holds the i-th significant bit of every character,
packed LSB-first into ``ceil(L/32)`` 32-bit words.  Two sketches differ
at a position iff *any* plane differs there, so

    ham = popcount( OR_{i<b} ( s'[i] XOR q'[i] ) )

— the layout the CUDA kernels in ``repro_torch.kernels`` stream.

The host packers (``pack_vertical``/``unpack_vertical``,
``pack_suffix_words``, ``pack_sets``) are copies of
``repro.core.hamming``'s numpy functions and return uint32; on the device
the words are int32 bit-views of the same uint32 values (``as_words``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.ref import popcount32

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
    return _to_int32_view(planes)


def _to_int32_view(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 bit-views of the same words."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def pack_suffix_words(sketches: np.ndarray, b: int) -> np.ndarray:
    """(n, S) uint8 suffixes with b·S <= 32 -> (n,) uint32, all b bit
    planes of one row packed into a single word (host-side).

    Plane ``i``'s S bits occupy bit offsets [i·S, (i+1)·S) LSB-first —
    the layout of the packed suffix column store: XOR-ing two words and
    OR-folding the b S-bit fields reproduces the vertical-format Hamming
    distance of the suffixes.
    """
    sketches = np.asarray(sketches)
    if sketches.ndim == 1:
        sketches = sketches[None, :]
    n, S = sketches.shape
    if b * S > WORD_BITS:
        raise ValueError(f"b*S = {b * S} exceeds one {WORD_BITS}-bit word")
    out = np.zeros((n,), np.uint64)
    for i in range(b):
        bits = ((sketches >> i) & 1).astype(np.uint64)        # (n, S)
        shifts = (np.arange(S) + i * S).astype(np.uint64)
        out |= (bits << shifts).sum(axis=1, dtype=np.uint64)
    return out.astype(np.uint32)


def pack_suffix_words_torch(sketches: torch.Tensor, b: int) -> torch.Tensor:
    """Device version of :func:`pack_suffix_words`: (m, S) integer
    suffixes -> (m,) int32 bit-views of the packed words.  The bits are
    summed in int64 (disjoint positions: the sum is an exact OR) and
    wrap to int32 at the end."""
    if sketches.dim() == 1:
        sketches = sketches[None, :]
    m, S = sketches.shape
    if b * S > WORD_BITS:
        raise ValueError(f"b*S = {b * S} exceeds one {WORD_BITS}-bit word")
    s = sketches.to(torch.int64)
    out = torch.zeros((m,), dtype=torch.int64, device=s.device)
    for i in range(b):
        shifts = torch.arange(S, dtype=torch.int64, device=s.device) + i * S
        out += (((s >> i) & 1) << shifts[None, :]).sum(dim=1)
    return _to_int32_view(out)


def hamming_vertical(db_planes: torch.Tensor,
                     q_planes: torch.Tensor) -> torch.Tensor:
    """Hamming distances between every database sketch and one query
    over vertical bit planes: db_planes (n, b, W), q_planes (b, W), the
    uint32 words as int32 bit-views (``as_words``) -> (n,) int32.  The
    OR over the b planes of the XOR marks the differing symbols; their
    popcount is the distance."""
    diff = db_planes ^ q_planes[None, :, :]                  # (n, b, W)
    acc = diff[:, 0, :]
    for i in range(1, diff.shape[1]):
        acc = acc | diff[:, i, :]
    return popcount32(acc).sum(dim=-1, dtype=torch.int32)


def hamming_vertical_many(db_planes: torch.Tensor,
                          q_planes: torch.Tensor) -> torch.Tensor:
    """(n, b, W) x (m, b, W) -> (m, n) int32 distances, query by query."""
    if q_planes.shape[0] == 0:
        return torch.zeros((0, db_planes.shape[0]), dtype=torch.int32,
                           device=db_planes.device)
    return torch.stack([hamming_vertical(db_planes, q) for q in q_planes])


def hamming_naive(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Symbol-by-symbol O(L) reference (the paper's naive approach):
    db (n, L), q (L,) -> (n,) int32."""
    db, q = torch.as_tensor(db), torch.as_tensor(q)
    return (db != q[None, :]).sum(dim=-1, dtype=torch.int32)


def hamming_pairwise_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, L) x (n, L) -> (m, n) int32 distances, the brute-force
    oracle."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return (a[:, None, :] != b[None, :, :]).sum(dim=-1, dtype=torch.int32)


def pack_sets(sets, vocab: int) -> np.ndarray:
    """Token-id sets -> (n, Wp) uint32 LSB-first membership bitmaps.

    ``sets`` is a sequence of integer token-id arrays (each over
    ``[0, vocab)``) or an already-multihot (n, vocab) 0/1 array.  Word
    ``w`` bit ``j`` holds membership of token ``32*w + j``, so one
    AND+popcount pass recovers exact set intersections — the re-rank
    payload format.
    """
    if vocab <= 0:
        raise ValueError("vocab must be positive")
    Wp = n_words(vocab)
    if isinstance(sets, np.ndarray) and sets.ndim == 2 \
            and sets.shape[1] == vocab:
        multihot = sets.astype(bool)
    else:
        multihot = np.zeros((len(sets), vocab), bool)
        for r, toks in enumerate(sets):
            toks = np.asarray(toks, np.int64).ravel()
            if toks.size and (toks.min() < 0 or toks.max() >= vocab):
                raise ValueError(f"token ids of row {r} outside [0, {vocab})")
            multihot[r, toks] = True
    n = multihot.shape[0]
    padded = np.zeros((n, Wp * WORD_BITS), bool)
    padded[:, :vocab] = multihot
    bits = padded.reshape(n, Wp, WORD_BITS).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (bits << shifts).sum(axis=2, dtype=np.uint32)
