"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function here is the specification of one kernel in
``csrc/hamming.cu`` and the port of the matching oracle in
``repro/kernels/ref.py``.  The CPU runs them in place of the kernels, and
``chip_smoke.py`` holds every kernel against them on the card.

Words are carried as int32 bit-views of the uint32 bit-plane words:
torch has no popcount, its uint32 tensors have no ``>>`` and int32
``>>`` is arithmetic, so ``popcount32`` widens to int64, masks to the
low 32 bits and counts with the SWAR ladder.
"""

from __future__ import annotations

import torch

BIG = 1 << 20
_M32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit-views of uint32 words -> int32."""
    v = x.to(torch.int64) & _M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & _M32) >> 24).to(torch.int32)


def hamming_distances_ref(db_vert: torch.Tensor,
                          q_vert: torch.Tensor) -> torch.Tensor:
    """Batched vertical-format Hamming distances.

    db_vert: (b, W, n) int32 bit planes, database axis last;
    q_vert:  (b, W, m) int32 — m queries in the same layout;
    returns: (m, n) int32 distances.
    """
    b, W, n = db_vert.shape
    m = q_vert.shape[-1]
    dist = torch.zeros((m, n), dtype=torch.int32, device=db_vert.device)
    for w in range(W):
        acc = db_vert[0, w][None, :] ^ q_vert[0, w][:, None]
        for p in range(1, b):
            acc |= db_vert[p, w][None, :] ^ q_vert[p, w][:, None]
        dist += popcount32(acc)
    return dist


def sparse_verify_batch_ref(paths_vert: torch.Tensor, q_vert: torch.Tensor,
                            base_dist: torch.Tensor, tau: int):
    """Query-batched sparse-layer verification.

    paths_vert: (b, W, n) collapsed root-to-leaf suffix paths;
    q_vert:     (b, W, m) m query suffixes;
    base_dist:  (m, n) int32 per-query distance accumulated down to the
                sparse-layer roots (BIG = pruned subtrie);
    returns ((m, n) bool, (m, n) int32) — survival masks
    (base + suffix <= tau) and total distances, clamped to BIG.
    """
    total = base_dist.to(torch.int32) + hamming_distances_ref(paths_vert,
                                                              q_vert)
    return total <= tau, torch.clamp(total, max=BIG)


def sparse_verify_ref(paths_vert: torch.Tensor, q_vert: torch.Tensor,
                      base_dist: torch.Tensor, tau: int):
    """Single-query verification: the m=1 row of the batch version.

    paths_vert: (b, W, n);  q_vert: (b, W);  base_dist: (n,) int32;
    returns ((n,) bool, (n,) int32).
    """
    mask, dist = sparse_verify_batch_ref(paths_vert, q_vert[..., None],
                                         base_dist.to(torch.int32)[None, :],
                                         tau)
    return mask[0], dist[0]
