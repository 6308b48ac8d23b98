"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function here is the specification of one kernel in ``csrc/`` and
the port of the matching oracle in ``repro/kernels/ref.py``.  The CPU
runs them in place of the kernels, and ``chip_smoke.py`` holds every
kernel against them on the card.

The flash-attention forward and its FA-2 backward are the float
kernels: their plain versions compute in float32 and are held to a
tolerance, not to the bit.

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
    return hamming_distances_batched_ref(db_vert[None], q_vert[None])[0]


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


def hamming_distances_batched_ref(db_vert: torch.Tensor,
                                  q_vert: torch.Tensor) -> torch.Tensor:
    """``hamming_distances_ref`` over a leading batch axis.

    db_vert: (B, b, W, n) int32 bit planes;
    q_vert:  (B, b, W, m) or (1, b, W, m) — one query set per batch entry,
             or one shared by all;
    returns: (B, m, n) int32 distances.
    """
    B, b, W, n = db_vert.shape
    m = q_vert.shape[-1]
    dist = torch.zeros((B, m, n), dtype=torch.int32, device=db_vert.device)
    for w in range(W):
        acc = db_vert[:, 0, w][:, None, :] ^ q_vert[:, 0, w][:, :, None]
        for p in range(1, b):
            acc |= db_vert[:, p, w][:, None, :] ^ q_vert[:, p, w][:, :, None]
        dist += popcount32(acc)
    return dist


def hamming_distances_gather_ref(full_vert: torch.Tensor,
                                 q_vert: torch.Tensor, ids: torch.Tensor,
                                 counts: torch.Tensor) -> torch.Tensor:
    """Per-query candidate distances through the candidate ids.

    full_vert: (b, W, n) int32 bit planes; q_vert: (b, W, m);
    ids:       (m, C) int32 candidate ids, each row's first ``counts[j]``
               valid (the compacted prefix);
    counts:    (m,) int32;
    returns:   (m, C) int32 — the Hamming distance of query j to
               ``ids[j, s]`` where s < counts[j], BIG past it.
    """
    b, W, _ = full_vert.shape
    m, C = ids.shape
    valid = torch.arange(C, device=ids.device)[None, :] < counts[:, None]
    safe = torch.where(valid, ids, 0)
    cand = full_vert.index_select(2, safe.reshape(-1)).reshape(
        b, W, m, C).permute(2, 0, 1, 3)                       # (m, b, W, C)
    d = hamming_distances_batched_ref(
        cand, q_vert.permute(2, 0, 1)[..., None])[:, 0, :]    # (m, C)
    return torch.where(valid, d, BIG)


def sparse_verify_batch_batched_ref(paths_vert: torch.Tensor,
                                    q_vert: torch.Tensor,
                                    base_dist: torch.Tensor, tau: int):
    """``sparse_verify_batch_ref`` over a leading batch axis of databases
    and base planes, the queries shared.

    paths_vert: (B, b, W, n); q_vert: (b, W, m); base_dist: (B, m, n);
    returns ((B, m, n) bool, (B, m, n) int32).
    """
    total = base_dist.to(torch.int32) + hamming_distances_batched_ref(
        paths_vert, q_vert[None])
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


def hamming_threshold_count_ref(db_vert: torch.Tensor, q_vert: torch.Tensor,
                                tau) -> torch.Tensor:
    """(m,) int32 — number of database sketches within ``tau`` of each
    query."""
    d = hamming_distances_ref(db_vert, q_vert)
    return (d <= tau).sum(dim=1).to(torch.int32)


def _gathered_total(d: torch.Tensor, base_plane: torch.Tensor,
                    base_idx: torch.Tensor, live: torch.Tensor, tau: int):
    """Arena epilogue shared by both arena verifies: the base distance is
    gathered through the segment-offset lane, dead lanes get BIG, and the
    total is thresholded and clamped."""
    base = base_plane.to(torch.int32).index_select(1, base_idx.long())
    base = torch.where(live.bool()[None, :], base, BIG)
    total = base + d
    return total <= tau, torch.clamp(total, max=BIG)


def sparse_verify_arena_ref(paths_vert: torch.Tensor, q_vert: torch.Tensor,
                            base_plane: torch.Tensor, base_idx: torch.Tensor,
                            live: torch.Tensor, tau: int):
    """Arena verification: the per-column base distance is an indirect
    lookup through the segment-offset lane instead of a dense (m, n)
    plane.

    paths_vert: (b, W, n) int32 — concatenated verify columns;
    q_vert:     (b, W, m) int32 query planes;
    base_plane: (m, T) int32 — per-(segment, root) base distances (BIG =
                pruned subtrie);
    base_idx:   (n,) int32 — per-column index into the T axis;
    live:       (n,) bool/int — per-column liveness (0 = tombstoned);
    returns ((m, n) bool, (m, n) int32) — survival masks and totals,
    clamped to BIG on pruned or dead lanes.
    """
    d = hamming_distances_ref(paths_vert, q_vert)
    return _gathered_total(d, base_plane, base_idx, live, tau)


def field_mask(S: int) -> int:
    """The S-bit field mask of a packed suffix word: 0 at S = 0,
    0xFFFFFFFF at S = 32."""
    return (1 << S) - 1


def packed_distances_ref(db_words: torch.Tensor, q_words: torch.Tensor,
                         b: int, S: int) -> torch.Tensor:
    """(n,) x (m,) int32 bit-views of packed suffix words -> (m, n) int32
    Hamming distances over the S suffix symbols.  Plane i sits at bit
    offset i·S of the word; the shift is logical, so the XOR is widened
    to int64 and masked to 32 bits before it."""
    x = (db_words.to(torch.int64)[None, :]
         ^ q_words.to(torch.int64)[:, None]) & _M32
    field = field_mask(S)
    acc = x & field
    for i in range(1, b):
        acc |= (x >> (i * S)) & field
    return popcount32(acc)


def sparse_verify_arena_packed_ref(db_words: torch.Tensor,
                                   q_words: torch.Tensor,
                                   base_plane: torch.Tensor,
                                   base_idx: torch.Tensor, live: torch.Tensor,
                                   b: int, S: int, tau: int):
    """Packed-suffix arena verification (requires b·S <= 32): columns
    carry ONE word holding all b bit planes of the S-symbol suffix below
    a segment's ℓ_s (``hamming.pack_suffix_words``).  XOR, OR-fold the b
    S-bit fields, popcount; the base gather, liveness and threshold are
    ``sparse_verify_arena_ref``'s.

    db_words: (n,) int32;  q_words: (m,) int32;  base_plane: (m, T);
    base_idx: (n,) int32;  live: (n,);  returns ((m, n) bool, (m, n)
    int32 totals clamped to BIG).
    """
    d = packed_distances_ref(db_words, q_words, b, S)
    return _gathered_total(d, base_plane, base_idx, live, tau)


RERANK_METRICS = ("jaccard", "cosine", "containment")


def exact_rerank_ref(pay_vert: torch.Tensor, q_vert: torch.Tensor,
                     surv: torch.Tensor, metric: str) -> torch.Tensor:
    """Exact set-similarity re-rank over survivor lanes.

    pay_vert: (Wp, n) int32 bit-views of the payload bitmaps; q_vert:
    (Wp, m) query bitmaps; surv: (m, n) survivor mask (nonzero = score
    this lane).  Returns (m, n) float32 scores — Jaccard ``|A∩B| /
    |A∪B|`` (denominator ``(|A| + |B|) − |A∩B|``), cosine ``|A∩B| /
    sqrt(|A|·|B|)``, or containment ``|A∩B| / |A|`` with A the query —
    0.0 for a survivor with a zero denominator and the sentinel -1.0 off
    the survivors.  The counts are exact in float32; the division and
    the square root are IEEE-rounded, so the scores are bit patterns.
    """
    if metric not in RERANK_METRICS:
        raise ValueError(f"unknown rerank metric {metric!r}")
    Wp, n = pay_vert.shape
    m = q_vert.shape[-1]
    inter = torch.zeros((m, n), dtype=torch.int32, device=pay_vert.device)
    for w in range(Wp):
        inter += popcount32(q_vert[w][:, None] & pay_vert[w][None, :])
    inter = inter.to(torch.float32)
    sa = popcount32(q_vert).sum(dim=0).to(torch.float32)[:, None]    # (m, 1)
    sb = popcount32(pay_vert).sum(dim=0).to(torch.float32)[None, :]  # (1, n)
    # torch's vectorised float32 sqrt on the CPU is not always correctly
    # rounded; float64 square root and division of float32 operands,
    # rounded once to float32, are (53 >= 2·24 + 2 bits: the double
    # rounding is innocuous), so the bits do not depend on the backend.
    if metric == "jaccard":
        den = (sa + sb) - inter
    elif metric == "cosine":
        den = torch.sqrt((sa * sb).to(torch.float64)).to(torch.float32)
    else:                                                  # containment
        den = sa.expand(inter.shape)
    score = (inter.to(torch.float64) / den.to(torch.float64)).to(torch.float32)
    score = torch.where(den > 0, score, 0.0)
    return torch.where(surv != 0, score, -1.0)


def _flash_mask(Sq: int, Skv: int, causal: bool, window: int,
                q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) visibility: query i at ``q_offset + i``, key j at j."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= (q_pos - k_pos) < window
    return mask


def _tile(x: torch.Tensor, tile_bf16: bool) -> torch.Tensor:
    """A float32 tile as the JAX package's ``TILE_DTYPE`` rounds it."""
    return x.to(torch.bfloat16).to(torch.float32) if tile_bf16 else x


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0, cap: float = 0.0,
                        scale: float | None = None, q_offset: int = 0,
                        return_lse: bool = False, tile_bf16: bool = False):
    """Attention forward, the specification of the flash kernel.

    q: (B, H, Sq, D); k, v: (B, H, Skv, D) (the caller repeats kv heads
    for GQA).  ``s = (q·scale)·kᵀ`` in float32 (``scale=None``: 1/√D),
    ``tanh(s/cap)·cap`` when ``cap`` > 0, then the causal and
    sliding-window masks from absolute positions (query i at
    ``q_offset + i``, key j at j), softmax over the keys and the sum
    over v.  A row with no visible key gives 0, as the kernel's
    ``acc / max(l, 1e-30)`` does.  Returns (B, H, Sq, D) in q's dtype —
    the port of the oracle of the JAX package's flash-kernel tests —
    and with ``return_lse`` also the (B, H, Sq) float32 log-sum-exp of
    the scores, ``m + log(max(l, 1e-30))``, -inf on a row with no
    visible key (the residual of the FA-2 backward).  ``tile_bf16``
    rounds P and V to bfloat16 before P·V (the JAX package's
    ``set_tile_dtype(bfloat16)``; l sums P unrounded, as there).
    """
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    if cap:
        s = torch.tanh(s / cap) * cap
    mask = _flash_mask(q.shape[2], k.shape[2], causal, window, q_offset,
                       q.device)
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    seen = torch.isfinite(m)
    m = torch.where(seen, m, 0.0)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", _tile(p, tile_bf16),
                       _tile(v.to(torch.float32), tile_bf16))
    out = (out / torch.clamp(l, min=1e-30)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(seen, m + torch.log(torch.clamp(l, min=1e-30)),
                      -torch.inf)
    return out, lse[..., 0]


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool, window: int = 0, cap: float = 0.0,
                            scale: float | None = None, q_offset: int = 0,
                            tile_bf16: bool = False):
    """The FA-2 backward, the specification of the backward kernel: the
    JAX package's blockwise backward (``repro/models/flash.py``
    ``_flash_bwd``) with one block over each axis — blocks change only
    the order of the float32 sums.

    q, out, dout: (B, H, Sq, D); k, v: (B, H, Skv, D); lse: (B, H, Sq)
    float32 from the forward.  P is recomputed as ``exp(s_c − lse)``
    (0 where masked or where lse is -inf), ``delta = rowsum(dout·out)``,
    ``ds = P·(dout·vᵀ − delta)`` times ``1 − tanh²`` under a cap; then
    ``dq = scale·ds·k``, ``dk = scale·dsᵀ·q``, ``dv = Pᵀ·dout``, each
    product's operands rounded to bfloat16 first when ``tile_bf16``.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    f32 = torch.float32
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / float(D) ** 0.5
    qs = q.to(f32) * scale
    kf, vf, dof = k.to(f32), v.to(f32), dout.to(f32)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    dt = None
    if cap:
        t = torch.tanh(s / cap)
        s = t * cap
        dt = 1.0 - t * t
    mask = _flash_mask(q.shape[2], k.shape[2], causal, window, q_offset,
                       q.device)
    fin = torch.isfinite(lse)[..., None]
    lse_safe = torch.where(fin, lse[..., None], 0.0)
    p = torch.where(mask & fin, torch.exp(s - lse_safe), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * out.to(f32)).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    if dt is not None:
        ds = ds * dt
    ds_t = _tile(ds, tile_bf16)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_t, _tile(kf, tile_bf16)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_t, _tile(qs, tile_bf16))
    dv = torch.einsum("bhqk,bhqd->bhkd", _tile(p, tile_bf16),
                      _tile(dof, tile_bf16))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
