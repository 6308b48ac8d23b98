"""Level-synchronous similarity search over a SketchIndex (paper Alg. 1).

The paper's recursive DFS visits one node at a time and prunes a subtree
when the accumulated Hamming distance exceeds τ.  Here the *whole frontier
at level ℓ* is a fixed-capacity tensor of (node id, distance) pairs; one
step expands every node's ≤ 2^b children with one batched ``children``
call, masks out children with dist > τ (the paper's pruning), and
compacts survivors with a cumsum-scatter.  The sparse tail is *not*
traversed: pruned ℓ_s-subtries get a BIG base distance and the verify
kernel streams every collapsed suffix path in one masked scan.

The batched searcher runs a (m, cap) 2D frontier: one shared
``children()`` gather per level for the whole batch, per-query
compaction, a scatter-min onto (m, t_root) base-distance planes, and the
query-tiled ``sparse_verify_batch`` CUDA kernel.  The single-query
searcher is its m=1 row.

Exact distances are first-class: ``SearchResult.dist`` carries the exact
distance of every id inside the τ-ball (BIG elsewhere).  ``topk`` adds a
τ-escalation ladder seeded from the cost model and a k-smallest
selection ordered by (distance, id).

Every result is bit-identical to ``repro.core.search``: capacities come
from the same cost model, compaction scatters into a ``capacity + 1``
buffer whose last slot absorbs dropped entries, and the top-k selection
runs on the unique int64 key ``dist << 32 | id``.  Torch runs eagerly,
so a "searcher" is a closure over (index, τ, caps), kept in a
process-level cache with the JAX package's key and counters.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import BIG
from .bst import SketchIndex
from .cost_model import frontier_capacities, tau_for_k
from .hamming import pack_vertical_torch

CAP_MAX_DEFAULT = 1 << 17
LADDER_CAP_MAX = 1 << 22


def bucket_m(m: int) -> int:
    """Power-of-two query-batch bucket: the smallest 2^j >= m.  Batched
    searchers pad the query axis up to it (and slice the results back),
    as the JAX package does, so both see the same padded batch."""
    if m < 1:
        raise ValueError("batch must contain at least one query")
    return 1 << (m - 1).bit_length()


def _pad_rows(qs: torch.Tensor, bucket: int) -> torch.Tensor:
    """Pad the leading (query) axis up to ``bucket`` rows by repeating the
    last row — a real query, so pad rows can never overflow a frontier
    harder than the rows already present."""
    m = qs.shape[0]
    pad = qs[-1:].expand((bucket - m,) + tuple(qs.shape[1:]))
    return torch.cat([qs, pad], dim=0)


class SearchResult(NamedTuple):
    mask: torch.Tensor       # (n,) bool — ids within τ of the query
    dist: torch.Tensor       # (n,) int32 — exact distance where mask, BIG off
    overflow: torch.Tensor   # int32 — dropped frontier entries (0 = exact)
    traversed: torch.Tensor  # int32 — Σ frontier sizes (paper's t_tra)


class TopKResult(NamedTuple):
    ids: torch.Tensor        # (k,) int32 — ascending (distance, id); -1 pad
    dists: torch.Tensor      # (k,) int32 — exact distances; BIG on pad
    tau: int                 # final rung of the τ-escalation ladder
    overflow: int            # dropped frontier entries (0 = provably exact)
    scores: torch.Tensor | None = None  # (k,) f32 exact re-rank scores —
    #   descending (score, -id); -1.0 pad.  None on sketch-only requests;
    #   when set, ids/dists re-order to score order.


def _compact_batch(ids: torch.Tensor, dists: torch.Tensor,
                   valid: torch.Tensor, capacity: int):
    """Row-wise stable masked compaction: (m, K) candidates -> (m,
    capacity) frontier.  Entries past the capacity, and invalid ones, go
    to the scratch slot ``capacity``, which is sliced off; overflow is
    counted per query."""
    m = ids.shape[0]
    total = valid.sum(dim=1, dtype=torch.int32)           # (m,)
    pos = torch.cumsum(valid, dim=1, dtype=torch.int64) - 1
    slot = torch.where(valid & (pos < capacity), pos, capacity)
    out_ids = torch.zeros((m, capacity + 1), dtype=torch.int32,
                          device=ids.device).scatter_(1, slot, ids)
    out_dists = torch.full((m, capacity + 1), BIG, dtype=torch.int32,
                           device=ids.device).scatter_(1, slot, dists)
    kept = torch.clamp(total, max=capacity)
    out_valid = torch.arange(capacity, device=ids.device)[None, :] < kept[:, None]
    overflow = torch.clamp(total - capacity, min=0)
    return out_ids[:, :capacity], out_dists[:, :capacity], out_valid, overflow


def _compact(ids: torch.Tensor, dists: torch.Tensor, valid: torch.Tensor,
             capacity: int):
    """Stable masked compaction of one frontier: the m=1 row of
    ``_compact_batch``."""
    out = _compact_batch(ids[None], dists[None], valid[None], capacity)
    return tuple(x[0] for x in out)


def _leaf_live(index: SketchIndex, id_live: torch.Tensor) -> torch.Tensor:
    """(n,) bool id liveness -> (t_L,) bool leaf liveness: a leaf is live
    iff at least one live id maps to it (duplicates share a leaf)."""
    t_L = index.t[index.L]
    live = torch.zeros(t_L, dtype=torch.uint8, device=id_live.device)
    live.scatter_reduce_(0, index.id_leaf.long(), id_live.to(torch.uint8),
                         "amax")
    return live.bool()


def _traverse_frontier_batch(index: SketchIndex, qs: torch.Tensor, *,
                             tau: int, caps: Tuple[int, ...],
                             level_widths: list | None = None):
    """The shared 2D-frontier descent (levels 1..depth): ``qs`` is (m, L)
    int32 and the level-ℓ frontier a (m, cap_ℓ) tensor compacted per
    query.  Returns the final frontier ``(ids, dists, valid)`` (each (m,
    cap_depth)) plus per-query ``overflow``/``traversed`` (m,) int32.
    ``level_widths``: optional list that each level's live frontier width
    ((m,) int32) is appended to — the explain path's per-level report."""
    m = qs.shape[0]
    dev = qs.device
    ids = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    dists = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    valid = torch.ones((m, 1), dtype=torch.bool, device=dev)
    overflow = torch.zeros(m, dtype=torch.int32, device=dev)
    traversed = torch.ones(m, dtype=torch.int32, device=dev)

    for lev, enc in enumerate(index.levels, start=1):
        cap = ids.shape[1]
        c_ids, c_labels, c_exists = enc.children(ids.reshape(-1))  # (m·cap, A)
        A = c_ids.shape[-1]
        c_ids = c_ids.reshape(m, cap, A)
        c_labels = c_labels.reshape(m, cap, A)
        c_exists = c_exists.reshape(m, cap, A)
        q_char = qs[:, lev - 1][:, None, None]
        c_dists = dists[:, :, None] + (c_labels != q_char).to(torch.int32)
        c_valid = valid[:, :, None] & c_exists & (c_dists <= tau)
        ids, dists, valid, ov = _compact_batch(
            c_ids.reshape(m, -1), c_dists.reshape(m, -1),
            c_valid.reshape(m, -1), caps[lev])
        overflow += ov
        width = valid.sum(dim=1, dtype=torch.int32)
        if level_widths is not None:
            level_widths.append(width)
        traversed += width
    return ids, dists, valid, overflow, traversed


def scatter_root_plane(ids: torch.Tensor, vals: torch.Tensor,
                       valid: torch.Tensor, m: int,
                       t_root: int) -> torch.Tensor:
    """Scatter a final frontier onto a (m, t_root) base plane: the per-node
    minimum of ``vals`` over the valid frontier entries, BIG where the
    traversal pruned the node.  Invalid entries land in the scratch
    column ``t_root``, which is sliced off."""
    slot = torch.where(valid, ids, t_root).long()
    plane = torch.full((m, t_root + 1), BIG, dtype=torch.int32,
                       device=ids.device)
    plane.scatter_reduce_(1, slot, torch.where(valid, vals, BIG), "amin",
                          include_self=True)
    return plane[:, :t_root]


def select_topk_columns(dist: torch.Tensor, col_ids: torch.Tensor, k: int):
    """k-smallest selection over labeled column planes.

    dist: (m, R) int32 — one distance per (query, column), BIG on
    non-results; col_ids: (R,) global labels per column (non-negative,
    below 2^32); returns ((m, k) int32 ids, (m, k) int32 dists), each
    row ascending by (distance, label) — one selection on the unique
    int64 key ``dist << 32 | label``, so ties order by label; BIG lanes
    come back as (-1, BIG) pads.  Requires k <= R."""
    key = (dist.to(torch.int64) << 32) | col_ids.to(torch.int64)[None, :]
    key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    d_k = (key >> 32).to(torch.int32)
    l_k = (key & 0xFFFFFFFF).to(torch.int32)
    return torch.where(d_k < BIG, l_k, -1), torch.clamp(d_k, max=BIG)


def select_topk_scores(scores: torch.Tensor, dist: torch.Tensor,
                       col_ids: torch.Tensor, k: int):
    """k-*largest* selection over re-ranked column planes.

    scores: (m, R) float32 exact re-rank scores, -1.0 on non-survivor
    lanes; dist: (m, R) int32 Hamming distances (carried along, BIG off
    the survivors); col_ids: (R,) global labels (non-negative, below
    2^31); returns ((m, k) int32 ids, (m, k) int32 dists, (m, k) f32
    scores), each row descending by (score, -label), so equal scores
    order by the smaller id.  Lanes past the survivors come back as
    (-1, BIG, -1.0) pads.  Requires k <= R.

    The sort key is the int32 bit pattern of the score (monotone on
    [0, 1]; the -1.0 sentinel's is negative): one ``torch.topk`` over the
    unique int64 key ``bits << 32 | (0xFFFFFFFF - label)`` picks the
    columns, and dist and score are gathered there — the order both of
    the JAX package's lowerings give."""
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    key = (bits.to(torch.int64) << 32) | (
        0xFFFFFFFF - col_ids.to(torch.int64))[None, :]
    col = torch.topk(key, k, dim=1, largest=True, sorted=True).indices
    s_k = scores.to(torch.float32).gather(1, col)
    d_k = dist.gather(1, col)
    l_k = col_ids.to(torch.int32)[col]
    hit = s_k >= 0
    return (torch.where(hit, l_k, -1), torch.where(hit, d_k, BIG),
            torch.where(hit, s_k, -1.0))


def _pad_topk(dists: torch.Tensor, ids: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad (m, kk) selections out to (m, k) with (BIG, -1)."""
    kk = ids.shape[-1]
    if kk == k:
        return dists, ids
    pad = tuple(ids.shape[:-1]) + (k - kk,)
    return (torch.cat([dists, dists.new_full(pad, BIG)], dim=-1),
            torch.cat([ids, ids.new_full(pad, -1)], dim=-1))


def _search_trace_batch(index: SketchIndex, qs: torch.Tensor, *, tau: int,
                        caps: Tuple[int, ...],
                        block_m: int = ops.DEFAULT_BLOCK_M,
                        id_live: torch.Tensor | None = None) -> SearchResult:
    """Natively batched search body: ``qs`` is (m, L) and the frontier a
    (m, cap) 2D tensor compacted per query; the sparse layer runs through
    the query-tiled batch verify kernel.  ``id_live``: optional (n,) bool
    tombstone mask shared by every query."""
    qs = qs.to(torch.int32)
    live = _leaf_live(index, id_live) if id_live is not None else None
    m = qs.shape[0]
    ids, dists, valid, overflow, traversed = _traverse_frontier_batch(
        index, qs, tau=tau, caps=caps)

    if index.tail is not None:
        tail = index.tail
        base_root = scatter_root_plane(ids, dists, valid, m, tail.t_root)
        base_leaf = base_root.index_select(1, tail.leaf_root)     # (m, t_L)
        if tail.suffix_len > 0:
            q_sfx = pack_vertical_torch(qs[:, index.ls:], index.b)  # (m, b, W)
            hit, leaf_dist = ops.sparse_verify_batch(
                tail.paths_vert, ops.to_lane_major(q_sfx), base_leaf,
                tau=tau, live=live, block_m=block_m)
            survive = hit > 0
        else:
            if live is not None:
                base_leaf = torch.where(live[None, :], base_leaf, BIG)
            survive = base_leaf <= tau
            leaf_dist = base_leaf
    else:
        # no collapsed tail (LOUDS/FST baselines): frontier is at level L
        leaf_dist = scatter_root_plane(ids, dists, valid, m, index.t[index.L])
        if live is not None:
            leaf_dist = torch.where(live[None, :], leaf_dist, BIG)
        survive = leaf_dist <= tau

    mask = survive.index_select(1, index.id_leaf)
    if id_live is not None:
        mask &= id_live[None, :]
    dist = torch.where(mask, leaf_dist.index_select(1, index.id_leaf), BIG)
    return SearchResult(mask=mask, dist=dist, overflow=overflow,
                        traversed=traversed)


def _search_trace(index: SketchIndex, q: torch.Tensor, *, tau: int,
                  caps: Tuple[int, ...],
                  id_live: torch.Tensor | None = None) -> SearchResult:
    """Single-query search body (``q``: (L,)): the m=1 row of the batched
    body, with scalar ``overflow``/``traversed``."""
    res = _search_trace_batch(index, q[None], tau=tau, caps=caps, block_m=1,
                              id_live=id_live)
    return SearchResult(*(x[0] for x in res))


# ---------------------------------------------------------------------------
# searcher cache
# ---------------------------------------------------------------------------

# key: (id(index), tau, caps, block_m-or-None, with_live) -> (index, fn),
# through ``_pin_cache_get``: the index is held strongly in the value so
# its id can never be recycled while the entry lives; FIFO-bounded so
# sweeps over many (index, τ, cap) combinations cannot grow it without
# limit.
_SEARCHER_CACHE: Dict[tuple, tuple] = {}
_SEARCHER_CACHE_CAP = 128
_CACHE_STATS = {"hits": 0, "misses": 0, "traces": 0}
# The caches and counters are touched from every serving worker thread
# (one per collection): this lock guards their read-modify-writes and
# dict mutations (the builds themselves run outside it).
_CACHE_LOCK = threading.RLock()


def _pin_cache_get(cache: dict, cap: int, key: tuple, obj, build):
    """id-keyed bounded cache of the single-index, multi-index and
    sharded searchers:
    the value pins ``obj`` so that its id can never be recycled while
    the entry lives; FIFO-evicts beyond ``cap``.  Returns (value, hit)."""
    with _CACHE_LOCK:
        entry = cache.get(key)
    if entry is not None and entry[0] is obj:
        return entry[1], True
    value = build()
    with _CACHE_LOCK:
        while len(cache) >= cap:
            cache.pop(next(iter(cache)))  # FIFO evict
        cache[key] = (obj, value)
    return value, False


def _count_cache(event: str) -> None:
    """One ``hits`` / ``misses`` / ``traces`` event, under the lock."""
    with _CACHE_LOCK:
        _CACHE_STATS[event] += 1


def _note_trace() -> None:
    """Count one program build.  Torch runs eagerly and traces nothing:
    the segmented index calls this where it builds a fused closure (a
    rung, re-rank or frontier-width program), the events the JAX
    package's ``traces`` counts as jit traces of those programs."""
    _count_cache("traces")


def searcher_cache_info() -> Dict[str, int]:
    """Process-level cache counters: ``misses`` counts new (index, τ,
    caps, block_m, with_live) keys and new fused-program keys, ``hits``
    reuses of a cached one, and ``traces`` the fused closures built
    (``_note_trace``)."""
    with _CACHE_LOCK:
        return {"hits": _CACHE_STATS["hits"],
                "misses": _CACHE_STATS["misses"],
                "traces": _CACHE_STATS["traces"],
                "size": len(_SEARCHER_CACHE)}


def clear_searcher_cache() -> None:
    with _CACHE_LOCK:
        _SEARCHER_CACHE.clear()
        for key in _CACHE_STATS:
            _CACHE_STATS[key] = 0


def _as_queries(index: SketchIndex, q) -> torch.Tensor:
    if isinstance(q, np.ndarray):
        q = torch.from_numpy(q.astype(np.int32))
    return q.to(device=index.device, dtype=torch.int32)


def get_searcher(index: SketchIndex, tau: int,
                 cap_max: int = CAP_MAX_DEFAULT, *, batch: bool = False,
                 block_m: int = ops.DEFAULT_BLOCK_M, with_live: bool = False):
    """Cached searcher for this (index, τ, caps).  ``batch=False`` returns
    ``fn(q: (L,)) -> SearchResult``; ``batch=True`` the natively batched
    ``fn(qs: (m, L)) -> SearchResult`` with a leading query axis, whose
    verify kernel plays ``block_m`` queries per tile.  ``with_live=True``
    returns ``fn(q_or_qs, id_live: (n,) bool)``: dead ids never survive.

    Batched searchers pad the query axis up to ``bucket_m(m)`` rows
    (repeating the last query) and slice the results back to m."""
    caps = frontier_capacities(index.t, index.b, tau, cap_max)
    key = (id(index), tau, caps, block_m if batch else None, with_live)

    def run_one(q, id_live=None):
        return _search_trace(index, _as_queries(index, q), tau=tau, caps=caps,
                             id_live=id_live)

    def run_batch(qs, id_live=None):
        qs = _as_queries(index, qs)
        m = qs.shape[0]
        mb = bucket_m(m)
        res = _search_trace_batch(index, _pad_rows(qs, mb) if mb > m else qs,
                                  tau=tau, caps=caps, block_m=block_m,
                                  id_live=id_live)
        return res if mb == m else SearchResult(*(x[:m] for x in res))

    fn, hit = _pin_cache_get(_SEARCHER_CACHE, _SEARCHER_CACHE_CAP, key,
                             index, lambda: run_batch if batch else run_one)
    _count_cache("hits" if hit else "misses")
    return fn


def make_searcher(index: SketchIndex, tau: int,
                  cap_max: int = CAP_MAX_DEFAULT):
    """Single-query searcher for this (index, τ) from the process cache.
    Returns ``fn(q) -> SearchResult``."""
    return get_searcher(index, tau, cap_max, batch=False)


def make_batch_searcher(index: SketchIndex, tau: int,
                        cap_max: int = CAP_MAX_DEFAULT,
                        block_m: int = ops.DEFAULT_BLOCK_M):
    """Natively batched searcher: (m, L) queries -> SearchResult with a
    leading query axis; the whole batch shares one traversal and one
    query-tiled verify scan of the collapsed-path array."""
    return get_searcher(index, tau, cap_max, batch=True, block_m=block_m)


# ---------------------------------------------------------------------------
# host wrappers: overflow ladder + top-k engine
# ---------------------------------------------------------------------------

def search(index: SketchIndex, q, tau: int,
           cap_max: int = CAP_MAX_DEFAULT,
           max_cap: int = LADDER_CAP_MAX) -> SearchResult:
    """Range search with the overflow ladder: retries with a doubled
    capacity until the traversal is exact (or ``max_cap`` is hit).
    ``q``: (L,) sketch -> ``SearchResult`` over the index's n ids."""
    while True:
        res = get_searcher(index, tau, cap_max)(q)
        if int(res.overflow) == 0 or cap_max >= max_cap:
            return res
        cap_max *= 2


def topk(index: SketchIndex, q, k: int, tau0: int | None = None,
         cap_max: int = CAP_MAX_DEFAULT, max_cap: int = LADDER_CAP_MAX,
         block_m: int = ops.DEFAULT_BLOCK_M) -> TopKResult:
    """Exact k-nearest-neighbor search for one (L,) query: ``topk_batch``
    on a batch of one.  Returns (k,) ids/dists."""
    res = topk_batch(index, _as_queries(index, q)[None], k, tau0=tau0,
                     cap_max=cap_max, max_cap=max_cap, block_m=block_m)
    return TopKResult(ids=res.ids[0], dists=res.dists[0], tau=res.tau,
                      overflow=res.overflow)


def topk_batch(index: SketchIndex, qs, k: int, tau0: int | None = None,
               cap_max: int = CAP_MAX_DEFAULT, max_cap: int = LADDER_CAP_MAX,
               block_m: int = ops.DEFAULT_BLOCK_M) -> TopKResult:
    """Exact k-nearest-neighbor search: (m, L) queries -> (m, k)
    ids/dists.  One τ-escalation ladder for the whole batch — τ grows
    until every query has ≥ k survivors — then the k smallest exact
    distances, ties broken by id.

    Correctness: once every query has ≥ k survivors at threshold τ with
    zero frontier overflow, every excluded id has distance > τ ≥ the k-th
    smallest, so the selection over ``dist`` (exact inside the ball, BIG
    outside) is globally exact.  A nonzero ``overflow`` (only once the
    capacity ladder saturates ``max_cap``) marks a potentially partial
    result.  If ``k > n`` the result is padded with (-1, BIG)."""
    qs = _as_queries(index, qs)
    kk = min(k, index.n)
    tau = tau0 if tau0 is not None else tau_for_k(index.b, index.L, index.n, kk)
    tau = min(max(tau, 0), index.L)
    # the escalated capacity carries across tau rungs: a larger tau-ball
    # can only need at least as much frontier as the one that overflowed
    cap = cap_max
    while True:
        while True:
            res = get_searcher(index, tau, cap, batch=True,
                               block_m=block_m)(qs)
            overflow = int(res.overflow.sum())
            if overflow == 0 or cap >= max_cap:
                break
            cap *= 2
        if int(res.mask.sum(dim=1).min()) >= kk or tau >= index.L:
            break
        tau = min(index.L, max(tau + 1, 2 * tau))
    col = torch.arange(index.n, dtype=torch.int32, device=index.device)
    ids, dists = select_topk_columns(res.dist, col, kk)
    dists, ids = _pad_topk(dists, ids, k)
    return TopKResult(ids=ids, dists=dists, tau=tau, overflow=overflow)
