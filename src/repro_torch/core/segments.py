"""Dynamic segmented bST index: streaming insert/delete with size-tiered
merges, on the suffix column store.

The paper's bST is static; this module adds LSM-style maintenance on top
of the unchanged static machinery:

  * a small mutable **delta buffer** absorbs inserts and answers queries
    by brute-force scan (``ops.hamming_distances`` — exact distances at
    any τ);
  * sealed **segments** are immutable bSTs with a per-segment
    **tombstone bitmap**: ``delete`` flips a bit, and liveness is an
    argument of every query program, so deletes never rebuild anything;
  * a size-tiered ``merge()`` rebuilds two segments into one (dropping
    tombstones) and ``compact()`` rebuilds one segment;
  * queries run through a **fused program** per τ-ladder rung: every
    segment's traversal to its ℓ_s roots, one concatenated root base
    plane, the arena verify kernels over the sealed columns (suffix
    layout: packed suffix words, or plane columns when b·S > 32; full
    layout: full-length columns), the delta scan and the on-device
    (distance, id) selection.  The per-segment fan-out survives as the
    reference path (``use_arena=False``).  Both are bit-identical to
    each other and to the JAX package's ``repro.core.segments``.

Torch runs eagerly, so a "fused program" is a cached closure over the
stack's constants (capacities, plan, labels, base-offset lanes); it still
counts one ``dispatch_stats()["fused"]`` per rung, and the two-stage
re-rank one ``"rerank"`` per request.

Ids are **stable**: ``insert`` assigns monotonically increasing global
ids that survive merges and compactions.  Query planes are
column-compressed — (m, R) over the *physical* rows currently held
(every segment's rows in stack order, then the delta buffer's), labeled
by global id.  Planes and top-k results are torch tensors on the index's
device; column labels (``ColumnSearchResult.ids``) are host int64.

Three segment backends: "bst" (one bST per segment, on the tiered
suffix column store or the full-length arena), "multi" (one MI-bST per
segment) and "sharded" (one sharded bST per segment, its shards a
leading batched axis).  ``ShardedSegmentedIndex`` keeps S independent
stacks with round-robin inserts.

Durability: a ``repro_torch.store.StackBinding`` set as ``index.store``
journals every insert and delete before applying it and checkpoints the
segment set after every flush, merge and compaction, at the points where
the JAX package does, in its on-disk format.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ops import DEFAULT_BLOCK_M
from ..kernels.ref import BIG, RERANK_METRICS
from ..obs.explain import QueryExplain, RungExplain
from ..obs.trace import span as _obs_span
from .bst import build_bst
from .column_store import ColumnStore, tier_stats
from .cost_model import cost_single, frontier_capacities, tau_for_k
from .distributed_search import (build_sharded_bst, make_sharded_searcher,
                                 sharded_column_dists, topk_from_dists)
from .hamming import (as_words, n_words, pack_suffix_words_torch,
                      pack_vertical, pack_vertical_torch, resolve_device,
                      unpack_vertical)
from .multi_index import (build_multi_index, mi_column_dists,
                          mi_search_batch, mi_trace_params)
from .search import (CAP_MAX_DEFAULT, LADDER_CAP_MAX, TopKResult,
                     _CACHE_LOCK, _count_cache, _note_trace, _pad_rows,
                     _pad_topk, _pin_cache_get, _traverse_frontier_batch, bucket_m,
                     get_searcher, scatter_root_plane, searcher_cache_info,
                     select_topk_columns, select_topk_scores)

BIG_I = int(BIG)

BACKENDS = ("bst", "multi", "sharded")

# Column layouts of the fused path: "suffix" (default) stores
# per-segment packed suffix columns below each segment's ℓ_s in the
# ``ColumnStore``; "full" keeps the full-length ``_ColumnArena`` — the
# bit-identical reference.
LAYOUTS = ("suffix", "full")

# Monotonic segment serials: every sealed Segment gets the next value,
# and merged/compacted replacements get fresh ones.  Serials key the
# fused-program cache and the sharded searcher pin — unlike ``id()``, a
# serial is never reused.
_SEG_SERIALS = itertools.count()

# The fan-out's sharded searchers, keyed on (segment serial, τ, cap) and
# pinning their ShardedBST; FIFO-bounded.
_SHARDED_SEARCHER_CACHE: Dict[tuple, tuple] = {}
_SHARDED_SEARCHER_CACHE_CAP = 128

# The frontier cap each backend's capacity ladder starts from.
_LADDER_START = {"bst": CAP_MAX_DEFAULT, "multi": 1 << 15,
                 "sharded": 1 << 14}

# Program launches issued by the segmented query path: "fanout" counts
# the per-segment reference path (one per segment searcher call,
# capacity-ladder retries included, plus one per delta-buffer scan),
# "fused" the fused path (one per τ-ladder rung and capacity rung),
# "rerank" the exact re-rank pass (one per ``topk(rerank=...)``
# request, regardless of segment count).
_DISPATCH_STATS = {"total": 0, "fused": 0, "fanout": 0, "rerank": 0}
_DISPATCH_LOCK = threading.Lock()


def _dispatch(kind: str) -> None:
    with _DISPATCH_LOCK:
        _DISPATCH_STATS["total"] += 1
        _DISPATCH_STATS[kind] += 1


def dispatch_stats() -> Dict[str, int]:
    """Program-launch counters of the segmented query path: ``total``,
    split into ``fused`` (one per τ rung, independent of segment count),
    ``fanout`` (one per segment per rung) and ``rerank`` (one per
    ``topk(rerank=...)`` request)."""
    with _DISPATCH_LOCK:
        return dict(_DISPATCH_STATS)


def reset_dispatch_stats() -> None:
    with _DISPATCH_LOCK:
        for k in _DISPATCH_STATS:
            _DISPATCH_STATS[k] = 0


def ensure_serial_floor(floor: int) -> None:
    """Advance the global segment-serial counter to at least ``floor``.
    Recovery calls this with ``max(persisted serial) + 1`` so serials
    restored from disk can never collide with serials minted later in
    this process — the invariant every serial-keyed cache relies on (a
    serial is never reused)."""
    global _SEG_SERIALS
    with _DISPATCH_LOCK:
        cur = next(_SEG_SERIALS)
        _SEG_SERIALS = itertools.count(max(cur, int(floor)))


def tombstone_bits(n: int) -> int:
    """Storage cost in bits of one tombstone bitmap over ``n`` ids,
    accounted like ``BitVector.nbits``: word-padded payload + the 32-bit
    per-word cumulative-popcount table.

    >>> tombstone_bits(64)      # 2 payload words + 3 table entries
    160
    """
    words = max(1, (int(n) + 31) // 32)
    return words * 32 + (words + 1) * 32


@dataclasses.dataclass
class Segment:
    """One immutable sealed segment: a static index + host-side metadata.

    Attributes:
      index:    the queryable ``SketchIndex``, ``MultiIndex`` or
                ``ShardedBST`` of the stack's backend (on its device).
      packed:   (n_seg, b, W) uint32 — the sealed sketches kept host-side
                in ``pack_vertical`` bit-plane form; merges, compacts and
                the suffix store unpack on demand through :attr:`sketches`.
      ids:      (n_seg,) int64 global ids, sorted ascending.
      live:     (n_seg,) bool tombstone bitmap (False = deleted).
      L, b:     the sketch geometry ``packed`` was packed with.
      serial:   process-monotonic id (auto-assigned), never reused.
      payloads: optional (n_seg, Wp) uint32 — the rows' token-set bitmaps
                (``hamming.pack_sets``) for the exact re-rank; row order
                matches ``ids``.
    """

    index: object
    packed: np.ndarray
    ids: np.ndarray
    live: np.ndarray
    L: int
    b: int
    serial: int = dataclasses.field(
        default_factory=lambda: next(_SEG_SERIALS))
    payloads: Optional[np.ndarray] = None

    @property
    def sketches(self) -> np.ndarray:
        """(n_seg, L) uint8, unpacked on demand."""
        return unpack_vertical(self.packed, self.b, self.L)

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    @property
    def n_live(self) -> int:
        return int(self.live.sum())


class SegmentedSearchResult(NamedTuple):
    mask: torch.Tensor    # (m, n_ids) bool — live ids within τ per query
    dist: torch.Tensor    # (m, n_ids) int32 — exact distance on mask, BIG off
    overflow: int         # total dropped frontier entries (0 = exact)


class ColumnSearchResult(NamedTuple):
    """Column-compressed range-search result — the primary contract: one
    column per *physical* row currently held (every segment's rows in
    stack order, then the delta buffer's), labeled by stable global id.
    O(m · R) where R shrinks with merge/compact."""

    mask: torch.Tensor    # (m, R) bool — live columns within τ per query
    dist: torch.Tensor    # (m, R) int32 — exact distance where mask, BIG off
    ids: np.ndarray       # (R,) int64 — global id per column (host)
    overflow: int         # total dropped frontier entries (0 = exact)


class _ColumnArena:
    """Device-resident verify state of the full-length layout: one
    full-length (b, W) column per sealed row, maintained across queries
    and appended to on a flush.

    Attributes (R = sealed physical rows, T = 1 + Σ per-segment ℓ_s-root
    counts — slot 0 is the delta buffer's trivial base):
      cols:      (b, W, R) int32 — segment blocks in stack order;
      base_idx:  (R,) int32 — ``1 + root_offset[s] + leaf_root[id_leaf[row]]``;
      gids:      (R,) int32 — global id per column (selection labels);
      live:      (R,) bool — liveness lanes, flipped in place by ``delete``;
      col_ids:   (R,) int64 host — global id per column (result labels);
      col_off:   dict serial -> first column of that segment's block;
      root_off:  dict serial -> first root slot of that segment;
      t_root_total: Σ per-segment root counts;
      serials:   the segment-stack fingerprint this arena matches.
    """

    def __init__(self):
        self.serials: Tuple[int, ...] = ()
        self.cols: Optional[torch.Tensor] = None
        self.base_idx: Optional[torch.Tensor] = None
        self.gids: Optional[torch.Tensor] = None
        self.live: Optional[torch.Tensor] = None
        self.col_ids = np.zeros((0,), np.int64)
        self.col_off: Dict[int, int] = {}
        self.root_off: Dict[int, int] = {}
        self.t_root_total = 0

    @property
    def n_cols(self) -> int:
        return int(self.col_ids.shape[0])

    def array_bytes(self) -> int:
        """Device bytes held by the arena."""
        if self.cols is None:
            return 0
        return sum(x.numel() * x.element_size()
                   for x in (self.cols, self.base_idx, self.gids, self.live))

    def host_bytes(self) -> int:
        return 0

    def col_bytes(self, tier: Optional[str] = None) -> int:
        if self.cols is None or tier == "cold":
            return 0
        return self.cols.numel() * self.cols.element_size()

    def tier_summary(self) -> Dict[str, int]:
        return {"hot_blocks": len(self.col_off), "cold_blocks": 0,
                "hot_bytes": self.col_bytes(), "cold_bytes": 0}


# Fused programs, keyed on (backend, layout, index scope, segment-serial
# fingerprint, placement generation, kind, τ, capacity rung, k,
# block_m); the closures pin the segment indexes and column arrays they
# stream, and an index drops its own dead-generation entries the moment
# its fingerprint changes (``_fused_fn``).
_FUSED_CACHE: Dict[tuple, object] = {}
_FUSED_CACHE_CAP = 32


def clear_fused_cache() -> None:
    """Drop every cached fused program (and its pinned arrays)."""
    with _CACHE_LOCK:
        _FUSED_CACHE.clear()


def _fused_lookup(key: tuple):
    with _CACHE_LOCK:
        return _FUSED_CACHE.get(key)


def _fused_insert(key: tuple, fn) -> None:
    """Cache a built program, FIFO-evicting beyond the cap."""
    with _CACHE_LOCK:
        while len(_FUSED_CACHE) >= _FUSED_CACHE_CAP:
            _FUSED_CACHE.pop(next(iter(_FUSED_CACHE)))
        _FUSED_CACHE[key] = fn


def _empty_topk(m: int, k: int, device) -> TopKResult:
    return TopKResult(
        ids=torch.full((m, k), -1, dtype=torch.int32, device=device),
        dists=torch.full((m, k), BIG_I, dtype=torch.int32, device=device),
        tau=0, overflow=0)


def _ladder(columns_fn, n_live: int, b: int, L: int, qs: np.ndarray, k: int,
            tau0: Optional[int]):
    """The shared τ ladder over column planes: escalate τ (seeded by
    ``tau_for_k`` over the live count) until every query has ≥
    min(k, n_live) survivors.  Returns (kk, τ, dist, col_ids, overflow)."""
    kk = min(int(k), n_live)
    tau = tau0 if tau0 is not None else tau_for_k(b, L, n_live, kk)
    tau = min(max(int(tau), 0), L)
    while True:
        dist, col_ids, overflow = columns_fn(qs, tau)
        if int((dist < BIG_I).sum(dim=1).min()) >= kk or tau >= L:
            return kk, tau, dist, col_ids, overflow
        tau = min(L, max(tau + 1, 2 * tau))


def _ladder_topk(columns_fn, n_live: int, b: int, L: int, qs: np.ndarray,
                 k: int, tau0: Optional[int], device) -> TopKResult:
    """The reference kNN ladder over column-compressed fan-out planes.

    ``columns_fn(qs, tau)`` -> ((m, R) int32 distances over the physical
    columns, BIG on non-results; (R,) int64 global id per column;
    overflow).  After the ladder, the host shard-merge selection
    (``topk_from_dists``) orders by (distance, global id)."""
    m = qs.shape[0]
    if n_live == 0:
        return _empty_topk(m, int(k), device)
    _, tau, dist, col_ids, overflow = _ladder(columns_fn, n_live, b, L, qs,
                                              k, tau0)
    with _obs_span("topk_readback", cat="device", k=int(k)):
        ids, dists = topk_from_dists(dist.cpu().numpy(), int(k), ids=col_ids)
    return TopKResult(ids=torch.from_numpy(ids).to(device),
                      dists=torch.from_numpy(dists).to(device),
                      tau=tau, overflow=overflow)


class _PayloadArena:
    """Device payload plane of the full-length layout: one (Wp, R) bitmap
    column per sealed row, stack order — a flush appends a block, a
    merge/compact rebuilds.  (The suffix layout keeps payloads inside
    the ``ColumnStore`` blocks instead.)"""

    def __init__(self, pay_words: int, device):
        self.pay_words = int(pay_words)
        self.device = device
        self.serials: Tuple[int, ...] = ()
        self.pays = torch.zeros((self.pay_words, 0), dtype=torch.int32,
                                device=device)

    def refresh(self, segments: List[Segment],
                serials: Tuple[int, ...]) -> torch.Tensor:
        if self.serials == serials:
            return self.pays
        if not (len(serials) > len(self.serials)
                and serials[:len(self.serials)] == self.serials):
            self.pays = self.pays[:, :0]
            self.serials = ()
        new_segs = segments[len(self.serials):]
        if new_segs:
            block = np.concatenate([seg.payloads.T for seg in new_segs],
                                   axis=-1)
            self.pays = torch.cat([self.pays, as_words(block, self.device)],
                                  dim=-1)
        self.serials = serials
        return self.pays

    def array_bytes(self) -> int:
        return self.pays.numel() * self.pays.element_size()


def _rerank_select(dist: torch.Tensor, pay_vert: torch.Tensor,
                   q_pay: torch.Tensor, col_ids: torch.Tensor, *,
                   metric: str, kk: int, block_m: int):
    """Exact re-rank + selection of the reference path: survivors of the
    final-τ dist plane are scored by ``ops.exact_rerank`` and selected by
    ``select_topk_scores`` — the kernel and sort of the fused re-rank
    program, so every path is bit-identical."""
    surv = (dist < BIG).to(torch.int32)
    scores = ops.exact_rerank(pay_vert, q_pay, surv, metric=metric,
                              block_m=block_m)
    return select_topk_scores(scores, dist, col_ids, kk)


def _pad_topk_scores(ids: torch.Tensor, dists: torch.Tensor,
                     scores: torch.Tensor, k: int):
    """Pad re-ranked (m, kk) planes out to (m, k): (-1, BIG, -1.0)."""
    kk = ids.shape[-1]
    if kk == k:
        return ids, dists, scores
    pad = tuple(ids.shape[:-1]) + (k - kk,)
    return (torch.cat([ids, ids.new_full(pad, -1)], dim=-1),
            torch.cat([dists, dists.new_full(pad, BIG_I)], dim=-1),
            torch.cat([scores, scores.new_full(pad, -1.0)], dim=-1))


def _empty_topk_rerank(m: int, k: int, device) -> TopKResult:
    return _empty_topk(m, k, device)._replace(
        scores=torch.full((m, k), -1.0, dtype=torch.float32, device=device))


def _ladder_topk_rerank(columns_fn, payload_rows_fn, n_live: int, b: int,
                        L: int, block_m: int, qs: np.ndarray, k: int,
                        tau0: Optional[int], metric: str,
                        q_pay: np.ndarray, device) -> TopKResult:
    """The reference two-stage ladder: escalate τ until every query has
    ≥ min(k, n_live) survivors, then ONE ``_rerank_select`` scores the
    final survivor plane against ``payload_rows_fn()``'s (R, Wp) host
    rows and selects the k best (score desc, id asc)."""
    m = qs.shape[0]
    if n_live == 0:
        return _empty_topk_rerank(m, int(k), device)
    kk, tau, dist, col_ids, overflow = _ladder(columns_fn, n_live, b, L, qs,
                                               k, tau0)
    pay_vert = as_words(payload_rows_fn().T, device)
    _dispatch("rerank")
    with _obs_span("rerank", cat="device", metric=metric, kk=kk):
        ids, dists, scores = _rerank_select(
            dist, pay_vert, as_words(q_pay.T, device),
            torch.from_numpy(col_ids.astype(np.int32)).to(device),
            metric=metric, kk=kk, block_m=block_m)
    ids, dists, scores = _pad_topk_scores(ids, dists, scores, int(k))
    return TopKResult(ids=ids, dists=dists, tau=tau, overflow=int(overflow),
                      scores=scores)


class _ExplainRecorder:
    """Explain-mode bookkeeping: serves an index's column planes so that
    every τ-ladder rung is recorded as a ``RungExplain`` (survivor
    and pruned counts off the rung's own distance plane, dispatch
    deltas, wall clock, frontier widths), and snapshots the process-wide
    cache, dispatch and tier counters at construction so that ``finish``
    reports the request's deltas.  ``columns`` returns the identical
    planes, so an explained answer is bit-identical to a plain one.

    The counters are process-wide, so explain is a single-request
    diagnostic: queries on other threads would bleed into the deltas
    (the counts read off the distance planes are always exact)."""

    def __init__(self, columns_fn, frontier_fn=None):
        self.t0 = time.perf_counter()
        self.cache0 = searcher_cache_info()
        self.disp0 = dispatch_stats()
        self.tier0 = tier_stats()
        self.rungs: List[RungExplain] = []
        self._columns_fn = columns_fn
        self._frontier_fn = frontier_fn

    def columns(self, qs, tau):
        """``columns_fn``'s planes, recorded as one rung (with the
        frontier widths where ``frontier_fn`` samples them)."""
        t0 = time.perf_counter()
        d0 = dispatch_stats()
        dist, col_ids, overflow = self._columns_fn(qs, tau)
        d1 = dispatch_stats()
        dt = (time.perf_counter() - t0) * 1e3
        surv = (dist < BIG_I).sum(dim=1).tolist()
        frontier = (self._frontier_fn(qs, tau)
                    if self._frontier_fn is not None else None)
        cand = int(dist.shape[1])
        self.rungs.append(RungExplain(
            tau=int(tau), candidates=cand, survivors=surv,
            pruned=[cand - s for s in surv], overflow=int(overflow),
            dispatches={k: d1[k] - d0[k] for k in d1},
            duration_ms=dt, frontier=frontier))
        return dist, col_ids, overflow

    def finish(self, *, op: str, backend: str, n_queries: int,
               n_live: int, k: Optional[int], tau0: Optional[int],
               tau_final: int, rerank: Optional[str]) -> QueryExplain:
        cache1 = searcher_cache_info()
        disp1 = dispatch_stats()
        tier1 = tier_stats()
        rerank_surv = None
        if rerank is not None and self.rungs:
            rerank_surv = list(self.rungs[-1].survivors)
        return QueryExplain(
            op=op, backend=backend, n_queries=int(n_queries),
            n_live=int(n_live), k=k, tau0=tau0, tau_final=int(tau_final),
            rungs=self.rungs, rerank=rerank,
            rerank_survivors=rerank_surv,
            cache={key: cache1[key] - self.cache0[key]
                   for key in ("hits", "misses", "traces")},
            dispatch={key: disp1[key] - self.disp0[key] for key in disp1},
            tier={key: tier1[key] - self.tier0[key] for key in tier1},
            duration_ms=(time.perf_counter() - self.t0) * 1e3)


def _root_plane(stack, qs: torch.Tensor, tau: int, exact_prefix: bool):
    """Every segment's 2D-frontier descent to its ℓ_s roots, scattered
    onto ONE concatenated (m, T) root plane (slot 0 the delta's trivial
    0).  ``stack``: (index, caps, t_root) per segment.  ``exact_prefix``:
    the suffix layout carries the traversal's exact prefix distances,
    which its suffix verify completes; the full layout carries only
    reached (0) / pruned (BIG), its full-length columns recomputing the
    prefix.  Returns (plane, (m,) overflow)."""
    m = qs.shape[0]
    planes = [torch.zeros((m, 1), dtype=torch.int32, device=qs.device)]
    overflow = torch.zeros((m,), dtype=torch.int32, device=qs.device)
    for ix, caps, t_root in stack:
        ids, dists, valid, ov, _ = _traverse_frontier_batch(ix, qs, tau=tau,
                                                            caps=caps)
        vals = dists if exact_prefix else torch.zeros_like(dists)
        planes.append(scatter_root_plane(ids, vals, valid, m, t_root))
        overflow += ov
    return torch.cat(planes, dim=1), overflow


def _stack_inverse(plan, device) -> Optional[torch.Tensor]:
    """The static inverse permutation from the plan's group order back to
    stack order (None when the two agree)."""
    if not plan:
        return None
    inv = np.argsort(np.concatenate([g.perm for g in plan]))
    if (inv == np.arange(len(inv))).all():
        return None
    return torch.from_numpy(inv).to(device)


class SegmentedIndex:
    """A dynamic, incrementally maintained index over b-bit sketches.

    Parameters:
      L, b:       sketch length / bits per character (Σ = [0, 2^b)).
      delta_cap:  delta-buffer rows that trigger an automatic ``flush``.
      backend:    "bst" (default): each segment is one bST; "multi": one
                  MI-bST over ``mi_blocks`` blocks; "sharded": one
                  sharded bST over ``n_shards`` shards (clamped to the
                  segment's row count).
      mi_blocks:  block count of the "multi" backend.
      n_shards:   shard count of the "sharded" backend.
      lam:        the paper's λ collapse parameter, forwarded to builds.
      auto_merge: run the size-tiered merge policy after every automatic
                  flush (manual ``flush()`` never merges implicitly).
      block_m:    query tile of the verify kernels.
      use_arena:  serve queries through the fused program (one dispatch
                  per τ rung regardless of segment count); False runs the
                  per-segment reference fan-out.
      layout:     the bst backend's column layout: "suffix" (default):
                  packed per-segment suffix columns in the
                  ``ColumnStore``; "full": the full-length
                  ``_ColumnArena`` reference.
      hot_bytes:  device budget of the column store (``None``: every
                  block on the device); past it, the least recently used
                  blocks go cold (host master copies, staged to the
                  device per query) with bit-identical answers.
      payload_words: uint32 words per row payload bitmap
                  (``ceil(vocab / 32)``, see ``hamming.pack_sets``).
                  When set, every ``insert`` must supply matching
                  ``payloads`` and ``topk*(rerank=metric)`` runs the exact
                  re-rank; None disables both.
      device:     where the segments, columns and query planes live
                  (default "cuda"; raises if CUDA is asked for and
                  missing).

    >>> import numpy as np
    >>> idx = SegmentedIndex(L=8, b=2, delta_cap=4, device="cpu")
    >>> ids = idx.insert(np.zeros((5, 8), np.uint8))   # auto-flush at 4
    >>> (len(ids), idx.n_live, len(idx.segments))
    (5, 5, 1)
    >>> int(idx.delete(ids[:2]))
    2
    >>> idx.n_live
    3
    """

    def __init__(self, L: int, b: int, *, delta_cap: int = 4096,
                 backend: str = "bst", mi_blocks: int = 2, n_shards: int = 4,
                 lam: float = 0.5, auto_merge: bool = True,
                 block_m: int = DEFAULT_BLOCK_M, use_arena: bool = True,
                 layout: str = "suffix",
                 hot_bytes: Optional[int] = None,
                 payload_words: Optional[int] = None, device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}")
        self.device = resolve_device(device)
        self.L = int(L)
        self.b = int(b)
        self.delta_cap = int(delta_cap)
        self.backend = backend
        self.mi_blocks = int(mi_blocks)
        self.n_shards = int(n_shards)
        self.lam = float(lam)
        self.auto_merge = bool(auto_merge)
        self.block_m = int(block_m)
        self.use_arena = bool(use_arena)
        self.layout = layout
        self.hot_bytes = hot_bytes
        self.payload_words = (None if payload_words is None
                              else int(payload_words))

        self.segments: List[Segment] = []
        self.n_ids = 0                      # global ids ever assigned
        self._delta_sk = np.zeros((0, self.L), np.uint8)
        self._delta_ids = np.zeros((0,), np.int64)
        self._delta_live = np.zeros((0,), bool)
        self._delta_vert: Optional[torch.Tensor] = None  # (b, W, ndb)
        self._delta_pay = (np.zeros((0, self.payload_words), np.uint32)
                           if self.payload_words is not None else None)
        self._delta_pay_vert: Optional[torch.Tensor] = None  # (Wp, ndb)
        self._pay_arena: Optional[_PayloadArena] = None
        # the suffix ColumnStore (layout "suffix") or the full-length
        # _ColumnArena ("full") — the same maintenance surface (serials /
        # live / col_off / col_ids / array_bytes)
        self._arena: Optional[object] = None
        self._fused_id = next(_SEG_SERIALS)             # per-index cache scope
        self._fused_stamp: Tuple = ()                   # (serials, gen)
        self.counters = {"flushes": 0, "merges": 0, "compactions": 0,
                         "inserted": 0, "deleted": 0}
        # write hook: fn(event: str, info: dict) fired after every
        # lifecycle write ("insert" / "delete" / "flush" / "merge" /
        # "compact").  Exceptions are the caller's problem.
        self.event_hook: Optional[object] = None
        # durability binding (repro_torch.store.StackBinding): log-before-
        # apply for insert/delete, checkpoint after flush/merge/compact.
        # None = in-memory only.
        self.store: Optional[object] = None

    # -- mutation --------------------------------------------------------

    def _emit(self, event: str, **info) -> None:
        if self.event_hook is not None:
            self.event_hook(event, info)

    def _check_payloads(self, payloads, k: int) -> Optional[np.ndarray]:
        """Validate insert-time payloads against ``payload_words``."""
        if self.payload_words is None:
            if payloads is not None:
                raise ValueError(
                    "payloads supplied but the index was built without "
                    "payload_words")
            return None
        if payloads is None:
            raise ValueError(
                "payload_words is set: insert requires (k, "
                f"{self.payload_words}) uint32 payload bitmaps")
        pay = np.asarray(payloads, dtype=np.uint32)
        if pay.ndim == 1:
            pay = pay[None, :]
        if pay.shape != (k, self.payload_words):
            raise ValueError(f"payloads shape {pay.shape} != "
                             f"({k}, {self.payload_words})")
        return pay

    def insert(self, sketches: np.ndarray,
               payloads: Optional[np.ndarray] = None) -> np.ndarray:
        """Append sketches to the delta buffer; returns their (k,) int64
        global ids.  ``sketches``: (k, L) or (L,) uint8 over [0, 2^b);
        ``payloads``: the rows' (k, Wp) uint32 set bitmaps when the index
        has ``payload_words``.  Triggers ``flush`` (and, if
        ``auto_merge``, the size-tiered merge policy) once the delta
        buffer reaches ``delta_cap`` rows."""
        sk = np.asarray(sketches, dtype=np.uint8)
        if sk.ndim == 1:
            sk = sk[None, :]
        if sk.shape[1] != self.L:
            raise ValueError(f"sketch length {sk.shape[1]} != L={self.L}")
        if sk.size and int(sk.max()) >= (1 << self.b):
            raise ValueError("character exceeds alphabet [0, 2^b)")
        k = sk.shape[0]
        pay = self._check_payloads(payloads, k)
        new_ids = np.arange(self.n_ids, self.n_ids + k, dtype=np.int64)
        if self.store is not None:
            # write-ahead: log, then apply
            self.store.log_insert(new_ids, sk, payloads=pay)
        self.n_ids += k
        self._delta_sk = np.concatenate([self._delta_sk, sk])
        self._delta_ids = np.concatenate([self._delta_ids, new_ids])
        self._delta_live = np.concatenate(
            [self._delta_live, np.ones(k, bool)])
        self._delta_vert = None
        if pay is not None:
            self._delta_pay = np.concatenate([self._delta_pay, pay])
            self._delta_pay_vert = None
        self.counters["inserted"] += k
        self._emit("insert", rows=k)
        if len(self._delta_ids) >= self.delta_cap:
            self.flush()
            if self.auto_merge:
                self.maybe_merge()
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone global ids (scalar or (k,) array-like); returns the
        number of ids newly deleted (already-dead or unknown ids are
        ignored).  No index is rebuilt: the host tombstone bitmaps flip,
        and so do the column store's device liveness lanes.  The JAX
        package builds a new lane array here; this port writes the lanes
        in place, which is safe because every fused program reads
        ``live`` afresh on each call."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, dtype=np.int64)))
        if self.store is not None and ids.size:
            self.store.log_delete(ids)           # write-ahead: log, then apply
        newly = 0
        arena = self._arena
        lanes: List[np.ndarray] = []     # arena columns going dead
        containers: List[Tuple[np.ndarray, np.ndarray, Optional[int]]] = [
            (self._delta_ids, self._delta_live, None)]
        containers += [
            (seg.ids, seg.live,
             arena.col_off.get(seg.serial) if arena is not None else None)
            for seg in self.segments]
        for id_arr, live_arr, col0 in containers:
            if id_arr.size == 0:
                continue
            pos = np.searchsorted(id_arr, ids)
            ok = (pos < id_arr.size) & (
                id_arr[np.minimum(pos, id_arr.size - 1)] == ids)
            sel = pos[ok]
            newly += int(live_arr[sel].sum())
            live_arr[sel] = False
            if col0 is not None and sel.size:
                lanes.append(col0 + sel)
        if lanes:
            arena.live[torch.from_numpy(np.concatenate(lanes)).to(
                arena.live.device)] = False
        self.counters["deleted"] += newly
        self._emit("delete", rows=newly)
        return newly

    def flush(self) -> Optional[Segment]:
        """Seal the delta buffer's live rows into a new immutable segment
        (dead delta rows are dropped for free).  Returns the new Segment,
        or None when nothing was live."""
        live = self._delta_live
        seg = None
        if live.any():
            sk = self._delta_sk[live]
            ids = self._delta_ids[live]
            pay = (self._delta_pay[live]
                   if self._delta_pay is not None else None)
            seg = Segment(index=self._build(sk),
                          packed=pack_vertical(sk, self.b), ids=ids,
                          live=np.ones(len(ids), bool), L=self.L, b=self.b,
                          payloads=pay)
            self.segments.append(seg)
            self.counters["flushes"] += 1
            self._emit("flush", rows=seg.n)
        self._delta_sk = np.zeros((0, self.L), np.uint8)
        self._delta_ids = np.zeros((0,), np.int64)
        self._delta_live = np.zeros((0,), bool)
        self._delta_vert = None
        if self._delta_pay is not None:
            self._delta_pay = np.zeros((0, self.payload_words), np.uint32)
            self._delta_pay_vert = None
        if self.store is not None:
            self.store.checkpoint(self)
        return seg

    def merge(self, i: Optional[int] = None,
              j: Optional[int] = None) -> bool:
        """Rebuild two segments into one, dropping tombstoned rows.
        Defaults to the two smallest segments (size-tiered choice);
        returns False when fewer than two segments exist."""
        if len(self.segments) < 2:
            return False
        if i is None or j is None:
            order = np.argsort([seg.n for seg in self.segments],
                               kind="stable")
            i, j = int(order[0]), int(order[1])
        if i == j:
            raise ValueError("cannot merge a segment with itself")
        a, b_ = self.segments[i], self.segments[j]
        sk = np.concatenate([a.sketches[a.live], b_.sketches[b_.live]])
        ids = np.concatenate([a.ids[a.live], b_.ids[b_.live]])
        pay = None
        if self.payload_words is not None:
            pay = np.concatenate([a.payloads[a.live], b_.payloads[b_.live]])
        order = np.argsort(ids, kind="stable")   # keep ids sorted for delete
        sk, ids = sk[order], ids[order]
        if pay is not None:
            pay = pay[order]
        lo, hi = min(i, j), max(i, j)
        del self.segments[hi], self.segments[lo]
        if len(ids):
            self.segments.insert(lo, Segment(
                index=self._build(sk), packed=pack_vertical(sk, self.b),
                ids=ids, live=np.ones(len(ids), bool), L=self.L, b=self.b,
                payloads=pay))
        self.counters["merges"] += 1
        self._emit("merge", rows=int(len(ids)))
        if self.store is not None:
            self.store.checkpoint(self)
        return True

    def maybe_merge(self) -> int:
        """Size-tiered merge policy: while two segments share a size tier
        (⌊log2 n⌋ bucket), merge the two smallest of that tier.  Returns
        the number of merges performed."""
        merges = 0
        while True:
            tiers: Dict[int, List[int]] = {}
            for si, seg in enumerate(self.segments):
                tiers.setdefault(max(seg.n, 1).bit_length(), []).append(si)
            crowded = [idxs for idxs in tiers.values() if len(idxs) >= 2]
            if not crowded:
                return merges
            idxs = min(crowded, key=lambda g: min(self.segments[s].n
                                                  for s in g))
            pair = sorted(idxs, key=lambda s: self.segments[s].n)[:2]
            self.merge(pair[0], pair[1])
            merges += 1

    def compact(self, i: Optional[int] = None,
                min_dead_frac: float = 0.0) -> int:
        """Rebuild segment ``i`` (or every segment when None) without its
        tombstoned rows; fully dead segments are removed outright.
        ``min_dead_frac`` skips segments whose dead fraction is at or
        below the threshold.  Returns the number of segments rebuilt or
        removed."""
        targets = range(len(self.segments)) if i is None else [i]
        out: List[Optional[Segment]] = list(self.segments)
        done = 0
        for si in targets:
            seg = self.segments[si]
            dead = seg.n - seg.n_live
            if dead == 0 or (seg.n and dead / seg.n <= min_dead_frac):
                continue
            if seg.n_live == 0:
                out[si] = None
            else:
                sk, ids = seg.sketches[seg.live], seg.ids[seg.live]
                pay = (seg.payloads[seg.live]
                       if seg.payloads is not None else None)
                out[si] = Segment(index=self._build(sk),
                                  packed=pack_vertical(sk, self.b), ids=ids,
                                  live=np.ones(len(ids), bool), L=self.L,
                                  b=self.b, payloads=pay)
            done += 1
        self.segments = [s for s in out if s is not None]
        self.counters["compactions"] += done
        if done:
            self._emit("compact", segments=done)
            if self.store is not None:
                self.store.checkpoint(self)
        return done

    # -- queries ---------------------------------------------------------

    @staticmethod
    def _as_batch(qs) -> np.ndarray:
        qs = np.asarray(qs, dtype=np.uint8)
        return qs[None, :] if qs.ndim == 1 else qs

    def search_columns_batch(self, qs: np.ndarray, tau: int,
                             explain: bool = False) -> ColumnSearchResult:
        """Range search, column-compressed — the primary result contract:
        ``qs`` (m, L) uint8 -> ``ColumnSearchResult`` with (m, R)
        mask/dist planes over the physical columns plus the (R,)
        global-id labels.  One fused dispatch per capacity rung on the
        arena path.

        ``explain=True`` returns ``(ColumnSearchResult, QueryExplain)``:
        the identical planes plus the per-rung pruning record."""
        qs = self._as_batch(qs)
        if explain:
            rec = self._explain_recorder()
            dist, col_ids, overflow = rec.columns(qs, int(tau))
            res = ColumnSearchResult(mask=dist <= tau, dist=dist,
                                     ids=col_ids, overflow=overflow)
            return res, rec.finish(
                op="search", backend=self.backend, n_queries=qs.shape[0],
                n_live=self.n_live, k=None, tau0=int(tau),
                tau_final=int(tau), rerank=None)
        dist, col_ids, overflow = self._columns(qs, int(tau))
        return ColumnSearchResult(mask=dist <= tau, dist=dist, ids=col_ids,
                                  overflow=overflow)

    def search_columns(self, q: np.ndarray, tau: int) -> ColumnSearchResult:
        """Single-query ``search_columns_batch`` (m=1 planes squeezed)."""
        res = self.search_columns_batch(np.asarray(q)[None], tau)
        return ColumnSearchResult(mask=res.mask[0], dist=res.dist[0],
                                  ids=res.ids, overflow=res.overflow)

    def search_batch(self, qs: np.ndarray, tau: int,
                     explain: bool = False) -> SegmentedSearchResult:
        """Range search on the opt-in dense contract: (m, L) queries ->
        (m, n_ids) mask and exact-distance planes over every id ever
        assigned (BIG off-mask and on dead ids).

        ``explain=True`` returns ``(SegmentedSearchResult,
        QueryExplain)``: the identical planes plus the pruning record."""
        qs = self._as_batch(qs)
        if explain:
            rec = self._explain_recorder()
            plane, overflow = self._search_planes(
                qs, int(tau), columns_fn=rec.columns)
            res = SegmentedSearchResult(mask=plane <= tau, dist=plane,
                                        overflow=overflow)
            return res, rec.finish(
                op="search", backend=self.backend, n_queries=qs.shape[0],
                n_live=self.n_live, k=None, tau0=int(tau),
                tau_final=int(tau), rerank=None)
        plane, overflow = self._search_planes(qs, int(tau))
        return SegmentedSearchResult(mask=plane <= tau, dist=plane,
                                     overflow=overflow)

    def search(self, q: np.ndarray, tau: int,
               explain: bool = False) -> SegmentedSearchResult:
        """Single-query ``search_batch`` (m=1 planes squeezed);
        ``explain=True`` appends the ``QueryExplain`` record."""
        out = self.search_batch(np.asarray(q)[None], tau, explain=explain)
        res, ex = out if explain else (out, None)
        res = SegmentedSearchResult(mask=res.mask[0], dist=res.dist[0],
                                    overflow=res.overflow)
        return (res, ex) if explain else res

    def topk_batch(self, qs: np.ndarray, k: int,
                   tau0: Optional[int] = None, *,
                   rerank: Optional[str] = None,
                   q_payloads: Optional[np.ndarray] = None,
                   explain: bool = False) -> TopKResult:
        """Exact k-nearest neighbours over the live ids: (m, L) uint8
        queries -> (m, k) int32 global ids / int32 exact distances,
        ascending by (distance, id); (-1, BIG) pads past the live count.
        The fused path runs one program per τ rung with the selection on
        the device; the reference fan-out (``use_arena=False``) selects
        on the host.  Both give the same bits.

        ``rerank`` ("jaccard" / "cosine" / "containment") switches on
        the two-stage contract: the final-τ survivor plane stays on the
        device and ONE more dispatch scores the survivors' payload
        bitmaps exactly against ``q_payloads`` ((m, Wp) uint32) and
        selects the k largest (score, -id) — ``TopKResult.scores``
        carries the scores, ids/dists follow score order, pads are
        (-1, BIG, -1.0).  Requires ``payload_words``.

        ``explain=True`` returns ``(TopKResult, QueryExplain)``: a
        bit-identical result plus the per-rung pruning record.  Explain
        serves through the shared ladder over the same column planes (the
        path ``use_arena=False`` selects with), plus one frontier-width
        launch per rung."""
        qs = self._as_batch(qs)
        if explain:
            return self._explain_topk(qs, int(k), tau0, rerank, q_payloads)
        if rerank is not None:
            q_pay = self._check_rerank(rerank, q_payloads, qs.shape[0])
            if self.use_arena:
                return self._fused_topk_rerank(qs, int(k), tau0, rerank,
                                               q_pay)
            return self._rerank_ladder(qs, int(k), tau0, rerank, q_pay)
        if q_payloads is not None:
            raise ValueError("q_payloads supplied without rerank=")
        if self.use_arena:
            return self._fused_topk(qs, int(k), tau0)
        return _ladder_topk(self._search_columns, self.n_live, self.b,
                            self.L, qs, k, tau0, self.device)

    def topk(self, q: np.ndarray, k: int,
             tau0: Optional[int] = None, *,
             rerank: Optional[str] = None,
             q_payloads: Optional[np.ndarray] = None,
             explain: bool = False) -> TopKResult:
        """Single-query ``topk_batch`` (row 0); ``explain=True`` appends
        the ``QueryExplain`` record."""
        qp = None
        if q_payloads is not None:
            qp = np.asarray(q_payloads, np.uint32)
            if qp.ndim == 1:
                qp = qp[None, :]
        out = self.topk_batch(np.asarray(q)[None], k, tau0=tau0,
                              rerank=rerank, q_payloads=qp, explain=explain)
        res, ex = out if explain else (out, None)
        res = TopKResult(ids=res.ids[0], dists=res.dists[0], tau=res.tau,
                         overflow=res.overflow,
                         scores=(None if res.scores is None
                                 else res.scores[0]))
        return (res, ex) if explain else res

    def cost_hint(self, op: str, *, k: Optional[int] = None,
                  tau: Optional[int] = None, rows: int = 1) -> float:
        """Cost-model estimate of one request against the current corpus
        (paper Appendix A, Eq. 2) — the admission controller's currency.
        ``op``:

          * ``"topk"``   — cost of the τ ladder seeded by
            ``tau_for_k(b, L, n, k)``;
          * ``"search"`` — cost at the fixed ``tau``;
          * ``"write"``  — ``rows`` delta appends / tombstone flips,
            priced as τ=0 probes.

        Pure host arithmetic, monotone in k/τ/rows, never raises."""
        n = max(float(self.n_live), 1.0)
        if op == "write":
            return max(float(rows), 1.0) \
                * max(cost_single(self.b, self.L, 0, n), 1e-6)
        if op == "search":
            t = min(max(int(tau) if tau is not None else 0, 0), self.L)
        else:
            t = tau_for_k(self.b, self.L, n,
                          max(int(k) if k is not None else 1, 1))
        return max(cost_single(self.b, self.L, t, n), 1e-6)

    # -- accounting ------------------------------------------------------

    @property
    def n_live(self) -> int:
        """Live (inserted minus deleted) ids across delta + segments."""
        return int(self._delta_live.sum()) + sum(
            seg.n_live for seg in self.segments)

    @property
    def tombstones(self) -> int:
        """Dead rows still physically held (reclaimable by merge/compact)
        across the delta buffer and every segment."""
        dead_delta = int((~self._delta_live).sum())
        return dead_delta + sum(seg.n - seg.n_live for seg in self.segments)

    def __len__(self) -> int:
        return self.n_live

    def space_ledger(self) -> Dict[str, int]:
        """The space ledger:

        ``model_bits``   — per-segment index bits + tombstone bitmaps,
          plus the per-row lanes of the dynamic machinery (9 bytes per
          sealed column on the arena path) and the delta verify planes at
          their power-of-two bucket size.
        ``device_bytes`` — resident device arrays: the column store or
          arena, the materialized delta planes, the payload planes and
          every segment's static index.
        ``host_bytes``   — resident host arrays: packed sealed sketches,
          id/liveness lanes, payload rows and raw delta rows.
        """
        model = 0
        r_sealed = 0
        for seg in self.segments:
            model += int(seg.index.model_bits()) + tombstone_bits(seg.n)
            r_sealed += seg.n
        nd = len(self._delta_ids)
        W = n_words(self.L)
        if nd:
            model += bucket_m(nd) * self.b * W * 32 + tombstone_bits(nd)
        if r_sealed and self.use_arena and self.backend == "bst":
            model += r_sealed * (4 + 4 + 1) * 8   # base_idx/gids/live lanes
        device = 0
        host = 0
        ar = self._arena
        if ar is not None:
            device += ar.array_bytes()
            host += ar.host_bytes()
        for t in (self._delta_vert, self._delta_pay_vert):
            if t is not None:
                device += t.numel() * t.element_size()
        if self._pay_arena is not None:
            device += self._pay_arena.array_bytes()
        for seg in self.segments:
            device += int(seg.index.array_bytes())
            host += int(seg.packed.nbytes + seg.ids.nbytes
                        + seg.live.nbytes)
            if seg.payloads is not None:
                host += int(seg.payloads.nbytes)
        host += int(self._delta_sk.nbytes + self._delta_ids.nbytes
                    + self._delta_live.nbytes)
        if self._delta_pay is not None:
            host += int(self._delta_pay.nbytes)
        return {"model_bits": model, "device_bytes": device,
                "host_bytes": host}

    def space_bits(self) -> int:
        """Model-space accounting — ``space_ledger()['model_bits']``."""
        return self.space_ledger()["model_bits"]

    def stats(self) -> Dict[str, object]:
        """Lifecycle counters, per-segment occupancy, and the space
        ledger."""
        led = self.space_ledger()
        ar = self._arena
        return {
            "n_ids": self.n_ids, "n_live": self.n_live,
            "tombstones": self.tombstones,
            "delta_rows": int(len(self._delta_ids)),
            "delta_live": int(self._delta_live.sum()),
            "n_segments": len(self.segments),
            "segments": [(seg.n, seg.n_live) for seg in self.segments],
            "space_bits": led["model_bits"],
            "device_bytes": led["device_bytes"],
            "host_bytes": led["host_bytes"],
            "arena_bytes": ar.array_bytes() if ar is not None else 0,
            "tier": (ar.tier_summary() if ar is not None else
                     {"hot_blocks": 0, "cold_blocks": 0, "hot_bytes": 0,
                      "cold_bytes": 0}),
            **self.counters,
        }

    # -- internals -------------------------------------------------------

    def _replay_insert(self, ids: np.ndarray, sk: np.ndarray,
                       payloads: Optional[np.ndarray] = None) -> None:
        """Recovery-only: append rows with *preassigned* ids to the delta
        buffer.  No WAL logging and no auto-flush — the store runs the
        maintenance fixpoint once replay completes, so the recovered
        partition matches a never-crashed index."""
        sk = np.asarray(sk, np.uint8)
        ids = np.asarray(ids, np.int64)
        self._delta_sk = np.concatenate([self._delta_sk, sk])
        self._delta_ids = np.concatenate([self._delta_ids, ids])
        self._delta_live = np.concatenate(
            [self._delta_live, np.ones(len(ids), bool)])
        self._delta_vert = None
        if self._delta_pay is not None:
            if payloads is None:
                raise ValueError("replay of a payload index requires the "
                                 "records' payload bitmaps")
            self._delta_pay = np.concatenate(
                [self._delta_pay, np.asarray(payloads, np.uint32)])
            self._delta_pay_vert = None
        if ids.size:
            self.n_ids = max(self.n_ids, int(ids.max()) + 1)

    def _build(self, sk: np.ndarray):
        if self.backend == "multi":
            return build_multi_index(sk, self.b, self.mi_blocks, self.lam,
                                     device=self.device)
        if self.backend == "sharded":
            return build_sharded_bst(sk, self.b,
                                     max(1, min(self.n_shards, len(sk))),
                                     self.lam, device=self.device)
        return build_bst(sk, self.b, self.lam, device=self.device)

    def _q_tensor(self, qs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(qs.astype(np.int32)).to(self.device)

    def _delta_planes(self) -> torch.Tensor:
        """(b, W, ndb) int32 delta-buffer verify planes, the row axis
        padded up to the power-of-two bucket ``ndb = bucket_m(nd)`` with
        zero columns that every caller masks dead — the column layout of
        the JAX package's bucketed scan, so that ``dist[:, :r_sealed +
        nd]`` slices the same columns."""
        if self._delta_vert is None:
            nd = len(self._delta_ids)
            ndb = bucket_m(nd)
            vert = np.zeros((self.b, n_words(self.L), ndb), np.uint32)
            vert[..., :nd] = np.transpose(pack_vertical(self._delta_sk,
                                                        self.b), (1, 2, 0))
            self._delta_vert = as_words(vert, self.device)
        return self._delta_vert

    def _delta_pay_planes(self) -> torch.Tensor:
        """(Wp, ndb) int32 delta-buffer payload plane, bucketed like
        ``_delta_planes`` (zero columns past nd: the survivor mask
        already kills them)."""
        if self._delta_pay_vert is None:
            nd = len(self._delta_ids)
            vert = np.zeros((self.payload_words, bucket_m(nd)), np.uint32)
            vert[:, :nd] = self._delta_pay.T
            self._delta_pay_vert = as_words(vert, self.device)
        return self._delta_pay_vert

    def _search_columns(self, qs: np.ndarray, tau: int
                        ) -> Tuple[torch.Tensor, np.ndarray, int]:
        """Per-segment reference fan-out: (m, L) queries -> ((m, R) int32
        distances over the physical columns — BIG on non-results, (R,)
        int64 global id per column, total overflow).  Every segment
        contributes exact distances within τ through its cached batch
        searcher; the delta buffer a brute-force scan clamped to the same
        τ.  One dispatch per segment plus one for the delta buffer."""
        m = qs.shape[0]
        dists: List[torch.Tensor] = []
        col_ids: List[np.ndarray] = []
        overflow = 0
        qs_t = self._q_tensor(qs)
        for seg in self.segments:
            if seg.live.any():
                with _obs_span("segment_fanout", cat="device",
                               serial=seg.serial, tau=tau):
                    dist, ov = self._search_segment(seg, qs_t, tau)
                overflow += ov
            else:
                dist = torch.full((m, seg.n), BIG_I, dtype=torch.int32,
                                  device=self.device)
            dists.append(dist)
            col_ids.append(seg.ids)
        nd = len(self._delta_ids)
        if nd:
            q_vert = ops.to_lane_major(pack_vertical_torch(qs_t, self.b))
            _dispatch("fanout")
            with _obs_span("delta_scan", cat="device", rows=nd):
                d = ops.hamming_distances(self._delta_planes(),
                                          q_vert)[:, :nd]
            live = torch.from_numpy(self._delta_live).to(self.device)
            dists.append(torch.where(live[None, :] & (d <= tau), d, BIG_I))
            col_ids.append(self._delta_ids)
        if not dists:
            return (torch.zeros((m, 0), dtype=torch.int32,
                                device=self.device),
                    np.zeros((0,), np.int64), 0)
        return torch.cat(dists, dim=1), np.concatenate(col_ids), overflow

    def _search_planes(self, qs: np.ndarray, tau: int,
                       columns_fn=None) -> Tuple[torch.Tensor, int]:
        """(m, L) queries -> ((m, n_ids) int32 distance plane over every
        id ever assigned, BIG on non-results; total overflow): the column
        planes scattered onto the global-id axis.  ``columns_fn``
        overrides the column source (the explain path's recorder)."""
        if columns_fn is None:
            columns_fn = self._columns
        dist, col_ids, overflow = columns_fn(qs, tau)
        plane = torch.full((qs.shape[0], self.n_ids), BIG_I,
                           dtype=torch.int32, device=self.device)
        plane[:, torch.from_numpy(col_ids).to(self.device)] = dist
        return plane, overflow

    def _columns(self, qs: np.ndarray,
                 tau: int) -> Tuple[torch.Tensor, np.ndarray, int]:
        """Route to the fused path or the per-segment reference fan-out
        (identical contracts, bit-identical results)."""
        if self.use_arena:
            return self._fused_columns(qs, tau)
        return self._search_columns(qs, tau)

    # -- query explain ---------------------------------------------------

    def _explain_recorder(self) -> _ExplainRecorder:
        """Frontier widths are sampled on the bst backend only (the multi
        and sharded traversals have no single per-level frontier)."""
        return _ExplainRecorder(self._columns, self._frontier_widths)

    def _explain_topk(self, qs: np.ndarray, k: int, tau0: Optional[int],
                      rerank: Optional[str], q_payloads):
        """The explain-mode kNN: the shared τ ladder over this index's
        column planes, each rung recorded.  Its ladder schedule,
        planes and selections are those the serving paths are
        bit-identical to (``_ladder_topk`` against ``_fused_topk``,
        ``_ladder_topk_rerank`` against ``_fused_topk_rerank``), so the
        result is the ``explain=False`` one."""
        rec = self._explain_recorder()
        columns_fn = rec.columns
        if rerank is not None:
            q_pay = self._check_rerank(rerank, q_payloads, qs.shape[0])
            res = _ladder_topk_rerank(
                columns_fn, self._payload_rows, self.n_live, self.b,
                self.L, self.block_m, qs, k, tau0, rerank, q_pay,
                self.device)
        else:
            if q_payloads is not None:
                raise ValueError("q_payloads supplied without rerank=")
            res = _ladder_topk(columns_fn, self.n_live, self.b, self.L,
                               qs, k, tau0, self.device)
        return res, rec.finish(
            op="topk", backend=self.backend, n_queries=qs.shape[0],
            n_live=self.n_live, k=int(k),
            tau0=None if tau0 is None else int(tau0),
            tau_final=int(res.tau), rerank=rerank)

    def _frontier_widths(self, qs: np.ndarray,
                         tau: int) -> Optional[List[List[int]]]:
        """Per-query, per-trie-level live frontier widths at this τ,
        summed across the segment stack ((m, L); levels past a segment's
        collapse depth ℓ_s contribute nothing).  Explain only, bst backend
        only: one extra program run, outside the dispatch ledger."""
        if self.backend != "bst" or not self.segments:
            return None
        m = qs.shape[0]
        qs_t = self._q_tensor(qs)
        mb = bucket_m(m)
        if mb != m:
            qs_t = _pad_rows(qs_t, mb)
        return self._widths_fn(int(tau))(qs_t)[:m].tolist()

    def _widths_fn(self, tau: int):
        """The frontier-width program, cached beside the fused programs
        (same ``_fused_id`` scope, so the stale-generation purge of
        ``_fused_fn`` drops it too)."""
        key = (self.backend, self.layout, self._fused_id,
               self._seg_serials(), "widths", tau, self.block_m)
        fn = _fused_lookup(key)
        if fn is None:
            fn = self._build_widths(tau)
            _fused_insert(key, fn)
        return fn

    def _build_widths(self, tau: int):
        """Every segment's frontier descent with the per-level width
        taps, summed into an (m, L) plane (the traversal arithmetic of
        the fused programs' first half)."""
        _note_trace()
        stack = [(seg.index, frontier_capacities(seg.index.t, self.b, tau,
                                                 CAP_MAX_DEFAULT))
                 for seg in self.segments]
        L = self.L

        def run(qs):
            per_level = torch.zeros((qs.shape[0], L), dtype=torch.int32,
                                    device=qs.device)
            for ix, caps in stack:
                widths: List[torch.Tensor] = []
                _traverse_frontier_batch(ix, qs, tau=tau, caps=caps,
                                         level_widths=widths)
                if widths:
                    w = torch.stack(widths, dim=-1)        # (m, depth_s)
                    per_level[:, :w.shape[-1]] += w
            return per_level
        return run

    def _search_segment(self, seg: Segment, qs_t: torch.Tensor,
                        tau: int) -> Tuple[torch.Tensor, int]:
        """One segment, the whole batch -> ((m, n_seg) int32 exact local
        distances — BIG off-mask and on tombstones, overflow): the
        backend's cached searcher with the tombstone bitmap, on the
        doubled capacity ladder until exact."""
        live_t = torch.from_numpy(seg.live).to(self.device)
        if self.backend == "multi":
            _dispatch("fanout")
            res = mi_search_batch(seg.index, qs_t, tau, block_m=self.block_m,
                                  id_live=live_t)
            return res.dist, int(res.overflow.sum())
        if self.backend == "sharded":
            idx = seg.index
            cap = _LADDER_START["sharded"]
            while True:
                # keyed on the segment serial, never id(): a merged-away
                # segment can never alias a live one's searcher
                fn, _ = _pin_cache_get(
                    _SHARDED_SEARCHER_CACHE, _SHARDED_SEARCHER_CACHE_CAP,
                    (seg.serial, tau, cap), idx,
                    lambda: make_sharded_searcher(idx, tau, cap_max=cap))
                _dispatch("fanout")
                _, dists, ov = fn(qs_t)
                ov = int(ov)
                if ov == 0 or cap >= LADDER_CAP_MAX:
                    break
                cap *= 2
            m = dists.shape[0]
            merged = dists.reshape(m, -1).index_select(1, idx.merge_idx)
            return torch.where(live_t[None, :], merged, BIG_I), ov
        cap = CAP_MAX_DEFAULT
        while True:
            fn = get_searcher(seg.index, tau, cap, batch=True,
                              block_m=self.block_m, with_live=True)
            _dispatch("fanout")
            res = fn(qs_t, live_t)
            ov = int(res.overflow.sum())
            if ov == 0 or cap >= LADDER_CAP_MAX:
                return res.dist, ov
            cap *= 2

    # -- fused path --------------------------------------------------------

    def _seg_serials(self) -> Tuple[int, ...]:
        return tuple(seg.serial for seg in self.segments)

    def _refresh_arena(self) -> _ColumnArena:
        """Bring the full-length column arena up to date with the segment
        stack: a flush *appends* the new segment's columns and lanes, a
        merge or compact (a non-monotone change of the serial
        fingerprint) rebuilds it."""
        serials = self._seg_serials()
        ar = self._arena
        if isinstance(ar, _ColumnArena) and ar.serials == serials:
            return ar
        incremental = (isinstance(ar, _ColumnArena) and ar.cols is not None
                       and len(serials) > len(ar.serials)
                       and serials[:len(ar.serials)] == ar.serials)
        if not incremental:
            ar = _ColumnArena()
        new_segs = self.segments[len(ar.serials):]
        dev = self.device
        cols, idx, gid, live, cid = [], [], [], [], []
        col0 = ar.n_cols
        root0 = 1 + ar.t_root_total          # slot 0: delta's trivial base
        for seg in new_segs:
            tail = seg.index.tail
            cols.append(as_words(np.transpose(seg.packed, (1, 2, 0)), dev))
            idx.append(root0 + tail.leaf_root.index_select(
                0, seg.index.id_leaf.long()))
            gid.append(torch.from_numpy(seg.ids.astype(np.int32)).to(dev))
            live.append(torch.from_numpy(seg.live.copy()).to(dev))
            cid.append(seg.ids)
            ar.col_off[seg.serial] = col0
            ar.root_off[seg.serial] = root0
            col0 += seg.n
            root0 += int(tail.t_root)
        if ar.cols is None:
            W = n_words(self.L)
            ar.cols = torch.zeros((self.b, W, 0), dtype=torch.int32,
                                  device=dev)
            ar.base_idx = torch.zeros((0,), dtype=torch.int32, device=dev)
            ar.gids = torch.zeros((0,), dtype=torch.int32, device=dev)
            ar.live = torch.zeros((0,), dtype=torch.bool, device=dev)
        if new_segs:
            ar.cols = torch.cat([ar.cols] + cols, dim=-1)
            ar.base_idx = torch.cat([ar.base_idx] + idx)
            ar.gids = torch.cat([ar.gids] + gid)
            ar.live = torch.cat([ar.live] + live)
            ar.col_ids = np.concatenate([ar.col_ids] + cid)
        ar.t_root_total = root0 - 1
        ar.serials = serials
        self._arena = ar
        return ar

    def _refresh_store(self) -> ColumnStore:
        """Bring the suffix ``ColumnStore`` up to date with the segment
        stack — the same discipline as ``_refresh_arena``: a flush
        appends one block, a merge/compact rebuilds."""
        serials = self._seg_serials()
        st = self._arena
        if isinstance(st, ColumnStore) and st.serials == serials:
            return st
        incremental = (isinstance(st, ColumnStore)
                       and len(serials) > len(st.serials)
                       and serials[:len(st.serials)] == st.serials)
        if not incremental:
            st = ColumnStore(self.L, self.b, hot_bytes=self.hot_bytes,
                             payload_words=self.payload_words,
                             device=self.device)
        for seg in self.segments[len(st.serials):]:
            st.append_segment(seg)
        st.seal(serials)
        self._arena = st
        return st

    def _suffix_store(self) -> bool:
        return self.backend == "bst" and self.layout == "suffix"

    def _cache_get(self, key: tuple, build):
        """The fused-program cache with the searcher cache's counters."""
        fn = _fused_lookup(key)
        if fn is None:
            fn = build()
            _note_trace()
            _fused_insert(key, fn)
            _count_cache("misses")
        else:
            _count_cache("hits")
        return fn

    def _fused_fn(self, kind: str, tau: int, rung: int, kk: Optional[int]):
        """Fetch (or build) the fused program for this segment stack:
        ``kind="cols"`` -> ((mb, R) int32 dist plane, overflow);
        ``kind="dist"`` -> (dist plane, min survivors, overflow);
        ``kind="topk"`` -> ((mb, kk) ids, (mb, kk) dists, min survivors,
        overflow) with the selection on the device."""
        serials = self._seg_serials()
        gen = self._refresh_store().gen if self._suffix_store() else 0
        if (serials, gen) != self._fused_stamp:
            # the stack changed generation: this index's programs keyed on
            # the old fingerprint are unreachable (serials are monotonic)
            # — drop them now so they do not pin dead column copies
            with _CACHE_LOCK:
                for stale in [k for k in _FUSED_CACHE
                              if k[2] == self._fused_id]:
                    del _FUSED_CACHE[stale]
            self._fused_stamp = (serials, gen)
        key = (self.backend, self.layout, self._fused_id, serials, gen,
               kind, tau, rung, kk, self.block_m)
        build = {"bst": (self._build_fused_bst_suffix if self._suffix_store()
                         else self._build_fused_bst),
                 "multi": self._build_fused_multi,
                 "sharded": self._build_fused_sharded}[self.backend]
        return self._cache_get(key, lambda: build(kind, tau, rung, kk))

    def _stack_constants(self, tau: int, rung: int):
        """The fused programs' traversal constants: each segment's index,
        its frontier capacities at this (τ, capacity rung), and its
        ℓ_s-root count."""
        cap = CAP_MAX_DEFAULT << rung
        return [(seg.index, frontier_capacities(seg.index.t, self.b, tau, cap),
                 int(seg.index.tail.t_root)) for seg in self.segments]

    @staticmethod
    def _finish(kind: str, dist: torch.Tensor, overflow: torch.Tensor,
                labels, kk: Optional[int]):
        """The fused programs' common tail: the (m, R) dist plane for
        "cols", plus the ladder scalar for "dist", or the on-device
        (distance, id) selection for "topk"."""
        ov = overflow.sum()
        if kind == "cols":
            return dist, ov
        min_surv = (dist < BIG).sum(dim=1).min()
        if kind == "dist":
            return dist, min_surv, ov
        sel_ids, sel_d = select_topk_columns(dist, labels(), kk)
        return sel_ids, sel_d, min_surv, ov

    def _build_fused_bst(self, kind: str, tau: int, rung: int,
                         kk: Optional[int]):
        """The full-layout program: every segment's traversal, a 0/BIG
        reach scatter onto one root plane, the arena verify kernel over
        the sealed + delta full-length columns, and the selection."""
        arena = self._refresh_arena()
        stack = self._stack_constants(tau, rung)
        cols0, idx0, gids0 = arena.cols, arena.base_idx, arena.gids
        b_, block_m = self.b, self.block_m

        def run(qs, live_sealed, delta_vert, delta_live, delta_gids):
            base_plane, overflow = _root_plane(stack, qs, tau, False)
            ndb = delta_vert.shape[-1]
            cols = torch.cat([cols0, delta_vert], dim=-1)
            live = torch.cat([live_sealed, delta_live])
            base_idx = torch.cat([idx0, torch.zeros(
                (ndb,), dtype=torch.int32, device=qs.device)])
            q_vert = ops.to_lane_major(pack_vertical_torch(qs, b_))
            hm, dist = ops.sparse_verify_arena(
                cols, q_vert, base_plane, base_idx, live, tau=tau,
                block_m=block_m)
            dist = torch.where(hm > 0, dist, BIG_I)
            return self._finish(kind, dist, overflow,
                                lambda: torch.cat([gids0, delta_gids]), kk)
        return run

    def _build_fused_bst_suffix(self, kind: str, tau: int, rung: int,
                                kk: Optional[int]):
        """The suffix-layout program: the same traversal, ONE root plane
        carrying exact prefix distances, one verify launch per geometry
        group (packed words, or plane columns when b·S > 32), the
        full-length delta scan, and the selection.  Hot columns are
        closure constants; a group's cold columns arrive as a staging
        slab (``ColumnStore.stage``) that takes their places in the
        group's stack order, and the stream waits for the slab's copies
        only right before the group's verify.  The groups' columns come
        back in group order; a static inverse permutation restores stack
        order (on which the selection's tie order depends) where the
        groups interleave."""
        store = self._refresh_store()
        plan = store.plan()
        stack = self._stack_constants(tau, rung)
        gids0 = store.gids
        b_, L, block_m = self.b, self.L, self.block_m
        perms = [torch.from_numpy(g.perm).to(self.device) for g in plan]
        inv = _stack_inverse(plan, self.device)

        def run(qs, live_sealed, staged, delta_vert, delta_live,
                delta_gids):
            base_plane, overflow = _root_plane(stack, qs, tau, True)
            parts: List[torch.Tensor] = []
            for g, perm, slab in zip(plan, perms, staged):
                live_g = live_sealed[perm]
                S = g.geom.suffix_len
                cols = store.assemble(g, slab)
                if g.geom.packed:
                    qw = pack_suffix_words_torch(qs[:, L - S:], b_)
                    hm, d = ops.sparse_verify_arena_packed(
                        cols, qw, base_plane, g.base_idx, live_g,
                        b=b_, S=S, tau=tau, block_m=block_m)
                else:
                    qv = ops.to_lane_major(pack_vertical_torch(qs[:, L - S:],
                                                               b_))
                    hm, d = ops.sparse_verify_arena(
                        cols, qv, base_plane, g.base_idx, live_g,
                        tau=tau, block_m=block_m)
                parts.append(torch.where(hm > 0, d, BIG_I))
            sealed = (torch.cat(parts, dim=1) if parts else torch.zeros(
                (qs.shape[0], 0), dtype=torch.int32, device=qs.device))
            if inv is not None:
                sealed = sealed.index_select(1, inv)
            # the delta buffer scans full-length (its rows have no trie,
            # hence no ℓ_s to slice at); its columns come last in both
            # orders
            dist = torch.cat([sealed, self._delta_scan(qs, delta_vert,
                                                       delta_live, tau)],
                             dim=1)
            return self._finish(kind, dist, overflow,
                                lambda: torch.cat([gids0, delta_gids]), kk)
        return run

    def _delta_scan(self, qs: torch.Tensor, delta_vert: torch.Tensor,
                    delta_live: torch.Tensor, tau: int) -> torch.Tensor:
        """The delta buffer's full-length brute scan (the scan kernel),
        clamped to τ and liveness: (m, ndb) int32, BIG off.  An empty
        buffer launches nothing."""
        if not delta_vert.shape[-1]:
            return torch.zeros((qs.shape[0], 0), dtype=torch.int32,
                               device=qs.device)
        q_vert = ops.to_lane_major(pack_vertical_torch(qs, self.b))
        dd = ops.hamming_distances(delta_vert, q_vert)
        return torch.where(delta_live[None, :] & (dd <= tau), dd, BIG_I)

    def _build_fused_multi(self, kind: str, tau: int, rung: int,
                           kk: Optional[int]):
        """The program for MI segments: each segment's batched MI search
        (per-block traversals, then ONE batched candidate-verify launch
        for all queries).  The candidate capacity doubles per rung with
        the frontier caps."""
        cap_max = _LADDER_START["multi"] << rung
        block_m = self.block_m

        def segment(mi):
            caps_pb, cc = mi_trace_params(mi, tau, cap_max)
            cc = min(cc << rung, mi.n)
            return lambda qs, live: mi_column_dists(
                mi, qs, tau, caps_pb, cc, block_m=block_m, id_live=live)
        return self._build_fused_columns(
            kind, tau, kk, [segment(seg.index) for seg in self.segments])

    def _build_fused_sharded(self, kind: str, tau: int, rung: int,
                             kk: Optional[int]):
        """The program for sharded-bST segments: each segment's per-shard
        traversals and ONE shard-batched verify launch, merged onto its
        global columns on the device (``sharded_column_dists``)."""
        cap = _LADDER_START["sharded"] << rung
        block_m = self.block_m

        def segment(idx):
            t_host = idx.t.cpu().numpy()
            caps = frontier_capacities(
                tuple(int(x) for x in t_host.max(axis=0)), self.b, tau, cap)
            return lambda qs, live: sharded_column_dists(
                idx, qs, tau, caps, block_m=block_m, live=live,
                t_host=t_host)
        return self._build_fused_columns(
            kind, tau, kk, [segment(seg.index) for seg in self.segments])

    def _build_fused_columns(self, kind: str, tau: int, kk: Optional[int],
                             seg_fns):
        """The multi and sharded programs' body: every segment's (m,
        n_seg) column distances (``seg_fns``: fn(qs, live) -> (dist,
        overflow)), the delta scan through the scan kernel, and the
        shared tail."""
        gids0 = self._sealed_gids()

        def run(qs, seg_lives, delta_vert, delta_live, delta_gids):
            dists: List[torch.Tensor] = []
            overflow = torch.zeros((), dtype=torch.int64, device=qs.device)
            for fn, live in zip(seg_fns, seg_lives):
                d, o = fn(qs, live)
                dists.append(d)
                overflow += o.sum()
            dists.append(self._delta_scan(qs, delta_vert, delta_live, tau))
            return self._finish(kind, torch.cat(dists, dim=1), overflow,
                                lambda: torch.cat([gids0, delta_gids]), kk)
        return run

    def _sealed_gids(self) -> torch.Tensor:
        """(R,) int32 global id per sealed column, stack order, on the
        device (the multi and sharded programs' selection labels)."""
        if not self.segments:
            return torch.zeros((0,), dtype=torch.int32, device=self.device)
        return torch.from_numpy(np.concatenate(
            [seg.ids for seg in self.segments]).astype(np.int32)).to(
                self.device)

    def _fused_saturated(self, rung: int) -> bool:
        if (_LADDER_START[self.backend] << rung) < LADDER_CAP_MAX:
            return False
        if self.backend == "multi":
            # the candidate caps floor at 1024 and double per rung beside
            # the frontier caps (mi_search_batch's ladder)
            return all((1024 << rung) >= seg.index.n
                       for seg in self.segments)
        return True

    def _delta_args(self):
        """(delta_vert, delta_live, delta_gids) bucketed to ``ndb``: the
        live and gid lanes are zero (dead, label 0) past nd."""
        nd = len(self._delta_ids)
        if nd:
            delta_vert = self._delta_planes()
            ndb = delta_vert.shape[-1]
        else:
            delta_vert = torch.zeros((self.b, n_words(self.L), 0),
                                     dtype=torch.int32, device=self.device)
            ndb = 0
        delta_live = np.zeros(ndb, bool)
        delta_live[:nd] = self._delta_live
        delta_gids = np.zeros(ndb, np.int32)
        delta_gids[:nd] = self._delta_ids.astype(np.int32)
        return (delta_vert, torch.from_numpy(delta_live).to(self.device),
                torch.from_numpy(delta_gids).to(self.device))

    def _fused_call(self, kind: str, qs: np.ndarray, tau: int,
                    kk: Optional[int] = None, before_dispatch=None):
        """Dispatch ONE fused program per capacity rung: pads the query
        axis to its power-of-two bucket by repeating the last row (the
        overflow sums over the padded bucket, as in the JAX package),
        assembles the bucketed delta args, and escalates the
        frontier-capacity rung until the traversal is exact.
        ``before_dispatch`` runs once the call's uploads and staging are
        queued, before the first rung's dispatch."""
        m = qs.shape[0]
        mb = bucket_m(m)
        qs_t = self._q_tensor(qs)
        if mb != m:
            qs_t = _pad_rows(qs_t, mb)
        delta = self._delta_args()
        if self._suffix_store():
            store = self._refresh_store()
            # copy-ahead: the cold blocks' slabs are staged ONCE per query,
            # before the rung loop; the copies overlap the first rung's
            # traversal, and capacity retries reuse the same slabs.  The
            # query's own uploads go first: queued behind a staging copy
            # on the copy engine, one would hold up the stream.
            args = (store.live, store.stage()) + delta
        elif self.backend == "bst":
            args = (self._refresh_arena().live,) + delta
        else:
            args = (tuple(torch.from_numpy(seg.live).to(self.device)
                          for seg in self.segments),) + delta
        if before_dispatch is not None:
            before_dispatch()
        rung = 0
        while True:
            # the span covers the fetch or build, the dispatch and the
            # steering scalar's read (the sync where device time surfaces)
            with _obs_span("rung_dispatch", cat="device", kind=kind,
                           tau=tau, rung=rung):
                fn = self._fused_fn(kind, tau, rung, kk)
                _dispatch("fused")
                out = fn(qs_t, *args)
                done = int(out[-1]) == 0 or self._fused_saturated(rung)
            if done:
                return out
            rung += 1

    def _fused_columns(self, qs: np.ndarray, tau: int
                       ) -> Tuple[torch.Tensor, np.ndarray, int]:
        """Fused-path ``_search_columns``: the same ((m, R) dist, (R,)
        ids, overflow) contract, one dispatch per capacity rung."""
        m = qs.shape[0]
        r_sealed = sum(seg.n for seg in self.segments)
        nd = len(self._delta_ids)
        if r_sealed + nd == 0:
            return (torch.zeros((m, 0), dtype=torch.int32,
                                device=self.device),
                    np.zeros((0,), np.int64), 0)
        dist, ov = self._fused_call("cols", qs, tau)
        col_ids = np.concatenate([seg.ids for seg in self.segments]
                                 + [self._delta_ids])
        return dist[:m, :r_sealed + nd], col_ids, int(ov)

    def _fused_topk(self, qs: np.ndarray, k: int,
                    tau0: Optional[int]) -> TopKResult:
        """The fused τ ladder: each rung is one program whose selection
        already ran on the device; the host reads two scalars (min
        survivor count, overflow) to steer the ladder."""
        m = qs.shape[0]
        n_live = self.n_live
        if n_live == 0:
            return _empty_topk(m, k, self.device)
        kk = min(int(k), n_live)
        tau = tau0 if tau0 is not None else tau_for_k(self.b, self.L,
                                                      n_live, kk)
        tau = min(max(int(tau), 0), self.L)
        while True:
            ids, dists, min_surv, ov = self._fused_call("topk", qs, tau,
                                                        kk=kk)
            if int(min_surv) >= kk or tau >= self.L:
                break
            tau = min(self.L, max(tau + 1, 2 * tau))
        with _obs_span("topk_readback", cat="device", k=int(k)):
            dists, ids = _pad_topk(dists[:m], ids[:m], int(k))
        return TopKResult(ids=ids, dists=dists, tau=tau, overflow=int(ov))

    # -- exact re-rank ---------------------------------------------------

    def _check_rerank(self, metric: str, q_payloads,
                      m: int) -> np.ndarray:
        """Validate the two-stage request: known metric, payload-bearing
        index, (m, Wp) uint32 query bitmaps."""
        if metric not in RERANK_METRICS:
            raise ValueError(f"rerank must be one of {RERANK_METRICS}")
        if self.payload_words is None:
            raise ValueError(
                "rerank requires an index built with payload_words")
        if q_payloads is None:
            raise ValueError("rerank requires q_payloads — the queries' "
                             "(m, Wp) uint32 set bitmaps")
        qp = np.asarray(q_payloads, np.uint32)
        if qp.ndim == 1:
            qp = qp[None, :]
        if qp.shape != (m, self.payload_words):
            raise ValueError(f"q_payloads shape {qp.shape} != "
                             f"({m}, {self.payload_words})")
        return qp

    def _payload_rows(self) -> np.ndarray:
        """(R, Wp) uint32 host payload rows in global column order (every
        segment's rows in stack order, then the delta buffer's)."""
        parts = [seg.payloads for seg in self.segments]
        if len(self._delta_ids):
            parts.append(self._delta_pay)
        if not parts:
            return np.zeros((0, self.payload_words), np.uint32)
        return np.concatenate(parts, axis=0)

    def _rerank_ladder(self, qs: np.ndarray, k: int, tau0: Optional[int],
                       metric: str, q_pay: np.ndarray) -> TopKResult:
        """Reference two-stage path (``use_arena=False``): the fan-out
        ladder finds the final-τ survivor plane, then ONE
        ``_rerank_select`` scores and selects."""
        return _ladder_topk_rerank(
            self._search_columns, self._payload_rows, self.n_live, self.b,
            self.L, self.block_m, qs, k, tau0, metric, q_pay, self.device)

    def _rerank_fn(self, metric: str, kk: int):
        """Fetch (or build) the stage-2 program for this stack — the same
        cache and fingerprint as ``_fused_fn`` (whose stale-generation
        purge also drops stale re-rank programs)."""
        serials = self._seg_serials()
        gen = self._refresh_store().gen if self._suffix_store() else 0
        key = (self.backend, self.layout, self._fused_id, serials, gen,
               "rerank", metric, 0, kk, self.block_m)
        return self._cache_get(key, lambda: self._build_rerank(metric, kk))

    def _build_rerank(self, metric: str, kk: int):
        """The stage-2 program: the (Wp, R) payload plane in global column
        order (the hot payloads ordered once, here; a cold group's staged
        payloads and the delta's bucketed plane appended per call), the
        exact re-rank kernel over the stage-1 survivors, and the (score
        desc, id asc) selection — the dist plane never leaves the device
        between the stages."""
        block_m = self.block_m
        if self._suffix_store():
            store = self._refresh_store()
            plan = store.plan()
            gids0 = store.gids
            # the inverse permutation the dist program applies: payload
            # columns land in dist order
            inv = _stack_inverse(plan, self.device)
            empty = torch.zeros((self.payload_words, 0), dtype=torch.int32,
                                device=self.device)

            def sealed_pays(staged_pays):
                pays = (torch.cat([store.assemble(g, slab, payloads=True)
                                   for g, slab in zip(plan, staged_pays)],
                                  dim=-1) if plan else empty)
                return pays if inv is None else pays.index_select(1, inv)
            all_hot = not any(g.cold_blocks for g in plan)
            pays0 = sealed_pays((None,) * len(plan)) if all_hot else None

            def run(dist, q_pay, staged_pays, delta_pay, delta_gids):
                sealed = pays0 if pays0 is not None else sealed_pays(
                    staged_pays)
                pays = torch.cat([sealed, delta_pay], dim=-1)
                col_ids = torch.cat([gids0, delta_gids])
                return _rerank_select(dist, pays, q_pay, col_ids,
                                      metric=metric, kk=kk, block_m=block_m)
            return run
        if self._pay_arena is None:
            self._pay_arena = _PayloadArena(self.payload_words, self.device)
        pays0 = self._pay_arena.refresh(self.segments, self._seg_serials())
        gids0 = (self._refresh_arena().gids if self.backend == "bst"
                 else self._sealed_gids())

        def run(dist, q_pay, delta_pay, delta_gids):
            pays = torch.cat([pays0, delta_pay], dim=-1)
            col_ids = torch.cat([gids0, delta_gids])
            return _rerank_select(dist, pays, q_pay, col_ids, metric=metric,
                                  kk=kk, block_m=block_m)
        return run

    def _fused_topk_rerank(self, qs: np.ndarray, k: int,
                           tau0: Optional[int], metric: str,
                           q_pay: np.ndarray) -> TopKResult:
        """The fused two-stage ladder: stage 1 runs the kind="dist" fused
        program per τ rung (the survivor plane stays on the device; only
        the two ladder scalars cross), then stage 2 is ONE re-rank
        dispatch for the whole request.  Cold blocks' payloads are staged
        once, behind stage 1's first uploads, so that their copy overlaps
        its traversal."""
        m = qs.shape[0]
        n_live = self.n_live
        if n_live == 0:
            return _empty_topk_rerank(m, int(k), self.device)
        staged: List[tuple] = []

        def stage_payloads():
            if self._suffix_store() and not staged:
                staged.append(self._refresh_store().stage_payloads())
        kk = min(int(k), n_live)
        tau = tau0 if tau0 is not None else tau_for_k(self.b, self.L,
                                                      n_live, kk)
        tau = min(max(int(tau), 0), self.L)
        while True:
            dist, min_surv, ov = self._fused_call(
                "dist", qs, tau, before_dispatch=stage_payloads)
            if int(min_surv) >= kk or tau >= self.L:
                break
            tau = min(self.L, max(tau + 1, 2 * tau))
        qp = np.zeros((dist.shape[0], self.payload_words), np.uint32)
        qp[:m] = q_pay
        if len(self._delta_ids):
            delta_pay = self._delta_pay_planes()
        else:
            delta_pay = torch.zeros((self.payload_words, 0),
                                    dtype=torch.int32, device=self.device)
        delta_gids = self._delta_args()[2]
        fn = self._rerank_fn(metric, kk)
        _dispatch("rerank")
        with _obs_span("rerank", cat="device", metric=metric, kk=kk):
            ids, dists, scores = fn(dist, as_words(qp.T, self.device),
                                    *staged, delta_pay, delta_gids)
            ids, dists, scores = _pad_topk_scores(ids[:m], dists[:m],
                                                  scores[:m], int(k))
        return TopKResult(ids=ids, dists=dists, tau=tau, overflow=int(ov),
                          scores=scores)


class ShardedSegmentedIndex:
    """S independent segment stacks, one per shard — the dynamic analogue
    of ``build_sharded_bst``'s layout: inserts go round-robin across the
    shards (global id ``i`` to shard ``i % S``, local id ``i // S``),
    deletes route by id, and queries fan out over every shard's stack
    before the shared shard-merge selection.  A merge touches 1/S of the
    data.  ``hot_bytes`` splits evenly across the stacks.

    Same result contract as ``SegmentedIndex`` (global-id planes,
    ``TopKResult`` with global ids).  Durability: the top level journals
    one global-id record per write; the shard stacks bind with
    ``log_writes=False`` and only snapshot their own segments.
    """

    def __init__(self, L: int, b: int, n_shards: int = 4, *,
                 delta_cap: int = 4096, backend: str = "bst",
                 lam: float = 0.5, auto_merge: bool = True,
                 block_m: int = DEFAULT_BLOCK_M, use_arena: bool = True,
                 layout: str = "suffix", hot_bytes: Optional[int] = None,
                 payload_words: Optional[int] = None, device="cuda"):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.device = resolve_device(device)
        self.L, self.b = int(L), int(b)
        self.n_shards = int(n_shards)
        self.block_m = int(block_m)
        self.payload_words = (None if payload_words is None
                              else int(payload_words))
        per_stack = (None if hot_bytes is None
                     else max(0, int(hot_bytes) // self.n_shards))
        self.shards = [
            SegmentedIndex(L, b, delta_cap=delta_cap, backend=backend,
                           lam=lam, auto_merge=auto_merge, block_m=block_m,
                           use_arena=use_arena, layout=layout,
                           hot_bytes=per_stack,
                           payload_words=self.payload_words,
                           device=self.device)
            for _ in range(self.n_shards)]
        self.n_ids = 0
        # global id -> shard is `id % S`; per-shard local ids are dense,
        # so global id maps to local position `id // S`.
        self.store: Optional[object] = None

    def insert(self, sketches: np.ndarray,
               payloads: Optional[np.ndarray] = None) -> np.ndarray:
        """Round-robin insert; returns (k,) int64 global ids.  With
        ``payload_words`` set, ``payloads`` carries the rows' (k, Wp)
        uint32 set bitmaps, routed with their rows."""
        sk = np.asarray(sketches, dtype=np.uint8)
        if sk.ndim == 1:
            sk = sk[None, :]
        k = sk.shape[0]
        pay = self.shards[0]._check_payloads(payloads, k)
        new_ids = np.arange(self.n_ids, self.n_ids + k, dtype=np.int64)
        if self.store is not None and k:
            # one global-id WAL record
            self.store.log_insert(new_ids, sk, payloads=pay)
            # scope the routing: a shard's auto-flush checkpoint mid-way
            # through must not let the store truncate the WAL (or seal
            # sibling stacks past this record) before every shard has
            # applied its rows
            self.store.begin_write()
        try:
            for s in range(self.n_shards):
                rows = np.flatnonzero(new_ids % self.n_shards == s)
                if rows.size:
                    self.shards[s].insert(
                        sk[rows],
                        payloads=pay[rows] if pay is not None else None)
        finally:
            if self.store is not None and k:
                self.store.end_write()
        self.n_ids += k
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone global ids; returns the number newly deleted."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        ids = ids[(ids >= 0) & (ids < self.n_ids)]
        if self.store is not None and ids.size:
            self.store.log_delete(ids)
        newly = 0
        for s in range(self.n_shards):
            mine = ids[ids % self.n_shards == s]
            if mine.size:
                newly += self.shards[s].delete(mine // self.n_shards)
        return newly

    def flush(self) -> None:
        for shard in self.shards:
            shard.flush()

    def merge(self) -> int:
        """Size-tiered merge inside every shard's stack; returns the
        merges performed."""
        return sum(shard.maybe_merge() for shard in self.shards)

    def compact(self, min_dead_frac: float = 0.0) -> int:
        return sum(shard.compact(min_dead_frac=min_dead_frac)
                   for shard in self.shards)

    @property
    def n_live(self) -> int:
        return sum(shard.n_live for shard in self.shards)

    def __len__(self) -> int:
        return self.n_live

    def space_bits(self) -> int:
        return sum(shard.space_bits() for shard in self.shards)

    def cost_hint(self, op: str, *, k: Optional[int] = None,
                  tau: Optional[int] = None, rows: int = 1) -> float:
        """Sum of the per-stack cost hints (every stack answers every
        read; writes split their rows round-robin)."""
        per_rows = max(rows // len(self.shards), 1) if op == "write" \
            else rows
        return sum(s.cost_hint(op, k=k, tau=tau, rows=per_rows)
                   for s in self.shards)

    @property
    def tombstones(self) -> int:
        return sum(shard.tombstones for shard in self.shards)

    def space_ledger(self) -> Dict[str, int]:
        led = {"model_bits": 0, "device_bytes": 0, "host_bytes": 0}
        for shard in self.shards:
            for k, v in shard.space_ledger().items():
                led[k] += v
        return led

    def stats(self) -> Dict[str, object]:
        led = self.space_ledger()
        return {"n_ids": self.n_ids, "n_live": self.n_live,
                "tombstones": self.tombstones,
                "n_segments": sum(len(s.segments) for s in self.shards),
                "arena_bytes": sum(
                    s._arena.array_bytes() if s._arena is not None else 0
                    for s in self.shards),
                "device_bytes": led["device_bytes"],
                "host_bytes": led["host_bytes"],
                "shards": [shard.stats() for shard in self.shards]}

    def _search_columns(self, qs: np.ndarray, tau: int
                        ) -> Tuple[torch.Tensor, np.ndarray, int]:
        """Column-compressed fan-out over every shard's stack, local
        column ids relabelled to global (``gid = local * S + s``).  Each
        stack answers through its own fused program (one dispatch per
        shard per rung)."""
        dists: List[torch.Tensor] = []
        col_ids: List[np.ndarray] = []
        overflow = 0
        for s, shard in enumerate(self.shards):
            dist, local_ids, ov = shard._columns(qs, tau)
            dists.append(dist)
            col_ids.append(local_ids * self.n_shards + s)
            overflow += ov
        return torch.cat(dists, dim=1), np.concatenate(col_ids), overflow

    def _global_plane(self, qs: np.ndarray, tau: int,
                      columns_fn=None) -> Tuple[torch.Tensor, int]:
        dist, col_ids, overflow = (columns_fn or self._search_columns)(qs,
                                                                       tau)
        plane = torch.full((qs.shape[0], self.n_ids), BIG_I,
                           dtype=torch.int32, device=self.device)
        plane[:, torch.from_numpy(col_ids).to(self.device)] = dist
        return plane, overflow

    def search_batch(self, qs: np.ndarray, tau: int,
                     explain: bool = False) -> SegmentedSearchResult:
        """(m, L) uint8 queries -> global (m, n_ids) mask/dist planes.
        ``explain=True`` appends the ``QueryExplain`` record."""
        qs = SegmentedIndex._as_batch(qs)
        rec = _ExplainRecorder(self._search_columns) if explain else None
        plane, overflow = self._global_plane(
            qs, int(tau), rec.columns if explain else None)
        res = SegmentedSearchResult(mask=plane <= tau, dist=plane,
                                    overflow=overflow)
        if not explain:
            return res
        return res, rec.finish(
            op="search", backend="sharded-stacks", n_queries=qs.shape[0],
            n_live=self.n_live, k=None, tau0=int(tau), tau_final=int(tau),
            rerank=None)

    def search(self, q: np.ndarray, tau: int,
               explain: bool = False) -> SegmentedSearchResult:
        out = self.search_batch(np.asarray(q)[None], tau, explain=explain)
        res, ex = out if explain else (out, None)
        res = SegmentedSearchResult(mask=res.mask[0], dist=res.dist[0],
                                    overflow=res.overflow)
        return (res, ex) if explain else res

    def _payload_rows(self) -> np.ndarray:
        """(R, Wp) uint32 payload rows in the global column order of
        ``_search_columns`` (shard 0's columns, then shard 1's, ...)."""
        return np.concatenate([shard._payload_rows() for shard in self.shards],
                              axis=0)

    def topk_batch(self, qs: np.ndarray, k: int,
                   tau0: Optional[int] = None, *,
                   rerank: Optional[str] = None,
                   q_payloads: Optional[np.ndarray] = None,
                   explain: bool = False) -> TopKResult:
        """Exact global kNN: the per-shard fan-out on one shared τ ladder
        (the contract of ``SegmentedIndex.topk_batch``, the two-stage
        ``rerank=`` included: stage 2 is ONE re-rank dispatch over the
        merged survivor plane).  ``explain=True`` appends the
        ``QueryExplain`` record (bit-identical result)."""
        qs = SegmentedIndex._as_batch(qs)
        rec = _ExplainRecorder(self._search_columns) if explain else None
        columns_fn = rec.columns if explain else self._search_columns
        if rerank is not None:
            q_pay = self.shards[0]._check_rerank(rerank, q_payloads,
                                                 qs.shape[0])
            res = _ladder_topk_rerank(
                columns_fn, self._payload_rows, self.n_live, self.b, self.L,
                self.block_m, qs, k, tau0, rerank, q_pay, self.device)
        else:
            if q_payloads is not None:
                raise ValueError("q_payloads supplied without rerank=")
            res = _ladder_topk(columns_fn, self.n_live, self.b, self.L, qs,
                               k, tau0, self.device)
        if not explain:
            return res
        return res, rec.finish(
            op="topk", backend="sharded-stacks", n_queries=qs.shape[0],
            n_live=self.n_live, k=int(k),
            tau0=None if tau0 is None else int(tau0),
            tau_final=int(res.tau), rerank=rerank)

    def topk(self, q: np.ndarray, k: int,
             tau0: Optional[int] = None, *,
             rerank: Optional[str] = None,
             q_payloads: Optional[np.ndarray] = None,
             explain: bool = False) -> TopKResult:
        qp = None
        if q_payloads is not None:
            qp = np.asarray(q_payloads, np.uint32)
            if qp.ndim == 1:
                qp = qp[None, :]
        out = self.topk_batch(np.asarray(q)[None], k, tau0=tau0,
                              rerank=rerank, q_payloads=qp, explain=explain)
        res, ex = out if explain else (out, None)
        res = TopKResult(ids=res.ids[0], dists=res.dists[0], tau=res.tau,
                         overflow=res.overflow,
                         scores=(None if res.scores is None
                                 else res.scores[0]))
        return (res, ex) if explain else res
