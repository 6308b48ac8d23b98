"""MI-bST: the multi-index approach with a bST as each block's inverted
index (paper §III-B, §VI-C).

The sketch is split into ``m`` disjoint blocks; block j gets its own bST
over the block *substrings* (deduplication within a block is what makes
the per-block tries small), searched at the pigeonhole threshold
τ^j = ⌊τ/m⌋.  A candidate is any id that survives in at least one block;
verification re-checks the full-length Hamming distance of the
compacted candidates (fixed capacity from the cost model, with the
overflow ladder on top).

The verify scores all m queries' compacted candidates in ONE launch of
the candidate verify kernel (``ops.hamming_distances_gather``), which
reads the (b, W, n) verify planes through the candidate ids and scores
only each query's valid prefix — where the JAX package gathers
``full_vert[:, :, ids]`` for every slot and vmaps ``hamming_distances``
over the query axis.

Every result is bit-identical to ``repro.core.multi_index``.  Torch runs
eagerly, so a "searcher" is a cached closure over (index, τ, caps,
candidate capacity).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import BIG
from . import cost_model
from .bst import SketchIndex, _index_from_iter, build_bst
from .hamming import as_words, pack_vertical, pack_vertical_torch, resolve_device
from .search import _compact_batch, _pin_cache_get, _search_trace_batch


class MultiSearchResult(NamedTuple):
    mask: torch.Tensor        # (n,) bool final solutions
    dist: torch.Tensor        # (n,) int32 — exact distance where mask, BIG off
    candidates: torch.Tensor  # int32 — |∪ C^j| before verification
    overflow: torch.Tensor    # int32 — frontier + candidate-capacity drops


@dataclasses.dataclass(frozen=True)
class MultiIndex:
    blocks: Tuple[SketchIndex, ...]
    full_vert: torch.Tensor          # (b, W, n) int32 — verification layout
    bounds: Tuple[Tuple[int, int], ...]
    L: int
    b: int
    n: int

    @property
    def device(self) -> torch.device:
        return self.full_vert.device

    def model_bits(self) -> int:
        return sum(blk.model_bits() for blk in self.blocks) \
            + self.full_vert.numel() * 32

    def array_bytes(self) -> int:
        return sum(blk.array_bytes() for blk in self.blocks) \
            + self.full_vert.numel() * self.full_vert.element_size()


def build_multi_index(sketches: np.ndarray, b: int, m: int,
                      lam: float = 0.5, device="cuda") -> MultiIndex:
    """MI-bST over ``m`` disjoint sketch blocks (paper §III-B).

    sketches: (n, L) uint8 over Σ=[0, 2^b); each of the m blocks gets its
    own bST over the block substrings, plus one (b, W, n) vertical copy
    of the full sketches for the verify kernel."""
    device = resolve_device(device)
    sketches = np.asarray(sketches, dtype=np.uint8)
    n, L = sketches.shape
    bounds = []
    blocks = []
    lo = 0
    for Lj in cost_model._block_lengths(L, m):
        hi = lo + Lj
        blocks.append(build_bst(sketches[:, lo:hi], b, lam, device=device))
        bounds.append((lo, hi))
        lo = hi
    planes = pack_vertical(sketches, b)                 # (n, b, W)
    return MultiIndex(blocks=tuple(blocks),
                      full_vert=as_words(np.transpose(planes, (1, 2, 0)),
                                         device),
                      bounds=tuple(bounds), L=L, b=b, n=n)


def multi_index_from_numpy(meta: dict, arrays: Sequence[np.ndarray],
                           device="cuda") -> MultiIndex:
    """Rebuild a ``MultiIndex`` from the JAX package's arrays.

    meta: ``L``, ``b``, ``n``, ``bounds`` and ``blocks``, one
    ``bst.index_from_numpy`` metadata dict per block; arrays: the JAX
    pytree's leaves in order — every block's leaves, then ``full_vert``."""
    device = resolve_device(device)
    it = iter(arrays)
    blocks = tuple(_index_from_iter(bm, it, device) for bm in meta["blocks"])
    full_vert = as_words(next(it), device)
    if next(it, None) is not None:
        raise ValueError("more arrays than the metadata describes")
    return MultiIndex(blocks=blocks, full_vert=full_vert,
                      bounds=tuple(tuple(bd) for bd in meta["bounds"]),
                      L=meta["L"], b=meta["b"], n=meta["n"])


def candidate_capacity(mi: MultiIndex, tau: int, safety: int = 8,
                       cap_max: int = 1 << 20) -> int:
    """Static capacity of the verification gather, from the Appendix-A
    candidate estimate |C^j| = sigs(b, L^j, τ^j)·n/(2^b)^{L^j}."""
    est = 1.0
    taus = cost_model.block_thresholds(tau, len(mi.blocks))
    for (lo, hi), tj in zip(mi.bounds, taus):
        Lj = hi - lo
        est += min(cost_model.sigs(mi.b, Lj, tj) * mi.n / float(1 << mi.b) ** Lj,
                   mi.n)
    return int(min(max(est * safety, 1024), min(cap_max, mi.n)))


def _mi_search_trace_batch(mi: MultiIndex, qs: torch.Tensor, *, tau: int,
                           caps_per_block, cand_cap: int,
                           block_m: int = ops.DEFAULT_BLOCK_M,
                           id_live: torch.Tensor | None = None
                           ) -> MultiSearchResult:
    """Batched MI search: every block runs the 2D-frontier batch search,
    the candidate sets compact per query, and one candidate verify launch
    scores each query against its own candidates through their ids.

    ``id_live``: optional (n,) bool tombstone mask — dead ids leave the
    candidate union *before* compaction, so they take neither candidate
    capacity nor verify bandwidth."""
    qs = qs.to(torch.int32)
    m, n, dev = qs.shape[0], mi.n, qs.device
    taus = cost_model.block_thresholds(tau, len(mi.blocks))
    cand_mask = torch.zeros((m, n), dtype=torch.bool, device=dev)
    overflow = torch.zeros((m,), dtype=torch.int32, device=dev)
    for blk, (lo, hi), tj, caps in zip(mi.blocks, mi.bounds, taus,
                                       caps_per_block):
        res = _search_trace_batch(blk, qs[:, lo:hi], tau=tj, caps=caps,
                                  block_m=block_m)
        cand_mask |= res.mask
        overflow += res.overflow
    if id_live is not None:
        cand_mask &= id_live[None, :]

    n_cand = cand_mask.sum(dim=1, dtype=torch.int32)
    all_ids = torch.arange(n, dtype=torch.int32, device=dev).expand(m, n)
    zeros = torch.zeros((), dtype=torch.int32, device=dev).expand(m, n)
    ids, _, cvalid, ov = _compact_batch(all_ids, zeros, cand_mask, cand_cap)
    overflow += ov
    C = ids.shape[1]
    q_planes = ops.to_lane_major(pack_vertical_torch(qs, mi.b))  # (b, W, m)
    dist = ops.hamming_distances_gather(mi.full_vert, q_planes, ids,
                                        n_cand.clamp(max=C))    # (m, C)
    ok = cvalid & (dist <= tau)
    # invalid candidate slots land in the spare column n, sliced off (the
    # reference's mode="drop" scatter)
    slot = torch.where(cvalid, ids, n).long()
    mask = torch.zeros((m, n + 1), dtype=torch.uint8, device=dev)
    mask.scatter_reduce_(1, slot, ok.to(torch.uint8), "amax",
                         include_self=True)
    dvec = torch.full((m, n + 1), BIG, dtype=torch.int32, device=dev)
    dvec.scatter_reduce_(1, slot, torch.where(ok, dist, BIG), "amin",
                         include_self=True)
    return MultiSearchResult(mask=mask[:, :n].bool(), dist=dvec[:, :n],
                             candidates=n_cand, overflow=overflow)


def _mi_search_trace(mi: MultiIndex, q: torch.Tensor, *, tau: int,
                     caps_per_block, cand_cap: int) -> MultiSearchResult:
    """Single-query MI search (``q``: (L,)): the m=1 row of the batched
    body, with scalar ``candidates``/``overflow``."""
    res = _mi_search_trace_batch(mi, q[None], tau=tau,
                                 caps_per_block=caps_per_block,
                                 cand_cap=cand_cap, block_m=1)
    return MultiSearchResult(*(x[0] for x in res))


def mi_trace_params(mi: MultiIndex, tau: int, cap_max: int = 1 << 17,
                    cand_cap: int | None = None):
    """The static parameters of one MI search: per-block frontier
    capacities and the candidate capacity (the Appendix-A estimate by
    default).  Shared by ``make_mi_searcher`` and the segmented index's
    fused program."""
    taus = cost_model.block_thresholds(tau, len(mi.blocks))
    caps_per_block = tuple(
        cost_model.frontier_capacities(blk.t, blk.b, tj, cap_max)
        for blk, tj in zip(mi.blocks, taus))
    cc = cand_cap if cand_cap is not None else candidate_capacity(mi, tau)
    return caps_per_block, cc


def mi_column_dists(mi: MultiIndex, qs: torch.Tensor, tau: int,
                    caps_per_block, cand_cap: int,
                    block_m: int = ops.DEFAULT_BLOCK_M,
                    id_live: torch.Tensor | None = None):
    """MI search reduced to the column contract: (m, L) queries -> ((m, n)
    int32 exact distances, BIG off-mask and on dead ids; (m,) int32
    overflow) — an MI segment's part of the fused segmented program."""
    res = _mi_search_trace_batch(mi, qs, tau=tau,
                                 caps_per_block=caps_per_block,
                                 cand_cap=cand_cap, block_m=block_m,
                                 id_live=id_live)
    return res.dist, res.overflow


# Searchers pin their MultiIndex in the value, so that the id key can
# never be recycled while the entry lives; FIFO-bounded.
_MI_SEARCHER_CACHE: dict = {}
_MI_SEARCHER_CACHE_CAP = 128


def clear_mi_searcher_cache() -> None:
    """Drop every cached MI searcher (and the MultiIndex pins with them)."""
    _MI_SEARCHER_CACHE.clear()


def _as_queries(mi: MultiIndex, qs) -> torch.Tensor:
    if not torch.is_tensor(qs):
        qs = torch.from_numpy(np.asarray(qs).astype(np.int32))
    return qs.to(device=mi.device, dtype=torch.int32)


def make_mi_searcher(mi: MultiIndex, tau: int, cap_max: int = 1 << 17,
                     cand_cap: int | None = None, *, batch: bool = False,
                     block_m: int = ops.DEFAULT_BLOCK_M,
                     with_live: bool = False):
    """Cached MI searcher.  ``batch=False``: f(q (L,)); ``batch=True``:
    f(qs (m, L)) through the batched per-block searches (a leading query
    axis on every result field).  ``with_live=True`` (batch only) gives
    ``f(qs, id_live (n,) bool)``."""
    caps_per_block, cc = mi_trace_params(mi, tau, cap_max, cand_cap)
    key = (id(mi), tau, caps_per_block, cc, block_m if batch else None,
           with_live)

    def build():
        if batch:
            def run(qs, id_live=None):
                return _mi_search_trace_batch(
                    mi, _as_queries(mi, qs), tau=tau,
                    caps_per_block=caps_per_block, cand_cap=cc,
                    block_m=block_m, id_live=id_live)
        else:
            def run(q):
                return _mi_search_trace(mi, _as_queries(mi, q), tau=tau,
                                        caps_per_block=caps_per_block,
                                        cand_cap=cc)
        return run

    fn, _ = _pin_cache_get(_MI_SEARCHER_CACHE, _MI_SEARCHER_CACHE_CAP, key,
                           mi, build)
    return fn


def mi_search(mi: MultiIndex, q, tau: int) -> MultiSearchResult:
    """Host wrapper with the doubled overflow ladder: the m=1 row of
    ``mi_search_batch``.  ``q``: (L,) uint8 -> ``MultiSearchResult`` over
    the index's n ids."""
    res = mi_search_batch(mi, _as_queries(mi, q)[None], tau)
    return MultiSearchResult(*(x[0] for x in res))


def mi_search_batch(mi: MultiIndex, qs, tau: int,
                    block_m: int = ops.DEFAULT_BLOCK_M,
                    id_live=None) -> MultiSearchResult:
    """Batched ``mi_search``: (m, L) queries on one shared overflow ladder
    (the frontier cap from 2^15 and the candidate cap doubling up to n
    until every query is exact).  ``id_live``: optional (n,) bool
    tombstone mask — dead ids are excluded from candidates and results."""
    qs = _as_queries(mi, qs)
    live = None
    if id_live is not None:
        live = (id_live if torch.is_tensor(id_live)
                else torch.from_numpy(np.asarray(id_live, bool)))
        live = live.to(mi.device)
    cap_max, cand_cap = 1 << 15, candidate_capacity(mi, tau)
    while True:
        fn = make_mi_searcher(mi, tau, cap_max, cand_cap, batch=True,
                              block_m=block_m, with_live=live is not None)
        res = fn(qs, live)
        if int(res.overflow.sum()) == 0 or (cap_max >= 1 << 22
                                            and cand_cap >= mi.n):
            return res
        cap_max *= 2
        cand_cap = min(cand_cap * 2, mi.n)


def choose_plan(b: int, L: int, tau: int, n: int,
                ms: Tuple[int, ...] = (2, 3, 4)) -> Tuple[str, int]:
    """Cost-model planner: single- against multi-index and the block count
    (the paper: SI fastest for τ <= 4, MI competitive at 5)."""
    best = ("single", 1)
    best_cost = cost_model.cost_single(b, L, tau, n)
    for m in ms:
        c = cost_model.cost_multi(b, L, tau, n, m)
        if c < best_cost:
            best, best_cost = ("multi", m), c
    return best
