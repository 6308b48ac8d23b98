"""Structured query-explain records (DESIGN.md §11).

``QueryExplain`` is what ``SegmentedIndex.topk/topk_batch/search(...,
explain=True)`` returns alongside the (bit-identical) result: the
paper's pruning behavior made measurable per request — which τ-ladder
rungs ran, how wide the trie frontier was per level, how many leaves
each rung pruned vs verified, what the re-rank pass kept, and which
process-level caches the request hit.

This module is pure data + formatting: the recording happens inside
``core.segments`` (which owns the counters being deltaed); nothing here
imports the core machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["RungExplain", "QueryExplain"]


@dataclasses.dataclass
class RungExplain:
    """One τ-ladder rung.

    Attributes:
      tau:         the rung's Hamming threshold.
      candidates:  physical columns the verify kernel swept (R — every
                   sealed row + the delta buffer; the denominator of
                   the pruning ratio).
      survivors:   per-query count of columns with an exact distance
                   (live, within τ) — the verified candidate set.
      pruned:      per-query ``candidates - survivors`` — leaves the
                   traversal + tombstone masking killed at this rung.
      overflow:    dropped frontier entries (0 = the rung was exact).
      dispatches:  device-launch delta of this rung, by kind
                   (``fused`` / ``fanout`` / ``rerank`` / ``total``).
      duration_ms: host wall-clock of the rung (dispatch + readback).
      frontier:    per-query list of per-trie-level live frontier
                   widths (bst backend only — None elsewhere; the
                   sampling launch is explain-only and never runs on
                   the serving path).
    """

    tau: int
    candidates: int
    survivors: List[int]
    pruned: List[int]
    overflow: int
    dispatches: Dict[str, int]
    duration_ms: float
    frontier: Optional[List[List[int]]] = None


@dataclasses.dataclass
class QueryExplain:
    """The per-request explain record (``explain=True``).

    Attributes:
      op:           "topk" | "search".
      backend:      "bst" | "multi" | "sharded" (ShardedSegmentedIndex
                    reports "sharded-stacks").
      n_queries:    batch rows explained (1 for ``topk``/``search``).
      n_live:       live ids at request time.
      k / tau0:     the request parameters (k None for range search).
      tau_final:    the ladder rung the request settled on.
      rungs:        one ``RungExplain`` per attempted rung, in order.
      rerank:       the stage-2 metric, or None.
      rerank_survivors: per-query stage-1 survivor counts entering the
                    exact re-rank plane (None without ``rerank=``).
      cache:        searcher/fused compiled-program cache delta for the
                    request: hits / misses / traces.
      dispatch:     total device-launch delta by kind.
      tier:         column-store staging delta (prefetches,
                    staged_bytes, ...).
      duration_ms:  end-to-end host wall-clock of the explained call.
      degraded:     overload-degradation stage that produced this
                    answer ("rerank_off" | "shrink_k" | "cheap_tau",
                    DESIGN.md §12), or None for a full answer.  Set by
                    the serving layer — the core never degrades.
    """

    op: str
    backend: str
    n_queries: int
    n_live: int
    k: Optional[int]
    tau0: Optional[int]
    tau_final: int
    rungs: List[RungExplain]
    rerank: Optional[str] = None
    rerank_survivors: Optional[List[int]] = None
    cache: Dict[str, int] = dataclasses.field(default_factory=dict)
    dispatch: Dict[str, int] = dataclasses.field(default_factory=dict)
    tier: Dict[str, int] = dataclasses.field(default_factory=dict)
    duration_ms: float = 0.0
    degraded: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def candidates_verified(self) -> int:
        """Total (query, column) distance evaluations that survived
        pruning across every rung — the work the trie couldn't avoid."""
        return sum(sum(r.survivors) for r in self.rungs)

    def summary(self) -> str:
        """Human-readable multi-line digest.

        >>> ex = QueryExplain(op="topk", backend="bst", n_queries=1,
        ...                   n_live=8, k=2, tau0=None, tau_final=3,
        ...                   rungs=[RungExplain(tau=3, candidates=8,
        ...                       survivors=[4], pruned=[4], overflow=0,
        ...                       dispatches={"fused": 1},
        ...                       duration_ms=0.5)])
        >>> print(ex.summary())
        topk backend=bst queries=1 n_live=8 k=2 tau_final=3
          rung tau=3: candidates=8 survivors=4 pruned=4 overflow=0
        """
        head = (f"{self.op} backend={self.backend} "
                f"queries={self.n_queries} n_live={self.n_live}")
        if self.k is not None:
            head += f" k={self.k}"
        head += f" tau_final={self.tau_final}"
        lines = [head]
        for r in self.rungs:
            lines.append(
                f"  rung tau={r.tau}: candidates={r.candidates} "
                f"survivors={sum(r.survivors)} pruned={sum(r.pruned)} "
                f"overflow={r.overflow}")
            if r.frontier is not None:
                widths = [sum(col) for col in zip(*r.frontier)] \
                    if r.frontier else []
                lines.append("    frontier widths/level: "
                             + ",".join(str(w) for w in widths))
        if self.rerank is not None:
            lines.append(f"  rerank={self.rerank} "
                         f"survivors={self.rerank_survivors}")
        if self.degraded is not None:
            lines.append(f"  DEGRADED stage={self.degraded}")
        return "\n".join(lines)
