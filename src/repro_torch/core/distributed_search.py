"""Shard-merge selection over labeled distance planes.

This slice of the port carries only ``topk_from_dists``, the host-side
selection the segmented index's reference fan-out ladder runs on its
column-compressed planes; the sharded bST and its searchers come with
the other backends.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..kernels.ref import BIG


def topk_from_dists(dists: np.ndarray, k: int,
                    ids: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Select per-query top-k from merged distance planes.

    dists: (m, n) int32 — one distance per (query, column), BIG on
    non-results; ids: optional (n,) int global labels per column
    (default: the column index itself).  Returns ((m, k) int32 ids,
    (m, k) int32 dists), each row sorted ascending by (distance, label);
    slots beyond a query's real survivors are (-1, BIG) pads.
    """
    m, n = dists.shape
    kk = min(k, n)
    labels = np.arange(n, dtype=np.int64) if ids is None \
        else np.asarray(ids, dtype=np.int64)
    out_ids = np.full((m, k), -1, np.int32)
    out_d = np.full((m, k), int(BIG), np.int32)
    for qi in range(m):
        d = np.asarray(dists[qi])
        # partial selection, then a full (distance, label) sort over
        # every candidate at or below the k-th distance — a bare
        # argpartition would pick arbitrarily among ties at the boundary
        if kk < n:
            thresh = d[np.argpartition(d, kk - 1)[:kk]].max()
            cand = np.flatnonzero(d <= thresh)
        else:
            cand = np.arange(n)
        order = cand[np.lexsort((labels[cand], d[cand]))][:kk]
        real = d[order] < int(BIG)
        out_ids[qi, :kk] = np.where(real, labels[order], -1)
        out_d[qi, :kk] = d[order]
    return out_ids, out_d
