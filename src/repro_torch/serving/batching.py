"""Shape-bucket micro-batching helpers (DESIGN.md §5) — the port of
``repro.serving.batching``.

The scheduler coalesces queued single-query requests into
**power-of-two shape buckets**: a group of g queries is padded up to
``bucket_m(g)`` rows (repeating the last real query — a real sketch can
never overflow a frontier harder than the rows already present) and the
result planes are sliced back to g rows.  The port's programs are eager
closures keyed without the batch size, so the buckets cost no builds
here; they keep every dispatch at the JAX package's padded shapes, the
shapes the kernels and the launch counts were measured at.

``bucket_m`` itself lives in ``repro_torch.core.search`` (the core
batched searchers apply the same bucketing internally); this module adds
the host-side padding/slicing used by the scheduler and the bucket table
used for capacity planning.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.search import bucket_m

__all__ = ["bucket_m", "bucket_table", "pad_to_bucket", "slice_rows"]


def bucket_table(max_batch: int) -> List[int]:
    """The ascending power-of-two buckets a scheduler with this
    ``max_batch`` can dispatch: 1, 2, 4, ..., bucket_m(max_batch).

    >>> bucket_table(6)
    [1, 2, 4, 8]
    """
    out, b = [], 1
    top = bucket_m(max_batch)
    while b <= top:
        out.append(b)
        b *= 2
    return out


def pad_to_bucket(qs: np.ndarray) -> np.ndarray:
    """(g, L) queries -> (bucket_m(g), L): pad rows repeat the last real
    query so pad traffic behaves like real traffic (no pathological
    frontier blow-up, no extra ladder rungs)."""
    qs = np.asarray(qs)
    g = qs.shape[0]
    bucket = bucket_m(g)
    if bucket == g:
        return qs
    pad = np.broadcast_to(qs[-1:], (bucket - g,) + qs.shape[1:])
    return np.concatenate([qs, pad], axis=0)


def slice_rows(arr, g: int):
    """Mask padded results back out: keep the first g rows."""
    return arr[:g]
