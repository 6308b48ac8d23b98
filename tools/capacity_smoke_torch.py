#!/usr/bin/env python3
"""Capacity smoke check on the PyTorch / CUDA port: ``tools/capacity_smoke.py``
through ``repro_torch.core.SegmentedIndex``.

Builds the same fixed corpus (the paper's review geometry, L=16, b=2)
under both sealed-column layouts and asserts the two deterministic
capacity claims of the tiered column store:

1. **Suffix beats full-length**: the packed suffix layout spends at
   most half the device column bytes of the full-length arena.
2. **Cold tier stays one-dispatch**: with a hot-tier budget of zero —
   a corpus strictly larger than the device budget — queries still
   answer bit-identically at the same fused launch count as the
   all-hot store, with zero per-segment fan-out.

These are byte and launch *counts*, deterministic on any runner, so the
script hard-fails on regression.

Usage: ``PYTHONPATH=src python tools/capacity_smoke_torch.py [n_rows]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import (SegmentedIndex, dispatch_stats,
                              reset_dispatch_stats)

L, B, SEGMENTS = 16, 2, 4


def build(n: int, device, **kw):
    rng = np.random.default_rng(42)
    db = rng.integers(0, 1 << B, size=(n, L), dtype=np.uint8)
    idx = SegmentedIndex(L, B, delta_cap=n + 1, auto_merge=False,
                         device=device, **kw)
    chunk = n // SEGMENTS
    for lo in range(0, SEGMENTS * chunk, chunk):
        idx.insert(db[lo:lo + chunk])
        idx.flush()
    return idx, db


def _same(a, b) -> None:
    np.testing.assert_array_equal(a.ids.cpu().numpy(), b.ids.cpu().numpy())
    np.testing.assert_array_equal(a.dists.cpu().numpy(),
                                  b.dists.cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    n, dev = args.n_rows, args.device
    k = 10

    suffix, db = build(n, dev, layout="suffix")
    full, _ = build(n, dev, layout="full")
    qs = db[:8]
    r_sfx = suffix.topk_batch(qs, k)
    _same(r_sfx, full.topk_batch(qs, k))
    sfx_bytes = suffix._refresh_store().col_bytes()
    full_bytes = full._refresh_arena().col_bytes()
    print(f"column bytes: suffix={sfx_bytes} full={full_bytes} "
          f"ratio={full_bytes / sfx_bytes:.2f}x "
          f"({sfx_bytes / n:.2f} vs {full_bytes / n:.2f} B/row) on {dev}")
    assert full_bytes >= 2 * sfx_bytes, \
        f"suffix layout must at least halve column bytes: " \
        f"{sfx_bytes} vs {full_bytes}"

    reset_dispatch_stats()
    suffix.topk_batch(qs, k)
    hot_disp = dispatch_stats()

    cold, _ = build(n, dev, layout="suffix", hot_bytes=0)
    _same(cold.topk_batch(qs, k), r_sfx)      # warm (stages the blocks)
    reset_dispatch_stats()
    cold.topk_batch(qs, k)
    cold_disp = dispatch_stats()
    tier = cold.stats()["tier"]
    print(f"cold tier: {tier}; dispatches hot={hot_disp} cold={cold_disp}")
    assert tier["hot_blocks"] == 0 and tier["cold_blocks"] == SEGMENTS, tier
    assert cold_disp["fanout"] == 0, cold_disp
    assert cold_disp["total"] == cold_disp["fused"] == hot_disp["fused"], \
        (hot_disp, cold_disp)
    print("capacity smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
