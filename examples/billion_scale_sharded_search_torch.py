"""The sharded bST on the PyTorch / CUDA port: split a sketch database
into shards that share one layer plan and padded array shapes, search
every shard for a query batch (one shard-batched verify launch on the
card), merge the results onto global ids, and project the space
accounting to the paper's billion-sketch SIFT setting.

    PYTHONPATH=src python examples/billion_scale_sharded_search_torch.py \\
        [--device cuda|cpu] [--n 200000]

``examples/billion_scale_sharded_search.py`` on the port.  On ``cuda``
the verify runs through the hand-written kernel, batched over the
shards; on ``cpu`` through its plain PyTorch version.
"""

import argparse
import time

import numpy as np

from repro_torch.configs.registry import PAPER_DATASETS
from repro_torch.core import (LinearScan, build_bst, build_sharded_bst,
                              gather_ids, gather_topk, make_sharded_searcher)
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args()
    cfg = PAPER_DATASETS["sift"]          # L=32, b=4 (1B sketches in paper)
    n, n_shards, tau, m = args.n, 8, 2, 16
    rng = np.random.default_rng(0)
    db = rng.integers(0, 1 << cfg.b, size=(n, cfg.L), dtype=np.uint8)
    queries = db[rng.integers(0, n, m)]

    print(f"building sharded bST on {args.device}: n={n}, shards={n_shards}")
    t0 = time.time()
    index = build_sharded_bst(db, cfg.b, n_shards, device=args.device)
    print(f"  built in {time.time() - t0:.1f}s; common plan: dense<= "
          f"{index.lm}, collapse at {index.ls}, kinds={index.kinds}")

    searcher = make_sharded_searcher(index, tau)
    ops.reset_kernel_stats()
    t0 = time.time()
    masks, shard_dists, overflow = searcher(queries)
    ids = gather_ids(index, masks)
    dt = time.time() - t0
    print(f"searched {m} queries in {dt:.2f}s (overflow {int(overflow)}); "
          f"hits: {[len(i) for i in ids]}; launches {ops.kernel_stats()}")

    # the distance planes merge into the global top-k with no second pass
    # (exact within tau; -1 pads where a query has < k hits in the ball)
    top_ids, top_d = gather_topk(index, shard_dists, k=3)
    print(f"top-3 of query 0: ids={top_ids[0]} dists={top_d[0]}")

    # correctness against the brute-force scan
    dists = LinearScan.build(db, cfg.b, device=args.device).distances(
        queries).cpu().numpy()
    for qi in range(m):
        assert set(ids[qi]) == set(np.flatnonzero(dists[qi] <= tau))
    print("brute-force check: OK")

    # billion-scale projection (paper Table IV: SI-bST 9.6 GiB on SIFT)
    single = build_bst(db[:50_000], cfg.b, device=args.device)
    bytes_per_sketch = single.model_bits() / 8 / 50_000
    proj = bytes_per_sketch * PAPER_DATASETS["sift"].n / 2**30
    print(f"space projection at n=10^9: {proj:.1f} GiB "
          f"({bytes_per_sketch:.1f} B/sketch; paper reports ~9.6 GiB)")


if __name__ == "__main__":
    main()
