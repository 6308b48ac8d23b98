"""Quickstart of the PyTorch / CUDA port: build a bST over b-bit sketches
and run similarity search.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

``examples/quickstart.py`` without the sketching step (b-bit minhash is
ported in a later slice): uniform 2-bit sketches from a numpy seed, the
succinct trie, range search at several thresholds, top-k, a brute-force
check and the space accounting (Table III's quantities).  On ``cuda`` the
verify and scan run through the hand-written kernels; on ``cpu`` through
their plain PyTorch versions.
"""

import argparse

import numpy as np

from repro_torch.core import (LinearScan, build_bst, build_louds,
                              make_batch_searcher, topk_batch)
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    # 1. b-bit sketches (uniform stand-ins for minhash sketches)
    n, L, b = args.n, 16, 2
    sketches = rng.integers(0, 1 << b, size=(n, L), dtype=np.uint8)
    print(f"{n} random {L}-dim {b}-bit sketches on {args.device}")

    # 2. build the succinct trie (paper §V)
    index = build_bst(sketches, b, device=args.device)
    louds = build_louds(sketches, b, device=args.device)
    print(f"bST layers: dense<= {index.lm}, collapse at {index.ls}, "
          f"kinds={index.kinds}")
    print(f"space: bST {index.model_bits() / 8 / 1024:.1f} KiB vs "
          f"LOUDS {louds.model_bits() / 8 / 1024:.1f} KiB "
          f"({louds.model_bits() / index.model_bits():.2f}x smaller)")

    # 3. search (paper Alg. 1, level-synchronous form)
    queries = sketches[:8]
    for tau in (1, 2, 3):
        res = make_batch_searcher(index, tau)(queries)
        hits = res.mask.sum(dim=1)
        print(f"tau={tau}: solutions per query {hits.tolist()} "
              f"(traversed ~{int(res.traversed.float().mean())} nodes "
              f"of {index.t[-1]} leaves)")

    # 4. top-k nearest neighbors (τ-escalation ladder + exact distances)
    nn = topk_batch(index, queries, k=3)
    print(f"top-3 of query 0: ids={nn.ids[0].tolist()} "
          f"dists={nn.dists[0].tolist()} (tau*={nn.tau})")

    # 5. verify against the brute-force scan
    dists = LinearScan.build(sketches, b, device=args.device).distances(queries)
    got = make_batch_searcher(index, 2)(queries).mask
    assert bool(((dists <= 2) == got).all())
    assert bool((nn.dists == dists.sort(dim=1).values[:, :3]).all())
    print(f"brute-force check: OK (kernel calls: {ops.kernel_stats()})")


if __name__ == "__main__":
    main()
