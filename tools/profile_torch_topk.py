"""Where the time of the port's ``topk_batch`` goes, on one GPU.

    python3 tools/profile_torch_topk.py [--seed 0] [--n 12886488] [--m 64]
                                        [--trace build/topk_trace.json]

Builds the cell of ``chip_smoke.py`` (the paper's Review geometry: L = 16,
b = 2, uniform sketches from ``--seed``; 64 queries, half of them
perturbed database rows), then:

  1. times each stage of one ``topk_batch`` rung with CUDA events —
     traversal, root-plane scatter, leaf gather, query packing, the
     verify kernel, the id gathers, the host syncs of the ladder and the
     top-k selection — beside the whole call (host clock, synchronised);
  2. runs ``torch.profiler`` over three calls and prints the device time
     by operator and the device's busy share of the window (the sum of
     kernel times over the wall time), and writes a Chrome trace.

Needs CUDA; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import build_bst, topk_batch  # noqa: E402
from repro_torch.core.cost_model import frontier_capacities  # noqa: E402
from repro_torch.core.hamming import pack_vertical_torch  # noqa: E402
from repro_torch.core.search import (CAP_MAX_DEFAULT,  # noqa: E402
                                     _traverse_frontier_batch,
                                     scatter_root_plane, select_topk_columns)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import BIG  # noqa: E402


def make_queries(sketches: np.ndarray, m: int, b: int, rng) -> np.ndarray:
    n, L = sketches.shape
    near = sketches[rng.integers(0, n, size=m // 2)].copy()
    for row in near:
        pos = rng.choice(L, size=rng.integers(0, 4), replace=False)
        row[pos] = (row[pos] + rng.integers(1, 1 << b, size=len(pos))) % (1 << b)
    far = rng.integers(0, 1 << b, size=(m - m // 2, L), dtype=np.uint8)
    return np.concatenate([near, far])


def staged(index, qs, tau, k):
    """One ladder rung of ``topk_batch``, stage by stage, with an event
    after each stage; returns [(stage, ms)]."""
    marks = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    marks[0][1].record()
    m = qs.shape[0]
    caps = frontier_capacities(index.t, index.b, tau, CAP_MAX_DEFAULT)
    ids, dists, valid, overflow, _ = _traverse_frontier_batch(
        index, qs, tau=tau, caps=caps)
    mark("traversal (levels 1..ls)")
    tail = index.tail
    base_root = scatter_root_plane(ids, dists, valid, m, tail.t_root)
    mark("root-plane scatter-min")
    base_leaf = base_root.index_select(1, tail.leaf_root)
    mark("leaf gather (m, t_L)")
    q_sfx = ops.to_lane_major(pack_vertical_torch(qs[:, index.ls:], index.b))
    mark("query suffix packing")
    hit, leaf_dist = ops.sparse_verify_batch(tail.paths_vert, q_sfx,
                                             base_leaf, tau=tau)
    mark("verify kernel")
    mask = (hit > 0).index_select(1, index.id_leaf)
    dist = torch.where(mask, leaf_dist.index_select(1, index.id_leaf), BIG)
    mark("id gathers (m, n)")
    int(overflow.sum())
    int(mask.sum(dim=1).min())
    mark("ladder host syncs")
    col = torch.arange(index.n, dtype=torch.int32, device=qs.device)
    select_topk_columns(dist, col, k)
    mark("top-k selection")
    torch.cuda.synchronize()
    return [(name, marks[i][1].elapsed_time(ev))
            for i, (name, ev) in enumerate(marks[1:])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=12_886_488)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--trace", default="build/topk_trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")

    rng = np.random.default_rng(args.seed)
    sketches = rng.integers(0, 4, size=(args.n, 16), dtype=np.uint8)
    index = build_bst(sketches, 2, device="cuda")
    qs = torch.from_numpy(make_queries(sketches, args.m, 2, rng)
                          .astype(np.int32)).cuda()
    top = topk_batch(index, qs, args.k)            # warm-up; fixes τ*
    torch.cuda.synchronize()
    print(f"n={args.n} m={args.m} k={args.k} lm={index.lm} ls={index.ls} "
          f"tau*={top.tau}")

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        topk_batch(index, qs, args.k)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    runs = [staged(index, qs, top.tau, args.k) for _ in range(5)]
    print(f"topk_batch wall: {statistics.median(walls):.2f} ms (median of 5)")
    total = 0.0
    for i, (name, _) in enumerate(runs[0]):
        ms = statistics.median(r[i][1] for r in runs)
        total += ms
        print(f"  {name:28s} {ms:9.3f} ms")
    print(f"  {'sum of stages':28s} {total:9.3f} ms")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            topk_batch(index, qs, args.k)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels only: an operator's row repeats its kernels' device time
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"profiler window {window_ms:.2f} ms for 3 calls; device kernel "
          f"time {dev_us / 1e3:.2f} ms; busy share "
          f"{dev_us / 1e3 / window_ms:.3f}" if dev_us else
          "profiler recorded no device time: busy share not measured")
    print(events.table(sort_by="self_device_time_total", row_limit=20,
                       max_name_column_width=60))
    Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.trace)
    print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
