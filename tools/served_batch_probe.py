"""Where a served top-k batch's time goes at ``chip_smoke.py`` phase 11's
size, on one GPU.

    python3 tools/served_batch_probe.py [--seed 0]

Makes phase 11's corpus — the first SEG10_N (4,500,000) of
``chip_smoke.py``'s token sets (``token_corpus``: ``bbit_minhash`` L 16,
b 2 and ``pack_sets`` Wp 8 on the card, the rows phase 5 makes first;
its 64 queries are drawn over these rows) — ingests it into an in-memory
``SegmentedIndex(delta_cap=2^20)`` in chunks of 2^16 and deletes phase
10's 1%, then prints:

  * for batches of 64 database rows (phase 11's top-k traffic) and of
    64 queries drawn as phase 5 draws its own (perturbed database sets
    and fresh sets): the host ms of a synchronised ``topk_batch(k=10)``,
    its fused dispatches, and ``explain=True``'s rungs (τ, overflow,
    fewest survivors, host ms, dispatches);
  * the host ms of a call of m = 1, 8 and 64 database rows (3 calls
    after a warm-up);
  * phase 11's range batch, 16 queries at τ 2: the device call and the
    host copy of its two (16, n_ids) planes, each on the host clock;
  * one ``torch.profiler`` window of a 64-row batch: its device kernel
    time, busy share and heaviest kernels.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core import (SegmentedIndex, dispatch_stats,
                                  reset_dispatch_stats)
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    _build.load_library()
    sk, pay, qs, _, _ = cs.token_corpus(torch, args.seed, dev, cs.SEG10_N)
    n = len(sk)
    idx = SegmentedIndex(cs.REVIEW_L, cs.REVIEW_B, delta_cap=cs.DELTA_CAP,
                         payload_words=pay.shape[1], device="cuda")
    for lo in range(0, n, cs.RS_CHUNK):
        idx.insert(sk[lo:lo + cs.RS_CHUNK], payloads=pay[lo:lo + cs.RS_CHUNK])
    idx.delete(cs.seg10_dead(n))
    torch.cuda.synchronize()
    tq = sk[np.random.default_rng(args.seed + 11).choice(
        n, cs.RS_TOPK_REQ, replace=False)]
    print(f"{n} rows, segments {[s.n for s in idx.segments]}, delta rows "
          f"{len(idx._delta_ids)}", flush=True)

    for name, q in (("64 database rows", tq[:64]),
                    ("64 more database rows", tq[64:128]),
                    ("64 queries as phase 5 draws them", qs)):
        idx.topk_batch(q, cs.TOPK)
        torch.cuda.synchronize()
        reset_dispatch_stats()
        t0 = time.perf_counter()
        res = idx.topk_batch(q, cs.TOPK)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fused = dispatch_stats()["fused"]
        _, ex = idx.topk_batch(q, cs.TOPK, explain=True)
        rungs = [{"tau": g.tau, "overflow": g.overflow,
                  "fewest_survivors": min(g.survivors),
                  "ms": round(g.duration_ms, 2),
                  "fused": g.dispatches.get("fused", 0)} for g in ex.rungs]
        print(json.dumps({"batch": name, "ms": round(ms, 2),
                          "tau": res.tau, "fused": fused, "rungs": rungs}),
              flush=True)
    for m in (1, 8, 64):
        idx.topk_batch(tq[:m], cs.TOPK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            idx.topk_batch(tq[:m], cs.TOPK)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"top-{cs.TOPK} of m={m} database rows: {ms:.2f} ms a call, "
              f"{ms / m:.3f} ms a query", flush=True)
    q = qs[:cs.RS_RANGE_REQ]
    idx.search_batch(q, cs.RS_TAU)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = idx.search_batch(q, cs.RS_TAU)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mask, dist = res.mask.cpu().numpy(), res.dist.cpu().numpy()
    t2 = time.perf_counter()
    nbytes = mask.nbytes + dist.nbytes
    print(f"range batch of {len(q)} at tau {cs.RS_TAU}: device call "
          f"{(t1 - t0) * 1e3:.2f} ms, host copy of {nbytes} B "
          f"{(t2 - t1) * 1e3:.2f} ms ({nbytes / (t2 - t1) / 1e9:.2f} GB/s)",
          flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    idx.topk_batch(tq[:64], cs.TOPK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        idx.topk_batch(tq[:64], cs.TOPK)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"one 64-row batch under the profiler: {wall:.1f} ms, device "
          f"kernels {busy:.1f} ms (busy {busy / wall:.3f}); kernels by "
          "device time (ms, launches):", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} x{e.count:<5d} "
              f"{e.key[:70]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
