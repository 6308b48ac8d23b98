"""Where a cold call's time goes: the segmented Review cell of
``chip_smoke.py`` (phase 5) with all blocks hot and with half its block
bytes cold, in turns, on one GPU.

    python3 tools/cold_tier_probe.py [--src DIR] [--seed 0] [--rounds 3]
                                     [--calls 7]

Builds the cell with ``chip_smoke.review_cell`` (12,886,488 token sets,
the same seed, the same ingest), then for ``--rounds`` rounds times
``topk_batch(k=10)`` and the Jaccard re-ranked call all-hot, then with
the budget at half the block bytes (the least recently used block cold,
in pinned host memory), ``--calls`` calls each after one warm-up: per
call the host clock around a synchronised call and the device span
between two CUDA events on the current stream around it (the span's
idle time included).  Then one ``torch.profiler`` window of 3
synchronised calls per mode, with the host ops by self CPU time and the
device ops by device time.  Prints the card's name and power limit
first.  ``--src`` is the ``src/`` directory whose ``repro_torch`` is
imported (default: this checkout's), so that two trees are timed by the
same script on the same card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def timed(idx, qs, kw, calls: int):
    """Median host ms and device-span ms of ``calls`` synchronised calls."""
    idx.topk_batch(qs, 10, **kw)
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        idx.topk_batch(qs, 10, **kw)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def profile(idx, qs, kw, name: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    idx.topk_batch(qs, 10, **kw)
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            idx.topk_batch(qs, 10, **kw)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    host = [e for e in ev if e.device_type != DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3 / 3
    print(f"{name}: {wall:.2f} ms a call under the profiler, device "
          f"{dev_ms:.2f} ms; host ops by self CPU time (ms a call):",
          flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:14]:
        print(f"  {e.self_cpu_time_total / 1e3 / 3:8.3f} x{e.count // 3:<5d}"
              f" {e.key[:80]}", flush=True)
    print("  device ops (ms a call):", ", ".join(
        f"{e.key[:36]} {e.self_device_time_total / 1e3 / 3:.3f}"
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]),
        flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA: this script times the cold tier on a GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import review_cell

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"src {args.src}", flush=True)
    cell = review_cell(torch, args.seed, torch.device("cuda"))
    idx, qs = cell.idx, cell.qs
    store = idx._refresh_store()
    half = sum(blk.block_bytes for blk in store.blocks) // 2
    modes = {"hot": 10 ** 12, "cold": half}
    kws = {"topk": {}, "rerank": dict(rerank="jaccard", q_payloads=cell.qp)}
    rows = {(m, k): [] for m in modes for k in kws}
    for r in range(args.rounds):
        for mode, budget in modes.items():
            store.hot_bytes = budget
            store._enforce_budget()
            for k, kw in kws.items():
                h, d = timed(idx, qs, kw, args.calls)
                rows[(mode, k)].append((h, d))
                print(f"round {r} {mode:4s} {k:6s}: host {h:.2f} ms, device "
                      f"span {d:.2f} ms ({store.tier_summary()['cold_blocks']}"
                      " cold blocks)", flush=True)
    for (mode, k), v in rows.items():
        print(f"{mode} {k}: host medians {[round(h, 2) for h, _ in v]}, "
              f"device spans {[round(d, 2) for _, d in v]}", flush=True)
    for mode, budget in modes.items():
        store.hot_bytes = budget
        store._enforce_budget()
        for k, kw in kws.items():
            profile(idx, qs, kw, f"{mode} {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
