#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it imports the port from ``src/`` there
and never imports jax or the JAX package.  Phases, each fatal on failure:

  1. device: the card's name and power limit; the CUDA kernels are built
     from ``src/repro_torch/kernels/csrc`` (build seconds printed);
  2. each kernel against its plain PyTorch version on the card, bit-exact,
     over (b, L), ragged n and m, τ and base planes with BIG lanes;
  3. the main path at the size of the paper's Review dataset
     (n = 12,886,488, L = 16, b = 2): ``build_bst``, ``make_batch_searcher``
     at τ = 1, 2, 3 and ``topk_batch(k=10)`` for 64 queries, checked
     against the ``LinearScan`` distance kernel and a numpy host check,
     with every kernel's launch count read around the run;
  4. times (CUDA events, after a warm-up): each kernel at the main path's
     shapes beside its bound, its plain version and a library call, the
     end-to-end ``topk_batch`` and the peak device memory.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The paper's Review dataset (configs/registry.py in the JAX package):
# its size and sketch geometry, and the layer boundaries the paper reports.
REVIEW_N = 12_886_488
REVIEW_L = 16
REVIEW_B = 2
PAPER_LM, PAPER_LS = 8, 11
M_QUERIES = 64
TOPK = 10
BIG = 1 << 20

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
# 32-bit non-tensor rate (listed for float32; no int32 figure is given).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

SWEEP_BL = [(1, 8), (2, 16), (2, 32), (4, 32), (8, 64), (4, 100)]
SWEEP_N = [1, 130, 4097, 1_000_003]
SWEEP_M = [1, 3, 8, 64]
SWEEP_TAU = [0, 3]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, iters: int = 5) -> float:
    """Median device time of ``fn`` in ms (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(b: int, W: int, n: int, m: int, verify: bool):
    """(bound_ms, bound_by) of one scan: each input read once, each output
    written once, against the card's peak bytes and operations.  Per
    (query, column): W·(b XOR + (b-1) OR + popc + add) ops, plus add,
    compare and min for the verify."""
    planes = 3 if verify else 1                   # base in; mask, dist out
    nbytes = 4 * (b * W * n + b * W * m + planes * m * n)
    ops = m * n * (W * (2 * b + 1) + (3 if verify else 0))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script measures the port on a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (LinearScan, build_bst, make_batch_searcher,
                                  topk_batch)
    from repro_torch.core.cost_model import frontier_capacities
    from repro_torch.core.hamming import pack_vertical_torch
    from repro_torch.core.search import (CAP_MAX_DEFAULT,
                                         _traverse_frontier_batch,
                                         scatter_root_plane)
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. device and build -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)   # name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    _build.load_library()
    print(f"kernel build: {_build.BUILD_INFO['seconds']:.2f} s -> "
          f"{_build.BUILD_INFO['path']}", flush=True)
    for line in _build.BUILD_INFO["report"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 2. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    err = {"sparse_verify_batch": 0, "hamming_distances": 0}
    n_checks = 0

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def maxerr(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    t0 = time.perf_counter()
    for b, L in SWEEP_BL:
        W = (L + 31) // 32
        for n in SWEEP_N:
            db = words(b, W, n)
            for m in SWEEP_M:
                q = words(b, W, m)
                got = ops.hamming_distances(db, q)
                want = ref.hamming_distances_ref(db, q)
                e = maxerr(got, want)
                err["hamming_distances"] = max(err["hamming_distances"], e)
                check(e == 0, f"hamming_distances b={b} L={L} n={n} m={m}")
                for tau in SWEEP_TAU:
                    base = torch.randint(0, tau + 3, (m, n), dtype=torch.int32,
                                         device=dev, generator=gen)
                    pruned = torch.rand((m, n), device=dev, generator=gen) < 0.2
                    base[pruned] = BIG
                    mask, dist = ops.sparse_verify_batch(db, q, base, tau=tau)
                    w_mask, w_dist = ref.sparse_verify_batch_ref(db, q, base, tau)
                    e = max(maxerr(mask, w_mask), maxerr(dist, w_dist))
                    if m == 1:                       # the m=1 wrapper too
                        one = ops.sparse_verify(db, q[..., 0].contiguous(),
                                                base[0], tau=tau)
                        e = max(e, maxerr(one[0], w_mask[0]),
                                maxerr(one[1], w_dist[0]))
                    err["sparse_verify_batch"] = max(err["sparse_verify_batch"], e)
                    check(e == 0, f"sparse_verify_batch b={b} L={L} n={n} "
                                  f"m={m} tau={tau}")
                    n_checks += 1
            del db
    torch.cuda.synchronize()
    print(f"kernels vs plain: {n_checks} verify + "
          f"{n_checks // len(SWEEP_TAU)} scan shapes bit-exact "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- 3. main path at the Review size -------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    sketches = rng.integers(0, 1 << REVIEW_B, size=(REVIEW_N, REVIEW_L),
                            dtype=np.uint8)
    index = build_bst(sketches, REVIEW_B, device="cuda")
    torch.cuda.synchronize()
    print(f"build_bst n={REVIEW_N} L={REVIEW_L} b={REVIEW_B}: "
          f"{time.perf_counter() - t0:.1f} s; lm={index.lm} ls={index.ls} "
          f"(paper {PAPER_LM}, {PAPER_LS}) t_L={index.t[-1]} "
          f"kinds={list(index.kinds)} model_bits={index.model_bits()}",
          flush=True)
    t0 = time.perf_counter()
    scan = LinearScan.build(sketches, REVIEW_B, device="cuda")
    print(f"LinearScan.build: {time.perf_counter() - t0:.1f} s", flush=True)

    near = sketches[rng.integers(0, REVIEW_N, size=M_QUERIES // 2)].copy()
    for row in near:                     # 0-3 symbols perturbed per row
        pos = rng.choice(REVIEW_L, size=rng.integers(0, 4), replace=False)
        row[pos] = (row[pos] + rng.integers(1, 1 << REVIEW_B, size=len(pos))) \
            % (1 << REVIEW_B)
    far = rng.integers(0, 1 << REVIEW_B, size=(M_QUERIES // 2, REVIEW_L),
                       dtype=np.uint8)
    qs = np.concatenate([near, far])
    qs_t = torch.from_numpy(qs.astype(np.int32)).to(dev)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_stats()                       # the main path's window
    t0 = time.perf_counter()
    ranges = {tau: make_batch_searcher(index, tau)(qs_t) for tau in (1, 2, 3)}
    top = topk_batch(index, qs_t, TOPK)
    d = scan.distances(qs)                         # (m, n) brute force
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ops.kernel_stats()
    peak_main = torch.cuda.max_memory_allocated()
    print(f"main path: {main_s:.2f} s, launches {launches}, "
          f"peak {peak_main / 2**30:.2f} GiB", flush=True)
    check(launches.get("sparse_verify_batch", 0) > 0,
          "sparse_verify_batch kernel not launched on the main path")
    check(launches.get("hamming_distances", 0) > 0,
          "hamming_distances kernel not launched on the main path")
    check(not any(k.endswith(":ref") for k in launches),
          f"plain version ran on the main path: {launches}")

    check(d.shape == (M_QUERIES, REVIEW_N) and d.dtype == torch.int32,
          f"scan shape {tuple(d.shape)} {d.dtype}")
    for tau, res in ranges.items():
        inside = d <= tau
        check(int(res.overflow.sum()) == 0, f"tau={tau}: frontier overflow")
        check(torch.equal(res.mask, inside), f"tau={tau}: mask != (d <= tau)")
        check(torch.equal(res.dist, torch.where(inside, d, BIG)),
              f"tau={tau}: dist not exact inside the ball / BIG outside")
        print(f"tau={tau}: hits per query min/median/max "
              f"{inside.sum(1).min().item()}/"
              f"{inside.sum(1).median().item()}/"
              f"{inside.sum(1).max().item()}", flush=True)
    check(top.overflow == 0, f"topk overflow {top.overflow}")
    for r0 in range(0, M_QUERIES, 8):              # stable sort: ties by id
        sd, si = torch.sort(d[r0:r0 + 8], dim=1, stable=True)
        check(torch.equal(top.ids[r0:r0 + 8], si[:, :TOPK].to(torch.int32))
              and torch.equal(top.dists[r0:r0 + 8], sd[:, :TOPK]),
              f"topk rows {r0}..{r0 + 7} differ from the brute-force scan")
        del sd, si
    host_ids, host_d = top.ids.cpu().numpy(), top.dists.cpu().numpy()
    for i in (0, 1, M_QUERIES // 2, M_QUERIES - 1):  # host witness
        hd = (sketches != qs[i][None, :]).sum(axis=1)
        check(np.array_equal(d[i].cpu().numpy(), hd), f"scan row {i} != host")
        cand = np.flatnonzero(hd <= top.tau)
        order = cand[np.lexsort((cand, hd[cand]))][:TOPK]
        check(np.array_equal(host_ids[i], order)
              and np.array_equal(host_d[i], hd[order]),
              f"topk row {i} != host top-{TOPK}")
    print(f"main path exact: ranges tau=1,2,3 and top-{TOPK} (tau*={top.tau}) "
          "match the scan kernel, the stable sort and the numpy host check",
          flush=True)

    ops.reset_kernel_stats()
    topk_batch(index, qs_t, TOPK)
    torch.cuda.synchronize()
    per_topk = ops.kernel_stats()
    print(f"launches per topk_batch call: {per_topk}", flush=True)

    # -- 4. kernels at the main path's shapes; times ------------------------
    tail = index.tail
    b, W, t_L = tail.paths_vert.shape
    caps = frontier_capacities(index.t, index.b, top.tau, CAP_MAX_DEFAULT)
    f_ids, f_dists, f_valid, _, _ = _traverse_frontier_batch(
        index, qs_t, tau=top.tau, caps=caps)
    base = scatter_root_plane(f_ids, f_dists, f_valid, M_QUERIES,
                              tail.t_root).index_select(1, tail.leaf_root)
    q_sfx = ops.to_lane_major(pack_vertical_torch(qs_t[:, index.ls:], index.b))
    qv = ops.to_lane_major(pack_vertical_torch(qs_t, REVIEW_B))
    del f_ids, f_dists, f_valid, d, ranges
    torch.cuda.empty_cache()
    slices = range(0, M_QUERIES, 8)              # 8-query slices bound memory

    def plain_verify():
        return [ref.sparse_verify_batch_ref(tail.paths_vert,
                                            q_sfx[..., r0:r0 + 8],
                                            base[r0:r0 + 8], top.tau)
                for r0 in slices]

    def plain_scan():
        return [ref.hamming_distances_ref(scan.full_vert, qv[..., r0:r0 + 8])
                for r0 in slices]

    mask, dist = ops.sparse_verify_batch(tail.paths_vert, q_sfx, base,
                                         tau=top.tau)
    for r0, (w_mask, w_dist) in zip(slices, plain_verify()):
        e = max(maxerr(mask[r0:r0 + 8], w_mask), maxerr(dist[r0:r0 + 8], w_dist))
        err["sparse_verify_batch"] = max(err["sparse_verify_batch"], e)
        check(e == 0, f"sparse_verify_batch at the main path's shape, rows {r0}+")
    del mask, dist, w_mask, w_dist
    dd = ops.hamming_distances(scan.full_vert, qv)
    for r0, want in zip(slices, plain_scan()):
        e = maxerr(dd[r0:r0 + 8], want)
        err["hamming_distances"] = max(err["hamming_distances"], e)
        check(e == 0, f"hamming_distances at the main path's shape, rows {r0}+")
    del want
    print("kernels vs plain at the main path's shapes: bit-exact", flush=True)

    sfx_ms = time_ms(torch, lambda: ops.sparse_verify_batch(
        tail.paths_vert, q_sfx, base, tau=top.tau))
    sfx_plain = time_ms(torch, plain_verify, iters=3)
    sfx_bound, sfx_by = bound(b, W, t_L, M_QUERIES, verify=True)
    Ws = scan.full_vert.shape[1]
    scan_ms = time_ms(torch, lambda: ops.hamming_distances(scan.full_vert, qv))
    scan_plain = time_ms(torch, plain_scan, iters=3)
    scan_bound, scan_by = bound(REVIEW_B, Ws, REVIEW_N, M_QUERIES, verify=False)
    qf = qs_t.float()
    dbf = torch.from_numpy(sketches).to(dev).float()
    check(torch.equal(torch.cdist(qf, dbf, p=0).to(torch.int32), dd),
          "cdist(p=0) disagrees with the scan kernel")
    del dd
    scan_lib = time_ms(torch, lambda: torch.cdist(qf, dbf, p=0))
    del dbf
    print(f"sparse_verify_batch (b={b} W={W} n={t_L} m={M_QUERIES}): "
          f"{sfx_ms:.3f} ms, bound {sfx_bound:.3f} ms ({sfx_by}), "
          f"plain {sfx_plain:.3f} ms", flush=True)
    print(f"hamming_distances (b={REVIEW_B} W={Ws} n={REVIEW_N} "
          f"m={M_QUERIES}): {scan_ms:.3f} ms, bound {scan_bound:.3f} ms "
          f"({scan_by}), plain {scan_plain:.3f} ms, "
          f"cdist(p=0) {scan_lib:.3f} ms", flush=True)

    n_med = 1_000_003                              # a medium shape
    db_med = words(REVIEW_B, 1, n_med)
    q_med = words(REVIEW_B, 1, M_QUERIES)
    base_med = torch.randint(0, 6, (M_QUERIES, n_med), dtype=torch.int32,
                             device=dev, generator=gen)
    med = {
        "verify kernel": lambda: ops.sparse_verify_batch(db_med, q_med,
                                                         base_med, tau=3),
        "verify plain": lambda: ref.sparse_verify_batch_ref(db_med, q_med,
                                                            base_med, 3),
        "scan kernel": lambda: ops.hamming_distances(db_med, q_med),
        "scan plain": lambda: ref.hamming_distances_ref(db_med, q_med),
    }
    print(f"medium shape b={REVIEW_B} W=1 n={n_med} m={M_QUERIES}: " + ", ".join(
        f"{k} {time_ms(torch, fn):.3f} ms" for k, fn in med.items()), flush=True)
    del db_med, q_med, base_med

    topk_batch(index, qs_t, TOPK)                  # warm-up
    torch.cuda.synchronize()
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        topk_batch(index, qs_t, TOPK)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t0) * 1e3)
    e2e_ms = statistics.median(e2e)
    print(f"topk_batch e2e (m={M_QUERIES}, k={TOPK}, tau*={top.tau}): "
          f"{e2e_ms:.2f} ms median of 5, {M_QUERIES / e2e_ms * 1e3:.0f} "
          f"queries/s", flush=True)
    print(f"max_memory_allocated: main path {peak_main / 2**30:.2f} GiB, "
          f"run {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    kernels = [
        {"name": "sparse_verify_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:114",
         "launches": launches["sparse_verify_batch"],
         "max_abs_err": err["sparse_verify_batch"], "ms": sfx_ms,
         "plain_ms": sfx_plain, "bound_ms": sfx_bound, "bound_by": sfx_by,
         "library_ms": None},
        {"name": "hamming_distances", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:70",
         "launches": launches["hamming_distances"],
         "max_abs_err": err["hamming_distances"], "ms": scan_ms,
         "plain_ms": scan_plain, "bound_ms": scan_bound, "bound_by": scan_by,
         "library_ms": scan_lib},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
