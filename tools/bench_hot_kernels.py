"""Time the arena verifies, the exact re-rank, the flash-attention
forward and backward and the train step of the port on one GPU, at the
shapes of ``chip_smoke.py``'s main paths.

    python3 tools/bench_hot_kernels.py [--src DIR] [--seed 0] [--iters 10]
        [--only packed,plane,rerank,flash,hubert,rows,bwd,step]
        [--slab-q 4|8|16]

``--src`` is the ``src/`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees — say a parent commit
unpacked with ``git archive`` — are timed by the same script on the same
card, in turns.  Each kernel is first checked against its plain version
on the same inputs (bit-exact for the verifies and the re-rank's float32
bit patterns, 2e-2 for bf16 attention).  Every time is of the wrapper,
three ways: one call between two events (``wrapper``: its host work
included, as a caller that waits on each call sees it), the mean of 20
calls queued back to back (``queued``: the host works ahead of the
card, so this is the kernel's own time whenever the host's share of a
call is the shorter) and the mean of 20 calls queued behind a sleep
kernel (``device``: the kernel's own time whatever the host's share).  ``--slab-q`` forces the arena verifies' queries
per slab pass (a variant; by default the wrapper picks it from T).

  * packed: the segmented Review shape — one packed group, b = 2, S = 4,
    n = 12,582,912 columns, T = 6,818,030 roots, m = 64 queries — with
    synthetic lanes: random words, base_idx uniform over [0, T) (a
    column's root is random within its segment), 1% dead columns, a base
    plane of 0..5 with 60% BIG.  Prints the bound (bytes: lanes and the
    plane once, both outputs), a write-only floor (``fill_`` of the two
    (m, n) outputs) and the same call with base_idx sorted (coalesced
    gathers: what the random gathers still cost).
  * plane: the plane verify (b = 2, W = 1) at phase 6's CP shape (n =
    1,048,576, T = 662,938) and at the full layout's Review shape (n =
    12,582,912, T = 6,818,030), m = 64, with the packed bench's synthetic
    lanes; prints the bound, the write-only floor and the call with
    base_idx sorted (queued).
  * rerank: the Jaccard re-rank at phase 5's shape (Wp = 8, n =
    13,107,200, m = 64) at phase 5's survivor density (19,203 lanes), 1%
    and 100%, random payloads and queries; prints the bound (compulsory
    bytes: both (m, n) planes and the payloads of the columns with a
    survivor), the write-only floor (``fill_`` of the scores) and a
    stream floor (``copy_`` of the int32 flags into the float32 scores:
    both planes once); at phase 5's density also n - 1 columns (one
    column a thread).
  * flash: the prefill's shape (B 8, H 9, S 2,000, D 64, bf16, causal),
    contiguous (B, H, S, D) and the model's strided (B, S, H, D) views,
    beside ``scaled_dot_product_attention``; the other head dims of
    ``ops.FLASH_HEAD_DIMS`` at the same B, H and S; yi-9b's local heads
    under ``--model-ranks 2`` (B 8, H 16, S 2,000, D 128, causal) and the
    forward with its lse at smollm-135m's train shape (B 8, H 9, S 2,048,
    D 64, causal), each on the model's strided views beside
    ``scaled_dot_product_attention``; the prefill shapes of gemma2-27b's
    local and global layers (B 2, H 32, S 8,144, D 128, causal, window
    4,096 and 0, cap 50: no PyTorch call beside them) and command-r-35b's
    (B 8, H 64, S 2,000, D 128, causal, beside SDPA), with the local /
    global ratio of their device times; deepseek-moe-16b's prefill (B 8,
    H 16, S 2,000, D 128, causal) and zamba2-2.7b's shared block on one
    of two model ranks' heads (B 2, H 16, S 2,000, D 80, causal), each
    beside SDPA; the float32 route.
  * hubert: hubert-xlarge's attention (B 2, H 16, D 80, bidirectional,
    bf16) at S 1,000 and 1,500, beside ``scaled_dot_product_attention``
    and the float32 route, with the bound (operations); the forward with
    its lse at the two D 80 training shapes (zamba2-2.7b: B 2, H 32,
    S 2,048, causal; hubert-xlarge: B 4, H 16, S 2,048, bidirectional).

  * rows: the static verify (row 1, ``sparse_verify_batch``: b = 2,
    W = 1, n = 12,867,144 leaves, m = 64, tau 3, a base plane of 0..5
    with 20% BIG) and the scan (row 2, ``hamming_distances``: n =
    12,886,488, m = 64) at phase 4's shapes, random words; where the
    tree has them, their batched launches at phase 10's shapes: the
    verify over 4 shards of 3,220,448 leaves (queries shared) and the
    scan over 64 candidate sets of 78,660 columns, one query each; then
    row 2b, the MI-bST candidate verify, from the same 64 rows of
    sorted random ids over 12,886,488 columns (78,660 slots a row, the
    valid counts drawn to phase 10 (a)'s τ 3 min / median / max,
    ``MI_COUNTS``), two ways: ``hamming_distances_gather``, where the
    tree has it, beside its bound, and the old chain (the
    where, ``index_select`` + ``permute().contiguous()`` and
    ``hamming_distances_batched``), each checked against its plain
    version first.

  * bwd: the FA-2 backward (``ops.flash_attention_bwd``) at smollm-135m's
    train shape (B 8, H 9, S 2,048, D 64, causal, bf16, the model's
    strided views), at the windowed, capped D = 128 case of
    ``chip_smoke.py``'s BWD_CASES and at the two D 80 training shapes
    of its phase 17 (zamba2-2.7b: B 2, H 32, S 2,048, causal;
    hubert-xlarge: B 4, H 16, S 2,048, bidirectional), checked against
    the plain version (2^-7 of each gradient's largest magnitude); the
    wrapper, its dq and dk/dv passes alone (queued), the wrapper's host
    time a call (queued, without waiting), the bound (operations: five
    products of the visible pairs) and, but for the D = 128 case,
    ``scaled_dot_product_attention``'s backward (forward and backward
    less the forward, queued).

  * step: one smollm-135m train step at full size (8 x 2,048 random
    tokens, bf16 compute, remat, AdamW; random weights from the seed),
    the step alone as ``chip_smoke.py`` phase 12 (c) times it: the
    median of ``--iters`` synchronised steps after two warm-ups, with
    the flash kernels' launches a step. Host-bound, so compare trees
    only in turns.

Needs CUDA; prints the card's name and power limit first, then one line
per measurement and a JSON line of the times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
PEAK_OPS_PER_S = 67e12          # H100 SXM 32-bit integer / float32
BIG = 1 << 20
# Candidates a query at chip_smoke.py phase 10 (a)'s tau 3 (min, median,
# max over its 64 queries, C = 78,660 slots).
MI_COUNTS = (9555, 9842, 10039)
# chip_smoke.py phase 18's prefill shapes of the flash forward: gemma2-27b's
# local and global layers (2 x 8,144 tokens, 32 heads over 16 KV heads,
# softcap 50) and command-r-35b's (chameleon-34b's is the same):
# (key, (B, H, S, D), window, cap), causal, the KV heads repeated
LARGE_DENSE_SHAPES = (("gemma2_local", (2, 32, 8144, 128), 4096, 50.0),
                      ("gemma2_global", (2, 32, 8144, 128), 0, 50.0),
                      ("command_r", (8, 64, 2000, 128), 0, 0.0))
CHECK_SEQ = 4096


def time_ms(fn, iters: int) -> float:
    """Median device time of one call of ``fn`` between two events (one
    warm-up)."""
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


def queued_ms(fn, calls: int = 20) -> float:
    """Mean time of ``calls`` calls of ``fn`` queued back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, calls: int = 20) -> float:
    """Mean device time of ``calls`` calls of ``fn`` queued behind a sleep
    kernel: the host enqueues them all while the card sleeps, so this is
    the kernels' own time even where the host's share of a call is the
    longer (``queued`` then measures the host)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)        # ≈ 25 ms at the H100's clocks
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int = 20) -> float:
    """Mean host time of one call of ``fn`` in microseconds: the wrapper's
    work and its launches, queued without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def both(fn, iters: int) -> dict:
    return {"wrapper": time_ms(fn, iters), "queued": queued_ms(fn),
            "device": device_ms(fn)}


def bench_packed(ops, ref, gen, iters: int) -> dict:
    n, T, m, b, S = 12_582_912, 6_818_030, 64, 2, 4
    dev = torch.device("cuda")
    words = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                          device=dev, generator=gen)
    q = torch.randint(-2 ** 31, 2 ** 31, (m,), dtype=torch.int32, device=dev,
                      generator=gen)
    plane, idx, live = synthetic_lanes(gen, m, T, n)
    kw = dict(b=b, S=S, tau=3)

    def check(idx_):
        got = ops.sparse_verify_arena_packed(words, q, plane, idx_, live,
                                             **kw)
        for r0 in range(0, m, 8):
            w_mask, w_dist = ref.sparse_verify_arena_packed_ref(
                words, q[r0:r0 + 8], plane[r0:r0 + 8], idx_, live, b, S, 3)
            if not (torch.equal(got[0][r0:r0 + 8], w_mask.to(torch.int32))
                    and torch.equal(got[1][r0:r0 + 8], w_dist)):
                raise SystemExit(f"packed verify differs from the plain "
                                 f"version, rows {r0}+")

    nbytes = 9 * n + 4 * m * T + 4 * m + 8 * m * n
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    check(idx)
    out = both(lambda: ops.sparse_verify_arena_packed(
        words, q, plane, idx, live, **kw), iters)
    mask = torch.empty((m, n), dtype=torch.int32, device=dev)
    dist = torch.empty_like(mask)
    out["write_floor"] = time_ms(lambda: (mask.fill_(1), dist.fill_(2)),
                                 iters)
    del mask, dist
    srt = torch.sort(idx).values
    check(srt)
    out["sorted_idx"] = time_ms(lambda: ops.sparse_verify_arena_packed(
        words, q, plane, srt, live, **kw), iters)
    print(f"packed verify (n={n} T={T} m={m} b={b} S={S}): wrapper "
          f"{out['wrapper']:.3f} ms, queued {out['queued']:.3f} ms; bound "
          f"{bound:.3f} ms (bytes, {nbytes / 1e9:.2f} GB); write-only floor "
          f"of the two outputs {out['write_floor']:.3f} ms; base_idx sorted "
          f"(coalesced gathers) {out['sorted_idx']:.3f} ms", flush=True)
    return out


def synthetic_lanes(gen, m: int, T: int, n: int):
    """The packed bench's lanes: a base plane of 0..5 with 60% BIG,
    base_idx uniform over [0, T), 1% dead columns."""
    dev = torch.device("cuda")
    plane = torch.randint(0, 6, (m, T), dtype=torch.int32, device=dev,
                          generator=gen)
    plane[torch.rand((m, T), device=dev, generator=gen) < 0.6] = BIG
    idx = torch.randint(0, T, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    live = torch.rand(n, device=dev, generator=gen) >= 0.01
    return plane, idx, live


def bench_plane(ops, ref, gen, iters: int) -> dict:
    m, b, W = 64, 2, 1
    dev = torch.device("cuda")
    out = {}
    for key, n, T in (("cp", 1_048_576, 662_938),
                      ("full_review", 12_582_912, 6_818_030)):
        cols = torch.randint(-2 ** 31, 2 ** 31, (b, W, n), dtype=torch.int32,
                             device=dev, generator=gen)
        q = torch.randint(-2 ** 31, 2 ** 31, (b, W, m), dtype=torch.int32,
                          device=dev, generator=gen)
        cols[..., ::5] = q[..., :1]              # some columns verify
        plane, idx, live = synthetic_lanes(gen, m, T, n)
        got = ops.sparse_verify_arena(cols, q, plane, idx, live, tau=3)
        for r0 in range(0, m, 8):
            w_mask, w_dist = ref.sparse_verify_arena_ref(
                cols, q[..., r0:r0 + 8], plane[r0:r0 + 8], idx, live, 3)
            if not (torch.equal(got[0][r0:r0 + 8], w_mask.to(torch.int32))
                    and torch.equal(got[1][r0:r0 + 8], w_dist)):
                raise SystemExit(f"plane verify ({key}) differs from the "
                                 f"plain version, rows {r0}+")
        del got, w_mask, w_dist
        nbytes = 4 * m * T + n * (4 * b * W + 5) + 4 * b * W * m + 8 * m * n
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        r = both(lambda: ops.sparse_verify_arena(cols, q, plane, idx, live,
                                                 tau=3), iters)
        mask = torch.empty((m, n), dtype=torch.int32, device=dev)
        dist = torch.empty_like(mask)
        r["write_floor"] = time_ms(lambda: (mask.fill_(1), dist.fill_(2)),
                                   iters)
        r["bound"] = bound
        del mask, dist
        srt = torch.sort(idx).values
        r["sorted_idx"] = queued_ms(lambda: ops.sparse_verify_arena(
            cols, q, plane, srt, live, tau=3))
        del cols, plane, idx, live, srt
        print(f"plane verify {key} (n={n} T={T} m={m} b={b} W={W}): wrapper "
              f"{r['wrapper']:.4f} ms, queued {r['queued']:.4f} ms; bound "
              f"{bound:.4f} ms (bytes, {nbytes / 1e9:.3f} GB); write-only "
              f"floor of the two outputs {r['write_floor']:.4f} ms; "
              f"base_idx sorted (coalesced gathers) {r['sorted_idx']:.4f} ms "
              f"queued", flush=True)
        out[key] = r
        torch.cuda.empty_cache()
    return out


def bench_rerank(ops, ref, gen, iters: int) -> dict:
    Wp, n, m = 8, 13_107_200, 64
    dev = torch.device("cuda")
    pay = torch.randint(-2 ** 31, 2 ** 31, (Wp, n), dtype=torch.int32,
                        device=dev, generator=gen)
    q = torch.randint(-2 ** 31, 2 ** 31, (Wp, m), dtype=torch.int32,
                      device=dev, generator=gen)
    out = {}

    def check(pay_, surv_):
        got = ops.exact_rerank(pay_, q, surv_, metric="jaccard")
        for r0 in range(0, m, 8):
            want = ref.exact_rerank_ref(pay_, q[:, r0:r0 + 8],
                                        surv_[r0:r0 + 8], "jaccard")
            if not torch.equal(got[r0:r0 + 8].view(torch.int32),
                               want.view(torch.int32)):
                raise SystemExit(f"re-rank differs from the plain version, "
                                 f"rows {r0}+")

    for key, p in (("phase5", 19_203 / (m * n)), ("1pct", 0.01),
                   ("dense", 1.0)):
        surv = (torch.rand((m, n), device=dev, generator=gen) < p).to(
            torch.int32)
        check(pay, surv)
        lanes = int(surv.sum())
        cols = int(surv.any(dim=0).sum())
        nbytes = 4 * (2 * m * n + Wp * m + Wp * cols)
        r = both(lambda: ops.exact_rerank(pay, q, surv, metric="jaccard"),
                 iters)
        scores = torch.empty((m, n), dtype=torch.float32, device=dev)
        r["write_floor"] = time_ms(lambda: scores.fill_(1.0), iters)
        r["stream_floor"] = time_ms(lambda: scores.copy_(surv), iters)
        r["bound"] = nbytes / PEAK_BYTES_PER_S * 1e3
        del scores
        extra = ""
        if key == "phase5":
            pay1, surv1 = pay[:, :-1].contiguous(), surv[:, :-1].contiguous()
            check(pay1, surv1)
            r["one_column_a_thread"] = time_ms(lambda: ops.exact_rerank(
                pay1, q, surv1, metric="jaccard"), iters)
            extra = (f"; n - 1 columns (one a thread) "
                     f"{r['one_column_a_thread']:.3f} ms")
            del pay1, surv1
        del surv
        print(f"re-rank {key} (Wp={Wp} n={n} m={m}, {lanes} survivors in "
              f"{cols} columns): wrapper {r['wrapper']:.3f} ms, queued "
              f"{r['queued']:.3f} ms; bound {r['bound']:.3f} ms (bytes, "
              f"{nbytes / 1e9:.3f} GB); write-only floor "
              f"{r['write_floor']:.3f} ms, stream floor "
              f"{r['stream_floor']:.3f} ms{extra}", flush=True)
        out[key] = r
        torch.cuda.empty_cache()
    return out


def bench_flash(ops, ref, gen, iters: int) -> dict:
    import torch.nn.functional as F
    B, H, S, D = 8, 9, 2000, 64
    dev = torch.device("cuda")
    q, k, v = (torch.randn((B, H, S, D), device=dev, generator=gen)
               .bfloat16() for _ in range(3))
    qs, ks, vs = (torch.randn((B, S, H, D), device=dev, generator=gen)
                  .bfloat16().transpose(1, 2) for _ in range(3))
    out = {}
    for key, x in (("bf16", (q, k, v)), ("bf16_strided", (qs, ks, vs))):
        check_flash(ops, ref, x)
        out[key] = both(lambda: ops.flash_attention_fwd(*x, causal=True),
                        iters)
    out["sdpa"] = both(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters)
    for Dv in ops.FLASH_HEAD_DIMS:
        if Dv == D:
            continue
        x = tuple(torch.randn((B, H, S, Dv), device=dev, generator=gen)
                  .bfloat16() for _ in range(3))
        check_flash(ops, ref, x)
        out[f"bf16_d{Dv}"] = both(lambda: ops.flash_attention_fwd(
            *x, causal=True), iters)
        print(f"  flash bf16 D={Dv}: wrapper {out[f'bf16_d{Dv}']['wrapper']:.4f}"
              f" ms, queued {out[f'bf16_d{Dv}']['queued']:.4f} ms",
              flush=True)
    for key, (Bx, Hx, Sx, Dx), lse in (
            ("yi9b_local_heads", (8, 16, 2000, 128), False),
            ("lse_train", (8, 9, 2048, 64), True),
            ("deepseek", (8, 16, 2000, 128), False),
            ("zamba2_rank_heads", (2, 16, 2000, 80), False)):
        out[key] = fwd_beside_sdpa(ops, ref, gen, iters, Bx, Hx, Sx, Dx,
                                   causal=True, lse=lse)
    for key, (Bx, Hx, Sx, Dx), window, cap in LARGE_DENSE_SHAPES:
        out[key] = fwd_beside_sdpa(ops, ref, gen, iters, Bx, Hx, Sx, Dx,
                                   causal=True, lse=False, window=window,
                                   cap=cap)
    if "gemma2_local" in out:
        local, glob = (out[k]["bf16"]["device"]
                       for k in ("gemma2_local", "gemma2_global"))
        print(f"  gemma2-27b local / global layer (device): {local:.4f} / "
              f"{glob:.4f} ms = {local / glob:.3f} (visible pairs "
              f"{out['gemma2_local']['pairs'] / out['gemma2_global']['pairs']:.3f})",
              flush=True)
    q32, k32, v32 = q.float(), k.float(), v.float()
    out["f32"] = time_ms(lambda: ops.flash_attention_fwd(
        q32, k32, v32, causal=True), max(3, iters // 3))
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    t = out["bf16"]["queued"]
    print(f"flash (B={B} H={H} S={S} D={D} causal, {flops / 1e9:.1f} "
          f"GFLOP): bf16 wrapper {out['bf16']['wrapper']:.4f} ms, queued "
          f"{t:.4f} ms, device {out['bf16']['device']:.4f} ms "
          f"({flops / out['bf16']['device'] / 1e9:.1f} TFLOP/s); strided (B, S, H, "
          f"D) views wrapper {out['bf16_strided']['wrapper']:.4f}, queued "
          f"{out['bf16_strided']['queued']:.4f} ms; "
          f"scaled_dot_product_attention {out['sdpa']['wrapper']:.4f} / "
          f"{out['sdpa']['queued']:.4f} / {out['sdpa']['device']:.4f} ms; "
          f"float32 route "
          f"{out['f32']:.4f} ms; bound "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms (operations)", flush=True)
    return out


def bench_hubert(ops, ref, gen, iters: int) -> dict:
    """hubert-xlarge's attention: B 2, H 16, D 80, bidirectional, bf16, at
    S 1,000 (the frames of ``chip_smoke.py``'s hubert step, 20 s of audio
    at 50 Hz) and 1,500 (30 s)."""
    import torch.nn.functional as F
    B, H, D = 2, 16, 80
    dev = torch.device("cuda")
    out = {}
    for S in (1000, 1500):
        x = tuple(torch.randn((B, H, S, D), device=dev, generator=gen)
                  .bfloat16() for _ in range(3))
        check_flash(ops, ref, x, causal=False)
        r = {"bf16": both(lambda: ops.flash_attention_fwd(*x, causal=False),
                          iters),
             "sdpa": both(lambda: F.scaled_dot_product_attention(*x),
                          iters)}
        x32 = tuple(a.float() for a in x)
        r["f32"] = time_ms(lambda: ops.flash_attention_fwd(
            *x32, causal=False), max(3, iters // 3))
        flops = 4 * B * H * S * S * D
        bnd = max(flops / PEAK_BF16_FLOPS, 4 * B * H * S * D * 2
                  / PEAK_BYTES_PER_S) * 1e3
        t = r["bf16"]["queued"]
        print(f"flash hubert (B={B} H={H} S={S} D={D} bidirectional, "
              f"{flops / 1e9:.2f} GFLOP): bf16 wrapper "
              f"{r['bf16']['wrapper']:.4f} ms, queued {t:.4f} ms, device "
              f"{r['bf16']['device']:.4f} ms "
              f"({flops / r['bf16']['device'] / 1e9:.1f} TFLOP/s); "
              f"scaled_dot_product_attention {r['sdpa']['wrapper']:.4f} / "
              f"{r['sdpa']['queued']:.4f} / {r['sdpa']['device']:.4f} ms; "
              f"float32 route {r['f32']:.4f} "
              f"ms; bound {bnd:.4f} ms (operations)", flush=True)
        out[f"S{S}"] = r
    for key, (Bx, Hx, Sx), causal in (("lse_zamba2", (2, 32, 2048), True),
                                      ("lse_hubert", (4, 16, 2048), False)):
        out[key] = fwd_beside_sdpa(ops, ref, gen, iters, Bx, Hx, Sx, D,
                                   causal=causal, lse=True)
    return out


def fwd_beside_sdpa(ops, ref, gen, iters: int, B: int, H: int, S: int,
                    D: int, *, causal: bool, lse: bool, window: int = 0,
                    cap: float = 0.0) -> dict:
    """The bf16 forward (with the lse where ``lse``: the training path's
    forward) on the model's strided (B, S, H, D) views, checked against
    its plain version, one call and queued, beside
    ``scaled_dot_product_attention`` (none under a window or a cap: no
    one PyTorch call applies either inside the softmax) and the bound
    (operations over the visible pairs)."""
    import torch.nn.functional as F
    x = tuple(torch.randn((B, S, H, D), device="cuda", generator=gen)
              .bfloat16().transpose(1, 2) for _ in range(3))
    check_flash(ops, ref, x, causal=causal, window=window, cap=cap)
    r = {"bf16": both(lambda: ops.flash_attention_fwd(
            *x, causal=causal, window=window, cap=cap, return_lse=lse),
            iters)}
    if window or cap:
        r["sdpa"], sdpa = None, "none (window or cap)"
    else:
        r["sdpa"] = both(lambda: F.scaled_dot_product_attention(
            *x, is_causal=causal), iters)
        sdpa = (f"{r['sdpa']['wrapper']:.4f} / {r['sdpa']['queued']:.4f} / "
                f"{r['sdpa']['device']:.4f} ms")
    r["pairs"] = ops.visible_pairs(S, S, causal, window, 0)
    flops = 4 * B * H * D * r["pairs"]
    r["bound_ms"] = flops / PEAK_BF16_FLOPS * 1e3
    print(f"flash{' with lse' if lse else ''} (B={B} H={H} S={S} D={D} "
          f"{'causal' if causal else 'bidirectional'}"
          f"{f', window {window}' if window else ''}"
          f"{f', cap {cap:g}' if cap else ''}, strided views): "
          f"bf16 wrapper {r['bf16']['wrapper']:.4f} ms, queued "
          f"{r['bf16']['queued']:.4f} ms, device {r['bf16']['device']:.4f} "
          f"ms ({flops / r['bf16']['device'] / 1e9:.1f} TFLOP/s); "
          f"scaled_dot_product_attention {sdpa}; bound "
          f"{r['bound_ms']:.4f} ms (operations)", flush=True)
    return r


def bench_rows(ops, ref, gen, iters: int) -> dict:
    dev = torch.device("cuda")
    m, tau = 64, 3

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def base_plane(*shape):
        base = torch.randint(0, 6, shape, dtype=torch.int32, device=dev,
                             generator=gen)
        base[torch.rand(shape, device=dev, generator=gen) < 0.2] = BIG
        return base

    def same(got, want, what):
        if not all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want)):
            raise SystemExit(f"{what} differs from the plain version")

    out = {}
    n1 = 12_867_144
    db, q, base = words(2, 1, n1), words(2, 1, m), base_plane(m, n1)
    got = ops.sparse_verify_batch(db, q, base, tau=tau)
    for r0 in range(0, m, 8):
        same([x[r0:r0 + 8] for x in got], ref.sparse_verify_batch_ref(
            db, q[..., r0:r0 + 8], base[r0:r0 + 8], tau), "row 1")
    out["verify"] = both(lambda: ops.sparse_verify_batch(db, q, base,
                                                         tau=tau), iters)
    del db, q, base, got
    n2 = 12_886_488
    db, q = words(2, 1, n2), words(2, 1, m)
    got = ops.hamming_distances(db, q)
    for r0 in range(0, m, 8):
        same([got[r0:r0 + 8]], [ref.hamming_distances_ref(
            db, q[..., r0:r0 + 8])], "row 2")
    out["scan"] = both(lambda: ops.hamming_distances(db, q), iters)
    del db, q, got
    print(f"row 1 verify (b=2 W=1 n={n1} m={m}): wrapper "
          f"{out['verify']['wrapper']:.3f} ms, queued "
          f"{out['verify']['queued']:.3f} ms; row 2 scan (n={n2} m={m}): "
          f"wrapper {out['scan']['wrapper']:.3f} ms, queued "
          f"{out['scan']['queued']:.3f} ms", flush=True)
    if not hasattr(ops, "sparse_verify_batch_batched"):
        return out
    S, n3 = 4, 3_220_448
    db, q, base = words(S, 2, 1, n3), words(2, 1, m), base_plane(S, m, n3)
    got = ops.sparse_verify_batch_batched(db, q, base, tau=tau)
    for r0 in range(0, m, 8):
        same([x[:, r0:r0 + 8] for x in got],
             ref.sparse_verify_batch_batched_ref(
                 db, q[..., r0:r0 + 8], base[:, r0:r0 + 8], tau),
             "row 1 batched")
    out["verify_shards"] = both(lambda: ops.sparse_verify_batch_batched(
        db, q, base, tau=tau), iters)
    del db, q, base, got
    C = 78_660
    db, q = words(m, 2, 1, C), words(m, 2, 1, 1)
    same([ops.hamming_distances_batched(db, q, block_m=1)],
         [ref.hamming_distances_batched_ref(db, q)], "row 2 batched")
    out["scan_queries"] = both(lambda: ops.hamming_distances_batched(
        db, q, block_m=1), iters)
    print(f"row 1 batched over {S} shards of {n3} leaves (m={m}): wrapper "
          f"{out['verify_shards']['wrapper']:.3f} ms, queued "
          f"{out['verify_shards']['queued']:.3f} ms; row 2 batched over "
          f"{m} candidate sets of {C} (one query each): wrapper "
          f"{out['scan_queries']['wrapper']:.4f} ms, queued "
          f"{out['scan_queries']['queued']:.4f} ms", flush=True)
    del db, q
    out.update(bench_mi_verify(ops, ref, gen, iters, words, same))
    return out


def mi_counts(gen, m: int, C: int) -> torch.Tensor:
    """(m,) candidate counts drawn to ``MI_COUNTS``: one query at the min,
    one at the max, the rest uniform half below the median, half above."""
    lo, med, hi = MI_COUNTS
    u = torch.rand((m,), generator=gen, device="cuda")
    half = torch.arange(m, device="cuda") % 2 == 0
    c = torch.where(half, lo + u * (med - lo), med + u * (hi - med))
    c[0], c[1] = lo, hi
    return c.round().clamp(0, C).to(torch.int32)


def bench_mi_verify(ops, ref, gen, iters: int, words, same) -> dict:
    """Row 2b two ways from the same ids (``bench_rows``' doc)."""
    m, n, C, b, W = 64, 12_886_488, 78_660, 2, 1
    dev = torch.device("cuda")
    db, q = words(b, W, n), words(b, W, m)
    counts = mi_counts(gen, m, C)
    ids = torch.zeros((m, C), dtype=torch.int32, device=dev)   # as compacted
    for j, k in enumerate(counts.tolist()):
        ids[j, :k] = torch.randint(0, n, (k,), dtype=torch.int32, device=dev,
                                   generator=gen).sort().values
    valid = torch.arange(C, device=dev)[None, :] < counts[:, None]
    V = int(counts.sum())
    q_sets = q.permute(2, 0, 1)[..., None].contiguous()       # (m, b, W, 1)

    def gathered():
        safe = torch.where(valid, ids, 0)
        return db.index_select(2, safe.reshape(-1)).reshape(
            b, W, m, C).permute(2, 0, 1, 3).contiguous()

    def old_chain():
        return ops.hamming_distances_batched(gathered(), q_sets,
                                             block_m=1)[:, 0, :]
    cand = gathered()
    same([ops.hamming_distances_batched(cand, q_sets, block_m=1)],
         [ref.hamming_distances_batched_ref(cand, q_sets)], "row 2b chain")
    del cand
    out = {"mi_chain": both(old_chain, iters)}
    line = (f"row 2b from {m} rows of sorted ids over {n} columns ({C} "
            f"slots, {V} valid, counts {MI_COUNTS}): old chain wrapper "
            f"{out['mi_chain']['wrapper']:.4f}, queued "
            f"{out['mi_chain']['queued']:.4f}, device "
            f"{out['mi_chain']['device']:.4f} ms")
    if hasattr(ops, "hamming_distances_gather"):
        want = ref.hamming_distances_gather_ref(db, q, ids, counts)
        same([torch.where(valid, old_chain(), BIG)], [want],
             "row 2b old chain against the candidate verify's plain version")

        def gather():
            return ops.hamming_distances_gather(db, q, ids, counts)
        same([gather()], [want], "row 2b gather")
        g = out["mi_gather"] = both(gather, iters)
        n_ops, nbytes, _ = ops._gather_cost(db, q, ids, counts)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_OPS_PER_S * 1e3
        out["mi_bound"] = {"ms": max(t_bytes, t_ops), "valid": V}
        line += (f"; gather wrapper {g['wrapper']:.4f}, queued "
                 f"{g['queued']:.4f}, device {g['device']:.4f} ms; bound "
                 f"{out['mi_bound']['ms']:.4f} ms "
                 f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    print(line, flush=True)
    return out


def bench_bwd(ops, ref, gen, iters: int) -> dict:
    """The FA-2 backward at smollm-135m's train shape (B 8, H 9, S 2,048,
    D 64, causal, bf16; the model's (B, S, H, D) views), each pass alone
    through the launcher's ``passes`` argument, beside
    ``scaled_dot_product_attention``'s backward and the bound; then the
    D = 128 case of ``chip_smoke.py``'s BWD_CASES (B 2, H 4, S 1,024,
    window 256, cap 50) and the D 80 shapes of zamba2-2.7b's and
    hubert-xlarge's training (each beside SDPA's backward too)."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for key, (B, H, S, D, kw) in (
            ("smollm", (8, 9, 2048, 64, dict(causal=True))),
            ("d128", (2, 4, 1024, 128, dict(causal=True, window=256,
                                            cap=50.0))),
            ("zamba2_d80", (2, 32, 2048, 80, dict(causal=True))),
            ("hubert_d80", (4, 16, 2048, 80, dict(causal=False)))):
        q, k, v, do = (torch.randn((B, S, H, D), device=dev, generator=gen)
                       .bfloat16().transpose(1, 2) for _ in range(4))
        o, lse = ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           tile_bf16=True, **kw)
        for a, w, name in zip(got, want, ("dq", "dk", "dv")):
            e = float((a.float() - w.float()).abs().max())
            if not e <= 2 ** -7 * float(w.float().abs().max()):
                raise SystemExit(f"flash backward {name} max err {e}")
        del got, want
        full = dict(causal=False, window=0, cap=0.0, scale=D ** -0.5,
                    q_offset=0, tile_bf16=False)
        full.update(kw)
        _, args = ops.flash_bwd_args(q, k, v, o, lse, do, **full)

        def one_pass(passes):
            code = lib.flash_attention_bwd_launch(*args, passes, stream)
            if code:
                raise SystemExit(f"flash_attention_bwd_launch: {code}")

        r = {"bwd": both(lambda: ops.flash_attention_bwd(
                 q, k, v, o, lse, do, **kw), iters),
             "host_us": host_us(lambda: ops.flash_attention_bwd(
                 q, k, v, o, lse, do, **kw)),
             "dq_pass": queued_ms(lambda: one_pass(1)),
             "dkdv_pass": queued_ms(lambda: one_pass(2))}
        window = kw.get("window", 0)
        pairs = sum(min(i + 1, window) if window else
                    (i + 1 if kw["causal"] else S) for i in range(S)) * B * H
        flops = 10 * pairs * D
        t = r["bwd"]["queued"]
        msg = ""
        if key != "d128":
            qq, kk, vv = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            fwd = queued_ms(lambda: F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=kw["causal"]))
            both_ = queued_ms(lambda: F.scaled_dot_product_attention(
                qq, kk, vv, is_causal=kw["causal"]).backward(do))
            r["sdpa_bwd"] = both_ - fwd
            msg = (f"; scaled_dot_product_attention backward "
                   f"{r['sdpa_bwd']:.4f} ms ({both_:.4f} forward and "
                   f"backward, {fwd:.4f} the forward)")
        print(f"flash backward {key} (B={B} H={H} S={S} D={D} {kw}, "
              f"{flops / 1e9:.1f} GFLOP of five products): wrapper "
              f"{r['bwd']['wrapper']:.4f} ms, queued {t:.4f} ms "
              f"({flops / t / 1e9:.1f} TFLOP/s); dq pass "
              f"{r['dq_pass']:.4f} ms, dk/dv pass {r['dkdv_pass']:.4f} ms; "
              f"host {r['host_us']:.1f} us a call; "
              f"bound {flops / PEAK_BF16_FLOPS * 1e3:.4f} ms "
              f"(operations){msg}", flush=True)
        out[key] = r
    return out


def bench_step(ops, ref, gen, iters: int) -> dict:
    """One smollm-135m train step at full size, the step alone as
    ``chip_smoke.py`` phase 12 (c) times it: random weights from the
    seed, 8 x 2,048 random tokens, bf16 compute, remat, AdamW; two
    warm-up steps, then the host clock around ``iters`` synchronised
    steps (median), beside the flash kernels' launches a step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import Hyper, adamw_init
    from repro_torch.train.steps import make_train_step
    cfg = get_config("smollm-135m")
    B, S = 8, 2048
    params = M.init_params(torch.Generator().manual_seed(gen.initial_seed()),
                           cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab, (B, S + 1), device="cuda",
                         generator=gen, dtype=torch.int64).to(torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    step = make_train_step(cfg, Hyper(warmup_steps=2, total_steps=100))
    opt = adamw_init(params)
    for _ in range(2):
        step(params, opt, batch)
    torch.cuda.synchronize()
    ops.reset_kernel_stats()
    step(params, opt, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.kernel_stats().items()
                if k.startswith("flash")}
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"train step smollm-135m ({B} x {S} tokens, bf16, remat): "
          f"{ms:.1f} ms median of {iters} {[round(t, 1) for t in times]}, "
          f"{B * S / ms * 1e3:.0f} tokens/s; flash launches a step "
          f"{launches}", flush=True)
    return {"ms": ms, "times": times}


def check_flash(ops, ref, x, causal: bool = True, window: int = 0,
                cap: float = 0.0) -> None:
    """The kernel against its plain version; past CHECK_SEQ keys, on the
    first batch row's first two heads only (each (row, head) is computed
    apart, and the plain version holds whole (S, S) score planes)."""
    kw = dict(causal=causal, window=window, cap=cap)
    got = ops.flash_attention_fwd(*x, **kw)
    if x[1].shape[2] > CHECK_SEQ:
        x, got = tuple(a[:1, :2] for a in x), got[:1, :2]
    want = ref.flash_attention_ref(*x, **kw)
    e = float((got.float() - want.float()).abs().max())
    if not e <= 2e-2:
        raise SystemExit(f"flash kernel max err {e} > 2e-2")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default="packed,plane,rerank,flash")
    ap.add_argument("--slab-q", type=int, choices=(4, 8, 16))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA: this script times kernels on a GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.load_library()
    print(f"src {args.src}: kernels built in "
          f"{_build.BUILD_INFO['seconds']:.2f} s", flush=True)
    if args.slab_q:
        if not hasattr(ops, "_slab_queries"):
            raise SystemExit(f"src {args.src}: no slab width to force")
        ops._slab_queries = lambda T: args.slab_q
        print(f"slab pass forced to {args.slab_q} queries", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {}
    only = args.only.split(",")
    benches = {"packed": bench_packed, "plane": bench_plane,
               "rerank": bench_rerank, "flash": bench_flash,
               "hubert": bench_hubert, "rows": bench_rows, "bwd": bench_bwd,
               "step": bench_step}
    for key in only:
        out[key] = benches[key](ops, ref, gen, args.iters)
        torch.cuda.empty_cache()
    print(json.dumps({"src": args.src, "slab_q": args.slab_q,
                      **{k: {str(kk): vv for kk, vv in v.items()}
                         for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
