"""Time the packed arena verify and the flash-attention forward of the
port on one GPU, at the shapes of ``chip_smoke.py``'s main paths.

    python3 tools/bench_hot_kernels.py [--src DIR] [--seed 0] [--iters 10]
                                       [--only packed,flash]

``--src`` is the ``src/`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees — say a parent commit
unpacked with ``git archive`` — are timed by the same script on the same
card, in turns.  Each kernel is first checked against its plain version
on the same inputs (bit-exact for the verify, 2e-2 for bf16 attention).
Every time is of the wrapper, two ways: one call between two events
(``wrapper``: its host work included, as a caller that waits on each
call sees it) and the mean of 20 calls queued back to back (``queued``:
the host works ahead of the card, so this is the kernel's own time
whenever the host's share of a call is the shorter).

  * packed: the segmented Review shape — one packed group, b = 2, S = 4,
    n = 12,582,912 columns, T = 6,818,030 roots, m = 64 queries — with
    synthetic lanes: random words, base_idx uniform over [0, T) (a
    column's root is random within its segment), 1% dead columns, a base
    plane of 0..5 with 60% BIG.  Prints the bound (bytes: lanes and the
    plane once, both outputs), a write-only floor (``fill_`` of the two
    (m, n) outputs) and the same call with base_idx sorted (coalesced
    gathers: what the random gathers still cost).
  * flash: the prefill's shape (B 8, H 9, S 2,000, D 64, bf16, causal),
    contiguous (B, H, S, D) and the model's strided (B, S, H, D) views,
    beside ``scaled_dot_product_attention``; the other head dims of
    ``ops.FLASH_HEAD_DIMS`` at the same B, H and S; the float32 route.

Needs CUDA; prints the card's name and power limit first, then one line
per measurement and a JSON line of the times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
BIG = 1 << 20


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


def both(fn, iters: int) -> dict:
    return {"wrapper": time_ms(fn, iters), "queued": queued_ms(fn)}


def bench_packed(ops, ref, gen, iters: int) -> dict:
    n, T, m, b, S = 12_582_912, 6_818_030, 64, 2, 4
    dev = torch.device("cuda")
    words = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                          device=dev, generator=gen)
    q = torch.randint(-2 ** 31, 2 ** 31, (m,), dtype=torch.int32, device=dev,
                      generator=gen)
    plane = torch.randint(0, 6, (m, T), dtype=torch.int32, device=dev,
                          generator=gen)
    plane[torch.rand((m, T), device=dev, generator=gen) < 0.6] = BIG
    idx = torch.randint(0, T, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    live = torch.rand(n, device=dev, generator=gen) >= 0.01
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
    q32, k32, v32 = q.float(), k.float(), v.float()
    out["f32"] = time_ms(lambda: ops.flash_attention_fwd(
        q32, k32, v32, causal=True), max(3, iters // 3))
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    t = out["bf16"]["queued"]
    print(f"flash (B={B} H={H} S={S} D={D} causal, {flops / 1e9:.1f} "
          f"GFLOP): bf16 wrapper {out['bf16']['wrapper']:.4f} ms, queued "
          f"{t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s); strided (B, S, H, "
          f"D) views wrapper {out['bf16_strided']['wrapper']:.4f}, queued "
          f"{out['bf16_strided']['queued']:.4f} ms; "
          f"scaled_dot_product_attention {out['sdpa']['wrapper']:.4f} / "
          f"{out['sdpa']['queued']:.4f} ms; float32 route "
          f"{out['f32']:.4f} ms; bound "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms (operations)", flush=True)
    return out


def check_flash(ops, ref, x) -> None:
    got = ops.flash_attention_fwd(*x, causal=True)
    want = ref.flash_attention_ref(*x, causal=True)
    e = float((got.float() - want.float()).abs().max())
    if not e <= 2e-2:
        raise SystemExit(f"flash kernel max err {e} > 2e-2")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default="packed,flash")
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
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {}
    only = set(args.only.split(","))
    if "packed" in only:
        out["packed"] = bench_packed(ops, ref, gen, args.iters)
        torch.cuda.empty_cache()
    if "flash" in only:
        out["flash"] = bench_flash(ops, ref, gen, args.iters)
    print(json.dumps({"src": args.src, **{k: {str(kk): vv for kk, vv in
                                               v.items()}
                                           for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
