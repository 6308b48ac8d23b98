"""Byte/FLOP profile of one dry-run cell — the port of the JAX package's
``launch/profile_cell.py``.

The JAX package walks the compiled HLO and prints its biggest
contributors, loop-weighted, by instruction and op name.  Here the cell
is counted as ``launch/dryrun.py`` counts it (rank 0 of the production
mesh, on ``meta``) with ``launch.op_cost.OpCounter(scopes=True)``, and
the count is broken down, biggest bytes first, by ATen op and by scope:
the chain of the port's functions on the Python stack (``train_step`` /
``loss_fn`` / ``forward`` / ``unit_fn`` / ``_attn_layer`` / ...), cut at
``--depth`` — the role of the reference's op names.  Rows under
``--min-gb`` are left out.

With ``--device cuda`` it also runs the cell's step on the card under
``torch.profiler``, at mesh (1, 1) and the largest batch (the rank's,
halved until the count fits one card) whose count fits the card, with
random weights, and prints the measured device time of its kernels
beside the counted FLOPs and bytes of the same step.  Every printed
number stands beside the card's name and power limit (``nvidia-smi``),
or says that it was counted on ``meta``.

    python -m repro_torch.launch.profile_cell --arch command-r-35b --shape train_4k
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import torch

from ..configs.registry import ARCH_IDS, get_config
from ..models.config import SHAPES
from .dryrun import MODEL_AXIS, production_mesh, trace_cell
from .mesh import CountingMesh


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no card (counted on meta)"


def breakdown(cost, depth: int, min_bytes: float, top: int = 12):
    """Rows (scope, bytes, flops) of the count by scope cut at ``depth``,
    biggest bytes first, at least ``min_bytes``."""
    by_scope: dict = {}
    for scope, (f, b) in cost.scopes.items():
        key = "/".join(scope[:depth])
        rec = by_scope.setdefault(key, [0.0, 0.0])
        rec[0] += b
        rec[1] += f
    scopes = sorted(((k, b, f) for k, (b, f) in by_scope.items()
                     if b >= min_bytes), key=lambda r: -r[1])[:top]
    return scopes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--min-gb", type=float, default=0.2)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--device", default="meta",
                    help="meta (count only, the default) or cuda (also "
                         "profile the step on the card)")
    args = ap.parse_args(argv)

    where = card_line() if args.device == "cuda" else \
        "counted on meta, no card"
    mesh = production_mesh(args.multi)
    rec, cost = trace_cell(args.arch, args.shape, mesh, scopes=True)
    print(f"[{where}] {args.arch} x {args.shape} at {rec['mesh']}, rank 0: "
          f"flops {cost.flops:.3e} bytes {cost.bytes:.3e} coll "
          f"{cost.total_coll_bytes:.3e} peak {cost.peak_bytes:.3e} B")
    min_bytes = args.min_gb * 1e9
    print(f"by op (bytes >= {args.min_gb} GB; kernels by formula):")
    for name, (calls, f, b) in sorted(cost.by_op.items(),
                                      key=lambda kv: -kv[1][2])[:12]:
        if b >= min_bytes:
            tag = "kernel " if name in cost.kernels else ""
            print(f"  {tag}{name}: {calls} calls -> {b:.2e} B {f:.2e} F")
    print(f"by scope, depth {args.depth}:")
    for key, b, f in breakdown(cost, args.depth, min_bytes):
        print(f"  {key} -> {b:.2e} B {f:.2e} F")
    if args.device == "cuda":
        profile_on_card(args, where)
    return 0


def profile_on_card(args, where: str) -> None:
    """The cell's step on the card at mesh (1, 1) under ``torch.profiler``
    beside its count (module doc)."""
    from torch.profiler import ProfilerActivity, profile

    from ..distributed.sharding import use_mesh
    from ..models import model as M
    from ..models.io import batch_specs_for
    from ..optim.adamw import Hyper, adamw_init
    from ..train.steps import make_train_step
    shape = SHAPES[args.shape]
    if shape.kind != "train":
        print(f"[{where}] --device cuda profiles train cells only")
        return
    cfg = get_config(args.arch, pad_for_mesh=True, model_axis=MODEL_AXIS)
    one = CountingMesh((1, 1), ("data", "model"))
    prod = production_mesh(args.multi)
    batch = max(shape.global_batch // (prod.shape["data"] * prod.shape.get(
        "pod", 1)), 1)
    while True:
        rec, cost = trace_cell(args.arch, args.shape, one, cfg=cfg,
                               shape=dataclasses.replace(
                                   shape, global_batch=batch))
        if rec["fits"] or batch == 1:
            break
        batch //= 2
    if not rec["fits"]:
        print(f"[{where}] {args.arch}: one rank's step does not fit one "
              f"card ({rec['memory']['total_bytes'] / 1e9:.1f} GB counted)")
        return
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cuda")
    opt = adamw_init(params)
    mb = rec.get("num_microbatches", 1)
    step = make_train_step(cfg, Hyper(), num_microbatches=mb)
    data = {k: torch.randint(0, cfg.vocab, tuple(v.shape), dtype=v.dtype,
                             device="cuda") if v.dtype == torch.int32
            else torch.randn(tuple(v.shape), device="cuda")
            for k, v in batch_specs_for(cfg, batch, shape.seq_len,
                                        True).items()}
    with use_mesh(one):
        step(params, opt, data)                        # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, opt, data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in events)
    print(f"[{where}] measured at mesh (1, 1), batch {batch} x "
          f"{shape.seq_len}: step {wall * 1e3:.2f} ms wall, kernels "
          f"{dev_us / 1e3:.2f} ms device time; counted {cost.flops:.3e} "
          f"FLOPs ({cost.flops / max(wall, 1e-9) / 1e12:.1f} TFLOP/s "
          f"achieved) and {cost.bytes:.3e} bytes; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, counted "
          f"{rec['memory']['total_bytes'] / 1e9:.2f} GB")
    top = sorted(events, key=lambda e: -getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
    for e in top[:10]:
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        print(f"  [{where}] {e.key[:60]}: {t / 1e3:.2f} ms, {e.count} calls")


if __name__ == "__main__":
    sys.exit(main())
