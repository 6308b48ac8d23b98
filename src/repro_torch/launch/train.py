"""Training driver: ``python -m repro_torch.launch.train --arch
smollm-135m`` — the port of the JAX package's ``launch/train.py``.

The loop runs under ``use_mesh(make_host_mesh())``, as the JAX driver's
does: one process without a process group is a mesh of one rank; under
``python -m torch.distributed.run --nproc-per-node N`` every rank joins
a ("data",) mesh of N ranks (``launch.mesh.init_distributed``: nccl when
each rank has a card, gloo when they share one or run on the CPU),
holds its shards of the training placement (FSDP over "data") and takes
its rows of every step's batch (``batch_coord``); rank 0 prints and
writes the checkpoints, which stay logical (whole arrays), so a run
resumes on another number of ranks.  ``--model-ranks M`` lays the N
ranks out as a (N / M, M) mesh over ("data", "model") instead: the
dense layers train tensor parallel over "model" (the placement's heads,
ffn and vocabulary, where M divides them; the experts over "model"
too), FSDP over "data".  At the end every rank prints its flash and
verify launches (``kernels.ops.kernel_stats``).

Wires together the substrate: the sketch-dedup'd data pipeline
(``--dedup``: each step's candidates are minhashed on the device and
searched against the history bST by the verify kernel), float32 master
parameters with bf16 compute (float32 on the CPU), the flash kernels'
forward and FA-2 backward in every attention layer, AdamW, microbatched
gradient accumulation, async checkpoints (``--ckpt-dir``), the restart
drill (``--fail-at N`` exits 13 at step N; a rerun with the same
``--ckpt-dir`` resumes from the latest checkpoint) and the straggler
monitor.  ``--device`` is ``cuda`` by default and raises without a
card; ``--device cpu`` runs the plain kernels.  Weights are drawn from
``--seed`` by a CPU generator, so both devices start from the same
parameters; ``--device-init`` draws them with a generator on the device
instead (seconds where the CPU's draws of a few billion weights take
minutes; the same seed gives other weights than the CPU's).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from ..configs.registry import ARCH_IDS, get_config
from ..core.hamming import resolve_device
from ..data.pipeline import DataConfig, SketchDedupPipeline
from ..distributed.checkpoint import AsyncCheckpointer
from ..distributed.fault_tolerance import (FailurePlan, SimulatedFailure,
                                           StragglerMonitor, resume_or_init)
from ..distributed.sharding import shard_state, use_mesh
from ..kernels import ops
from ..launch.mesh import batch_coord, dp_shards, init_distributed, \
    make_host_mesh, shutdown_distributed
from ..models import model as M
from ..optim.adamw import Hyper, abstract_opt_state, adamw_init
from ..train.steps import make_train_step


def main(argv=None, on_step=None):
    """Run the loop; returns 0, or 13 from the drill.  ``on_step(step,
    metrics)``, when given, sees every step's metrics (0-d tensors on the
    device) as the step returns them.  A caller that started a process
    group itself runs the loop over all its ranks."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--dedup", action="store_true",
                    help="near-duplicate-filter batches through bST")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (restart drill)")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="ranks on the \"model\" axis (tensor parallelism "
                         "of the dense layers); the rest on \"data\"")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-init", action="store_true",
                    help="draw the weights with a generator on --device")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = not dist.is_initialized() and init_distributed(args.device)
    clean = False
    try:
        mesh = make_host_mesh(args.model_ranks)
        with use_mesh(mesh):
            rc = _loop(args, dev, mesh, on_step)
        del mesh               # the teardown frees it and the groups it holds
        clean = True
    finally:
        if started:
            shutdown_distributed(clean=clean)
    return rc


def _loop(args, dev, mesh, on_step):
    n, coord = dp_shards(mesh), batch_coord(mesh)
    if args.batch % n:
        raise ValueError(f"batch {args.batch} does not split over {n} ranks")
    rows = args.batch // n
    rank = dist.get_rank() if dist.is_initialized() else 0
    lead = rank == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    cfg = get_config(args.arch, smoke=args.smoke)
    hyper = Hyper(base_lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                  total_steps=args.steps)
    data = SketchDedupPipeline(
        DataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                   seed=args.seed, dedup=args.dedup,
                   embeds_dim=cfg.d_model if cfg.inputs_embeds else 0),
        device=dev)
    step_fn = make_train_step(
        cfg, hyper, num_microbatches=args.microbatches,
        compute_dtype=torch.float32 if dev.type == "cpu" else torch.bfloat16)

    abstract = M.abstract_params(cfg)
    specs, _ = M.placement(cfg, mesh)
    ckpt = AsyncCheckpointer(args.ckpt_dir, mesh=mesh) if args.ckpt_dir \
        else None
    plan = FailurePlan(args.fail_at) if args.fail_at >= 0 else None
    monitor = StragglerMonitor(n_workers=1)

    def init():
        gen = torch.Generator(device=dev if args.device_init else "cpu")
        return shard_state(M.init_params(gen.manual_seed(args.seed), cfg,
                                         device=dev), mesh)

    if args.ckpt_dir:
        state_abs = {"params": abstract, "opt": abstract_opt_state(abstract)}
        state, start = resume_or_init(
            args.ckpt_dir, state_abs, lambda: {"params": init(), "opt": None},
            device=dev, mesh=mesh)
        params = state["params"]
        opt = state["opt"] if start else adamw_init(params)
        if start:
            say(f"[resume] from step {start}")
    else:
        params, start = init(), 0
        opt = adamw_init(params)

    before = ops.kernel_stats()
    t_last = time.time()
    for step in range(start, args.steps):
        if plan is not None:
            try:
                plan.maybe_fail(step)
            except SimulatedFailure as e:
                say(f"[drill] {e}; exiting non-zero for the restart "
                    "wrapper")
                if ckpt:
                    ckpt.wait()
                return 13
        batch = data.batch_for_step(step)
        if n > 1:
            batch = {k: v[coord * rows:(coord + 1) * rows]
                     for k, v in batch.items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if on_step is not None:
            on_step(step, metrics)
        if (step + 1) % args.log_every == 0 or step == start:
            dt = time.time() - t_last
            t_last = time.time()
            monitor.observe([dt])
            say(f"step {step + 1:5d}  loss {float(metrics['loss']):.4f}"
                f"  gnorm {float(metrics['grad_norm']):.3f}"
                f"  lr {float(metrics['lr']):.2e}  ({dt:.2f}s)",
                flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt}, specs)
    if ckpt:
        ckpt.wait()
    launched = {k: v - before.get(k, 0) for k, v in ops.kernel_stats().items()
                if k.startswith(("flash_attention", "sparse_verify_batch"))}
    print(f"[rank {rank}] kernel launches over {args.steps - start} "
          f"steps: {launched}", flush=True)
    say("train: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
