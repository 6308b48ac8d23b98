"""Multi-pod dry-run: count one rank's work for every (architecture x
input shape x mesh) cell — the port of the JAX package's
``launch/dryrun.py``.

The JAX package lowers and compiles each cell against 512 placeholder
devices and reads XLA's HLO.  Here ``trace_cell`` runs the same step
function (``train.steps``' train, prefill or decode step) on ``meta``
tensors at one rank's shapes: the parameters and the optimizer state at
the rank's training placement (``distributed.sharding.train_specs``),
the rank's rows of ``models.io.input_specs``' batch, under
``launch.op_cost.OpCounter`` and a ``launch.mesh.CountingMesh`` of the
production mesh's shape, whose collectives compute nothing and record
themselves.  Nothing is computed and no card is needed; the hand-written
kernels are counted by formula (``kernels/ops.py``).

A record keeps the reference's keys: ``memory`` (arguments, outputs,
the counted peak of live temporaries, their total), ``cost`` (the
reference's ``hlo_cost``: FLOPs and bytes), ``collectives`` (by kind,
``largest_static``), ``op_census_top``, ``roofline`` with the H100's
peaks (``launch/op_analysis.py``), ``param_count``, ``model_flops_*`` and
``useful_flops_ratio``, and ``num_microbatches`` for a train cell;
``trace_s`` takes the place of ``lower_s`` / ``compile_s``.  A train
step is counted at one and two units and at two and three microbatches
and extrapolated (``_train_count``: the units are identical and so are
the microbatches, so every tally is linear in each number).  It adds
``fits`` (the rank's total within an H100's 80 GB) and
``tensor_parallel``: the "model" axis's ranks and how many dense leaves
(heads, ffn, vocabulary, SSM d_inner) it splits and how many the
divisibility fallback keeps whole on it.  The dense layers run tensor
parallel as the placement puts them (``models/model.py``), so the
records count the rank's slices and the sums over "model".  A cell that
fails is recorded with ``status: error``.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --mesh multi
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --all --shape train_4k
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from ..configs.registry import ARCH_IDS, all_cells, get_config, skipped_cells
from ..distributed.sharding import (dp_shards, leaf_logical, model_ranks,
                                     shard_state, use_mesh)
from ..models import model as M
from ..models.config import SHAPES
from ..models.io import batch_specs_for
from ..optim.adamw import Hyper, adamw_init
from ..train.steps import make_decode_step, make_prefill_step, make_train_step
from . import op_analysis
from .mesh import CountingMesh
from .op_cost import Cost, OpCounter

MODEL_AXIS = 16
# The reference's remat-stash budget (repro/launch/dryrun.py:39): bytes of
# per-unit residuals a device stashes before the step is microbatched —
# the reference's own figure, kept so that both packages pick the same
# microbatches; not an H100 figure.
STASH_BUDGET = 2e9
DEFAULT_OUT = os.path.join("build", "dryrun")


def production_mesh(multi_pod: bool) -> CountingMesh:
    """``launch.mesh.make_production_mesh``'s shape as a counting mesh
    (rank 0's view)."""
    if multi_pod:
        return CountingMesh((2, 16, 16), ("pod", "data", "model"))
    return CountingMesh((16, 16), ("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def pick_microbatches(cfg, shape, mesh) -> int:
    """The reference's microbatch count, by its arithmetic."""
    dp = dp_shards(mesh)
    b_local = max(shape.global_batch // dp, 1)
    # remat stash: per-unit residual inputs
    stash = cfg.num_layers * b_local * shape.seq_len * cfg.d_model * 2
    # MoE dispatch transient: per-layer (E, cap, d + 2·ff) bf16 per device
    if cfg.n_experts:
        tok_dev = b_local * shape.seq_len
        cap = tok_dev * cfg.top_k * cfg.capacity_factor / max(cfg.n_experts, 1)
        moe_transient = (cfg.n_experts * cap
                         * (cfg.d_model + 2 * cfg.moe_d_ff) * 2)
        stash = max(stash, moe_transient * cfg.num_layers // 8)
    mb = 1
    while stash / mb > STASH_BUDGET and mb * dp < shape.global_batch:
        mb *= 2
    return mb


def _bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten
    seen, total = set(), 0
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            xs = list(x.parameters())
        elif isinstance(x, torch.Tensor):
            xs = [x]
        else:
            continue
        for t in xs:
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
    return total


def rank_state(cfg, mesh):
    """(parameters, optimizer state) of rank 0 of ``mesh`` at the
    training placement: shapes and dtypes on the ``meta`` device."""
    params = shard_state(M.abstract_params(cfg), mesh)
    return params, adamw_init(params)


def tensor_parallel(cfg, mesh) -> dict:
    """The "model" axis's ranks, and the dense leaves (every leaf outside
    the MoE blocks whose rule names "model") it splits and keeps whole
    (the divisibility fallback) at ``mesh``'s placement."""
    specs, shapes = M.placement(cfg, mesh)
    split = whole = 0
    for name, spec in specs.items():
        if ".moe." in name or "model" not in leaf_logical(
                name, len(shapes[name])):
            continue
        split += "model" in spec
        whole += "model" not in spec
    return {"model_ranks": model_ranks(mesh), "dense_leaves_split": split,
            "dense_leaves_whole": whole}


def model_flops(cfg, shape) -> float:
    """The reference's useful FLOPs of a cell, over the global batch:
    6 (train) or 2 × the active parameters × the tokens."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6 if shape.kind == "train" else 2
    return factor * cfg.param_count(active_only=True) * tokens


def trace_cell(arch: str, shape_name: str, mesh, *, cfg=None, shape=None,
               scopes: bool = False, compute_dtype=torch.bfloat16,
               exact: bool = False):
    """Count one cell at rank 0 of ``mesh`` (a ``CountingMesh``); returns
    (record, cost).  ``cfg`` and ``shape`` (a ``ShapeConfig``) override
    the padded registry config and ``SHAPES[shape_name]``; ``exact``
    counts a train step whole, not extrapolated from smaller ones
    (``_train_count``), for a peak to hold against the card's."""
    cfg = cfg or get_config(arch, pad_for_mesh=True, model_axis=MODEL_AXIS)
    shape = shape or SHAPES[shape_name]
    dp = dp_shards(mesh)
    b_loc = max(shape.global_batch // dp, 1)
    groups = dp if cfg.n_experts else 1
    params, opt = rank_state(cfg, mesh)
    M.placement(cfg, mesh)          # built (and cached) outside the count
    t0 = time.perf_counter()
    if shape.kind == "train":
        mb = pick_microbatches(cfg, shape, mesh)
        arg_bytes = _bytes((params, opt, batch_specs_for(
            cfg, b_loc, shape.seq_len, True)))
        cost = _train_count(cfg, mesh, mb, b_loc // mb, shape.seq_len,
                            groups, scopes, compute_dtype, exact)
        record = analyze(cost, cfg, shape, mesh, arch=arch,
                         shape_name=shape_name, arg_bytes=arg_bytes,
                         out_bytes=0)
        record["num_microbatches"] = mb
        record["trace_s"] = round(time.perf_counter() - t0, 2)
        return record, cost
    with use_mesh(mesh):
        if shape.kind == "prefill":
            batch = batch_specs_for(cfg, b_loc, shape.seq_len, False)
            args = (params, batch)
            step = make_prefill_step(cfg, moe_groups=groups,
                                     compute_dtype=compute_dtype)
        else:
            cache = M.init_cache(cfg, b_loc, shape.seq_len, device="meta")
            tokens = (torch.empty((b_loc, 1, cfg.d_model), device="meta")
                      if cfg.inputs_embeds else
                      torch.empty((b_loc, 1), dtype=torch.int32,
                                  device="meta"))
            args = (params, tokens, cache, shape.seq_len - 1)
            step = make_decode_step(cfg, moe_groups=groups,
                                    compute_dtype=compute_dtype)
        arg_bytes = _bytes(args)
        with OpCounter(scopes=scopes) as counter:
            out = step(*args)
        cost = counter.finish(mesh)
    trace_s = time.perf_counter() - t0
    out_bytes = _bytes(out[0]) + (_bytes(out[1]) if shape.kind == "prefill"
                                  else 0)
    record = analyze(cost, cfg, shape, mesh, arch=arch,
                     shape_name=shape_name, arg_bytes=arg_bytes,
                     out_bytes=out_bytes)
    record["trace_s"] = round(trace_s, 2)
    return record, cost


def _train_cost(cfg, mesh, mb: int, rows: int, seq: int, groups: int,
                scopes: bool, compute_dtype):
    """The count of one train step of ``mb`` microbatches over ``rows``
    rows at rank 0 of ``mesh`` (``mesh.calls`` records its collectives)."""
    params, opt = rank_state(cfg, mesh)
    M.placement(cfg, mesh)          # built (and cached) outside the count
    step = make_train_step(cfg, Hyper(), num_microbatches=mb,
                           moe_groups=groups, compute_dtype=compute_dtype)
    batch = batch_specs_for(cfg, rows, seq, True)
    with use_mesh(mesh), OpCounter(scopes=scopes) as counter:
        step(params, opt, batch)
    return counter.finish(mesh)


def _train_count(cfg, mesh, mb: int, mb_rows: int, seq: int, groups: int,
                 scopes: bool, compute_dtype, exact: bool):
    """The count of a train step of ``mb`` microbatches of ``mb_rows``
    rows over ``cfg.n_units`` units, at rank 0 of ``mesh``, whose
    ``stats`` receive the step's collectives and ``calls`` those of the
    largest step counted (one of each static call, as the reference's
    ``largest_static`` reads them).

    The units are identical and so are the microbatches, so every tally
    is linear in each: unless ``exact``, where there are more than two
    units the step is counted at one and two units, where there are more
    than three microbatches at two and three, and the count extrapolated
    along each axis (``Cost.extrapolate``): FLOPs, bytes, kernels, ops
    and collectives exactly; the peak linearly in the units (the remat
    stash) and as the larger over the microbatches, within 10% of the
    whole step's (``tests/test_torch_dryrun.py``)."""
    small = exact or cfg.n_units <= 2
    units = (cfg.n_units,) if small else (1, 2)
    mbs = (mb,) if exact or mb <= 3 else (2, 3)
    grid = {}
    for u in units:
        sub = dataclasses.replace(cfg, num_layers=cfg.period * u)
        for m in mbs:
            part = CountingMesh(tuple(mesh.shape.values()), mesh.axis_names,
                                mesh.coords)
            grid[u, m] = (_train_cost(sub, part, m, mb_rows * m, seq, groups,
                                      scopes, compute_dtype), part)

    def along(pts, target, key, peak):
        if len(pts) == 1:
            return key(pts[0])
        (ca, sa), (cb, sb) = key(pts[0]), key(pts[1])
        k = target - pts[0]
        zero = [0, 0, 0.0]
        stats = {n: [sa.get(n, zero)[i] + k * (sb.get(n, zero)[i]
                                               - sa.get(n, zero)[i])
                     for i in range(2)] + [0.0]
                 for n in set(sa) | set(sb)}
        return Cost.extrapolate(ca, cb, k, peak), stats

    cost, stats = along(mbs, mb, lambda m: along(
        units, cfg.n_units, lambda u: (grid[u, m][0], grid[u, m][1].stats),
        "linear"), "max")
    mesh.stats.update(stats)
    mesh.calls.extend(grid[units[-1], mbs[-1]][1].calls)
    return cost


def analyze(cost, cfg, shape, mesh, *, arch, shape_name, arg_bytes,
            out_bytes):
    chips = mesh.size
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "chips": chips, "padded_dims": dict(cfg.logical),
        "kind": shape.kind, "device": "NVIDIA H100 80GB (counted on meta)",
        "tensor_parallel": tensor_parallel(cfg, mesh),
    }
    record["memory"] = {
        "argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
        "temp_bytes": int(cost.peak_bytes),
        "total_bytes": int(arg_bytes + cost.peak_bytes),
    }
    record["fits"] = record["memory"]["total_bytes"] <= \
        op_analysis.HBM_CAPACITY_BYTES
    record["cost"] = {"flops": cost.flops, "bytes": cost.bytes,
                      "bytes_note": cost.bytes_note,
                      "kernels": {k: {"calls": v[0], "flops": v[1],
                                      "bytes": v[2]}
                                  for k, v in cost.kernels.items()}}
    stats = op_analysis.collective_stats(mesh)
    record["collectives"] = {
        "bytes_by_kind": {k: int(v) for k, v in cost.coll_bytes.items()},
        "count_by_kind": {k: int(v) for k, v in cost.coll_count.items()},
        "total_bytes": int(cost.total_coll_bytes),
        "by_axis": {a: int(v) for a, v in cost.coll_by_axis.items()},
        "stats": {k: v[:2] for k, v in getattr(mesh, "stats", {}).items()},
        "largest_static": [{"kind": k, "bytes": b, "shape": s[:120]}
                           for k, b, s in stats.largest[:8]],
    }
    census = op_analysis.op_census(cost)
    record["op_census_top"] = dict(
        sorted(census.items(), key=lambda kv: -kv[1])[:15])

    n_params = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    useful = model_flops(cfg, shape)
    roof = op_analysis.Roofline(
        flops_per_device=cost.flops, hbm_bytes_per_device=cost.bytes,
        collective_bytes_by_axis=dict(cost.coll_by_axis),
        axis_rates={a: op_analysis.axis_rate(mesh, a)
                    for a in mesh.axis_names})
    record["roofline"] = roof.summary()
    record["roofline"].update({
        "param_count": n_params,
        "param_count_active": n_active,
        "model_flops_global": useful,
        "model_flops_per_chip": useful / chips,
        "useful_flops_ratio": (useful / chips / cost.flops
                               if cost.flops else 0.0),
    })
    return record


def run_cells(cells, meshes, out_dir, force=False):
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for name in meshes:
        multi = name == "multi"
        for arch, shape_name in cells:
            mesh = production_mesh(multi)
            tag = f"{mesh_name(mesh)}__{arch}__{shape_name}"
            path = os.path.join(out_dir, tag + ".json")
            if os.path.exists(path) and not force:
                print(f"[skip-cached] {tag}")
                continue
            print(f"[trace] {tag} ...", flush=True)
            try:
                record, _ = trace_cell(arch, shape_name, mesh)
                record["status"] = "ok"
            except Exception as e:
                record = {"arch": arch, "shape": shape_name,
                          "mesh": mesh_name(mesh), "status": "error",
                          "error": repr(e),
                          "traceback": traceback.format_exc()[-2000:]}
                print(f"  ERROR: {e!r}", flush=True)
            with open(path, "w") as f:
                json.dump(record, f, indent=1)
            if record["status"] == "ok":
                r, mem = record["roofline"], record["memory"]
                print(f"  ok: trace {record['trace_s']}s | Tc "
                      f"{r['t_compute_s']:.4f} Tm {r['t_memory_s']:.4f} "
                      f"Tcoll {r['t_collective_s']:.4f} -> "
                      f"{r['bottleneck']} | {mem['total_bytes'] / 1e9:.1f} "
                      f"GB a rank, fits {record['fits']}", flush=True)
            results.append(record)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every valid (arch, shape) cell")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:                          # --shape keeps one shape's cells
        cells = [c for c in all_cells() if args.shape in (None, c[1])]
        for arch, shape, reason in skipped_cells():
            if args.shape in (None, shape):
                print(f"[principled-skip] {arch} x {shape}: {reason}")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = run_cells(cells, meshes, args.out, force=args.force)
    n_err = sum(r.get("status") != "ok" for r in results)
    print(f"\ndone: {len(results)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
