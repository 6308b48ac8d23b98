"""Dry-run of the paper-technique cell: the sharded bST similarity search
on the production mesh, one trie shard a rank (512 shards on the
multi-pod mesh) — the port of the JAX package's
``launch/dryrun_search.py``.

The JAX package lowers one SPMD program over every shard and reads its
HLO.  The port's search is data-dependent — the τ-ladder and the
frontier widths sync with the host — so it cannot run on ``meta``
tensors.  Instead the index is built for every shard
(``core.distributed_search.build_sharded_bst``: the shared layer plan),
and ONE shard's search — rank 0's — runs for real (CPU tensors, or the
card with ``--device cuda``) under ``launch.op_cost.OpCounter``, the
scan and verify kernels counted by formula (``kernels/ops.py``).  The
final result all-gather (each rank's (m, n_shard) mask and distance
planes, over every mesh axis) is reckoned from its shapes on a
``launch.mesh.CountingMesh``.  The record keeps the model cells' schema.

    python -m repro_torch.launch.dryrun_search [--mesh both] [--n 131072]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..core import distributed_search as ds
from ..core.cost_model import frontier_capacities
from ..core.hamming import resolve_device
from . import op_analysis
from .dryrun import DEFAULT_OUT, mesh_name, production_mesh
from .op_cost import OpCounter


def one_shard(index: ds.ShardedBST, s: int = 0) -> ds.ShardedBST:
    """Shard ``s`` of ``index`` as an index of one shard, under the
    shared layer plan."""
    def cut(x):
        return None if x is None else x[s:s + 1]
    levels = tuple(lv._replace(words=cut(lv.words), cum=cut(lv.cum),
                               labels=cut(lv.labels))
                   for lv in index.levels)
    return index._replace(levels=levels, t=cut(index.t),
                          paths_vert=cut(index.paths_vert),
                          d_words=cut(index.d_words), d_cum=cut(index.d_cum),
                          leaf_root=cut(index.leaf_root),
                          id_leaf=cut(index.id_leaf),
                          n_local=cut(index.n_local))


def search_cell(db: np.ndarray, b: int, mesh, *, tau: int, queries: int,
                caps_mode: str = "worst", device="cpu", seed: int = 0):
    """Build the shards, run rank 0's search under the counter; returns
    the record (``status`` ok) and the cost."""
    dev = resolve_device(device)
    n_shards = mesh.size
    t0 = time.perf_counter()
    index = ds.build_sharded_bst(db, b, n_shards, device=dev)
    build_s = time.perf_counter() - t0
    t_host = ds._t_host(index)
    t_max = tuple(int(x) for x in t_host.max(axis=0))
    caps = (ds.expected_caps(t_max, index.b, tau) if caps_mode == "expected"
            else frontier_capacities(t_max, index.b, tau, 1 << 14))
    shard = one_shard(index)
    rng = np.random.default_rng(seed + 1)
    qs = torch.from_numpy(rng.integers(0, 1 << b, size=(queries, db.shape[1]),
                                       dtype=np.int64).astype(np.int32)
                          ).to(dev)
    arg_bytes = shard.array_bytes() + qs.numel() * qs.element_size()
    t0 = time.perf_counter()
    with OpCounter() as counter:
        masks, dists, ov = ds._shard_search_batch(shard, t_host[:1], qs,
                                                  tau, caps)
        # the result gather: every rank's (m, n_max) planes, over every
        # mesh axis (reckoned from the shapes; the counting mesh records)
        for plane in (masks[0], dists[0]):
            part = torch.empty(plane.shape, dtype=plane.dtype, device="meta")
            for axis in reversed(mesh.axis_names):
                part = mesh.all_gather(part, axis, dim=0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    cost = counter.finish(mesh)
    roof = op_analysis.Roofline(
        flops_per_device=cost.flops, hbm_bytes_per_device=cost.bytes,
        collective_bytes_by_axis=dict(cost.coll_by_axis),
        axis_rates={a: op_analysis.axis_rate(mesh, a)
                    for a in mesh.axis_names})
    stats = op_analysis.collective_stats(mesh)
    record = {
        "arch": "bst-sharded-search",
        "shape": f"n{db.shape[0]}_q{queries}_tau{tau}_scan_{caps_mode}",
        "mesh": mesh_name(mesh), "chips": n_shards, "kind": "search",
        "device": f"one shard on {dev.type}, counted", "status": "ok",
        "build_s": round(build_s, 1), "trace_s": round(trace_s, 2),
        "cost": {"flops": cost.flops, "bytes": cost.bytes,
                 "bytes_note": cost.bytes_note,
                 "kernels": {k: {"calls": v[0], "flops": v[1],
                                 "bytes": v[2]}
                             for k, v in cost.kernels.items()}},
        "collectives": {
            "bytes_by_kind": {k: int(v) for k, v in cost.coll_bytes.items()},
            "count_by_kind": {k: int(v) for k, v in cost.coll_count.items()},
            "total_bytes": int(cost.total_coll_bytes),
            "largest_static": [{"kind": k, "bytes": b_, "shape": s}
                               for k, b_, s in stats.largest[:8]]},
        "memory": {"argument_bytes": int(arg_bytes),
                   "temp_bytes": int(cost.peak_bytes),
                   "total_bytes": int(arg_bytes + cost.peak_bytes)},
        "op_census_top": dict(sorted(cost.census.items(),
                                     key=lambda kv: -kv[1])[:15]),
        "roofline": roof.summary(),
        "overflow": int(ov.sum()),
    }
    record["fits"] = record["memory"]["total_bytes"] <= \
        op_analysis.HBM_CAPACITY_BYTES
    return record, cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--L", type=int, default=32)
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--caps", default="worst", choices=["worst", "expected"])
    ap.add_argument("--device", default="cpu",
                    help="cpu (default) or cuda: where rank 0's shard runs")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    rng = np.random.default_rng(0)
    db = rng.integers(0, 1 << args.b, size=(args.n, args.L), dtype=np.uint8)
    os.makedirs(args.out, exist_ok=True)
    for name in meshes:
        mesh = production_mesh(name == "multi")
        print(f"[search-cell] building {mesh.size} trie shards ...",
              flush=True)
        record, _ = search_cell(db, args.b, mesh, tau=args.tau,
                                queries=args.queries, caps_mode=args.caps,
                                device=args.device)
        tag = f"{record['mesh']}__bst-sharded-search__{record['shape']}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
        r = record["roofline"]
        print(f"  ok: build {record['build_s']}s trace {record['trace_s']}s"
              f" | Tm {r['t_memory_s']:.6f} Tcoll {r['t_collective_s']:.6f}"
              f" | mem {record['memory']['total_bytes'] / 1e6:.1f} MB",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
