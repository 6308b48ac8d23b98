"""The dry-run tooling on the ``meta`` device (``launch/dryrun.py``,
``op_cost.py``, ``op_analysis.py``, ``dryrun_search.py``,
``profile_cell.py`` and ``launch.mesh.CountingMesh``) against the JAX
package's ``launch/dryrun.py`` and ``hlo_cost.py``.

  * ``pick_microbatches``, the parameter counts and the model FLOPs equal
    the reference's for every cell on both production meshes;
  * one matrix product's FLOPs equal ``hlo_cost.analyze_hlo`` of the same
    dot compiled by JAX;
  * the flash wrappers on ``meta`` count their formula and none of the
    plain version's ops, and return empty outputs of the kernel's shapes;
    so does the MI-bST candidate verify under ``mi_column_dists`` (every
    slot counted valid on ``meta``, the real counts on the CPU);
  * the counting mesh's collective calls and bytes for
    ``moe_apply_sharded``'s forward and backward at (1, 2) and (2, 2)
    equal ``Mesh.stats`` of real 2- and 4-rank gloo runs;
  * one SMOKE train cell's FLOPs stay within 25% of JAX's ``hlo_cost``
    for the same step on one device.  Measured (float32, one device,
    B x S = 4 x 64): smollm-135m 0.798 of JAX's count, and 0.74–0.82 over
    smollm, granite-moe and mamba2 at 4 x 64 and 8 x 128.  The port is
    lower: the flash kernels are counted at the visible (causal) pairs,
    where JAX's plain flash computes every pair of its blocks, and the
    element-wise counts differ (one per output element of every eager
    op against every HLO instruction);
  * smollm-135m ``train_4k`` at (16, 16) traces at full size, and its
    ``argument_bytes`` are the rank's shards, moments and rows exactly;
  * the CLI writes a record with the reference's keys under ``--out``;
    the search cell and the profile run on the CPU.

The JAX dry-run modules set ``XLA_FLAGS`` when imported; the tests import
``repro.launch.dryrun`` with the environment restored right after.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import moe_stats_worker, run_ranks
from repro.configs.registry import all_cells as jall_cells
from repro.configs.registry import get_config as jget_config
from repro.launch import hlo_cost
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models.config import SHAPES as JSHAPES
from repro.optim.adamw import Hyper as JHyper
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.registry import all_cells, get_config
from repro_torch.core import multi_index as tmi
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, dryrun_search, profile_cell
from repro_torch.launch.mesh import CountingMesh
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models import flash
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.moe_sharded import (moe_apply_sharded,
                                            shard_moe_params)


def _jax_dryrun():
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdryrun


CELLS = [(a, s, m) for a, s in all_cells() for m in ("single", "multi")]


def test_cells_are_the_reference_s():
    assert all_cells() == jall_cells()


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_microbatches_and_counts_match_jax(arch, shape, mesh):
    jdryrun = _jax_dryrun()
    cfg = get_config(arch, pad_for_mesh=True, model_axis=dryrun.MODEL_AXIS)
    jcfg = jget_config(arch, pad_for_mesh=True,
                       model_axis=jdryrun.MODEL_AXIS)
    m = dryrun.production_mesh(mesh == "multi")
    assert dryrun.STASH_BUDGET == jdryrun.STASH_BUDGET
    assert dryrun.pick_microbatches(cfg, SHAPES[shape], m) == \
        jdryrun.pick_microbatches(jcfg, JSHAPES[shape], m)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(active_only=True) == \
        jcfg.param_count(active_only=True)
    js = JSHAPES[shape]
    tokens = js.global_batch * (js.seq_len if js.kind != "decode" else 1)
    want = (6 if js.kind == "train" else 2) * jcfg.param_count(
        active_only=True) * tokens
    assert dryrun.model_flops(cfg, SHAPES[shape]) == want


@pytest.mark.parametrize("M,K,N,batch", [(64, 128, 32, 0), (17, 40, 9, 0),
                                         (16, 32, 24, 3)])
def test_dot_flops_match_hlo_cost(M, K, N, batch):
    lead = (batch,) if batch else ()
    a = jnp.zeros(lead + (M, K), jnp.float32)
    b = jnp.zeros(lead + (K, N), jnp.float32)
    txt = jax.jit(jnp.matmul).lower(a, b).compile().as_text()
    want = hlo_cost.analyze_hlo(txt).flops
    with OpCounter() as c:
        torch.matmul(torch.empty(lead + (M, K), device="meta"),
                     torch.empty(lead + (K, N), device="meta"))
    assert c.cost.flops == want == 2 * max(batch, 1) * M * N * K


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (False, 0, 0),
                                                    (True, 96, 0),
                                                    (True, 0, 37)])
def test_flash_on_meta_counts_its_formula(causal, window, q_offset):
    B, H, Sq, Skv, D = 2, 3, 200, 237, 64
    q = torch.empty((B, H, Sq, D), dtype=torch.bfloat16, device="meta")
    k, v = (torch.empty((B, H, Skv, D), dtype=torch.bfloat16,
                        device="meta") for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with OpCounter() as c:
        out, lse = ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, out, **kw)
    pos = np.arange(Sq)[:, None] + q_offset
    key = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= key <= pos
    if window:
        vis &= pos - key < window
    pairs = B * H * int(vis.sum())
    assert c.cost.kernels == {
        "flash_attention_fwd": [1, 4 * pairs * D,
                                2 * 2 * B * H * (Sq + Skv) * D
                                + 4 * B * H * Sq],
        "flash_attention_bwd": [1, 10 * pairs * D,
                                2 * 4 * B * H * (Sq + Skv) * D
                                + 4 * B * H * Sq]}
    assert set(c.cost.by_op) == set(c.cost.kernels)   # no plain-version op
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]


def gather_formula(b, W, m, C, V):
    """The candidate verify's (operations, bytes) over V valid slots: the
    bound's reckoning of PERF.md's row 2b (V ids and their b·W words
    read, m·C outputs written, the query words and counts read)."""
    return V * W * (2 * b + 1), (4 * V + 4 * b * W * V + 4 * m * C
                                 + 4 * (b * W * m + m))


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_mi_column_dists_counts_the_gather_verify(device, monkeypatch):
    """``mi_column_dists`` under an ``OpCounter`` records one
    ``hamming_distances_gather`` by its formula — V every slot on
    ``meta``, the clamped counts' sum on the CPU — and the wrapper
    returns an (m, C) int32 plane."""
    rng = np.random.default_rng(11)
    b, L, n, m, tau = 2, 40, 400, 9, 3
    db = rng.integers(0, 1 << b, size=(n, L)).astype(np.uint8)
    mi = tmi.build_multi_index(db, b, 2, device=device)
    caps, cc = tmi.mi_trace_params(mi, tau)
    qs = torch.from_numpy(db[:m].astype(np.int32)).to(device)
    seen = {}
    real = ops.hamming_distances_gather

    @functools.wraps(real)          # counted under the wrapper's name
    def spy(*a, **kw):
        seen["args"], seen["out"] = a, real(*a, **kw)
        return seen["out"]
    monkeypatch.setattr(ops, "hamming_distances_gather", spy)
    with OpCounter() as c:
        dist, overflow = tmi.mi_column_dists(mi, qs, tau, caps, cc)
    _, _, ids, counts = seen["args"]
    C = ids.shape[1]
    assert C == min(cc, n)
    V = m * C if device == "meta" else int(counts.sum())
    assert 0 < V <= m * C
    W = (L + 31) // 32
    assert c.cost.kernels["hamming_distances_gather"] == [
        1, *map(float, gather_formula(b, W, m, C, V))]
    out = seen["out"]
    assert out.shape == (m, C) and out.dtype == torch.int32
    assert out.is_meta == (device == "meta")
    assert dist.shape == (m, n) and dist.dtype == torch.int32
    if device == "cpu":
        want, _ = tmi.mi_column_dists(mi, qs, tau, caps, cc)
        assert torch.equal(dist, want)


def test_flash_attention_autograd_on_meta_counts_the_kernels():
    """``models.flash.flash_attention`` under autograd on ``meta``: one
    forward with lse and one backward counted by formula; the
    blockwise plain version never runs."""
    q = torch.empty((2, 64, 4, 16), device="meta", requires_grad=True)
    k, v = (torch.empty((2, 64, 2, 16), device="meta", requires_grad=True)
            for _ in range(2))
    with OpCounter() as c:
        flash.flash_attention(q, k, v, causal=True).sum().backward()
    assert {k: v[0] for k, v in c.cost.kernels.items()} == {
        "flash_attention_fwd": 1, "flash_attention_bwd": 1}
    assert "exp" not in c.cost.by_op and "amax" not in c.cost.by_op
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def _moe_case():
    params = JMOE.moe_init(jax.random.PRNGKey(0), 32, 8, 16, 1,
                           jnp.float32)
    x = np.random.default_rng(0).standard_normal((4, 6, 32)).astype(
        np.float32)
    return jax.tree_util.tree_map(np.asarray, params), x


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def real_stats(tmp_path_factory):
    params, x = _moe_case()
    tmp = tmp_path_factory.mktemp("moe_stats")
    payload = dict(params=params, x=x, cf=0.5)
    return {2: run_ranks(moe_stats_worker, 2, tmp,
                         dict(payload, meshes=[(1, 2)])),
            4: run_ranks(moe_stats_worker, 4, tmp,
                         dict(payload, meshes=[(2, 2)]))}


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2))])
def test_counting_mesh_records_the_real_collectives(world, shape,
                                                    real_stats):
    """``moe_apply_sharded``'s forward and backward on ``meta`` at rank 0
    of a counting mesh record the calls and bytes ``Mesh.stats`` records
    on every rank of a real gloo group."""
    params, x = _moe_case()
    mesh = CountingMesh(shape, ("data", "model"))
    rows = x.shape[0] // shape[0]
    xm = torch.empty((rows,) + x.shape[1:], device="meta",
                     requires_grad=True)
    shards = shard_moe_params(_t(params), mesh)
    metas = {}
    for k, v in shards.items():
        if isinstance(v, dict):
            metas[k] = {kk: torch.empty(vv.shape, device="meta",
                                        requires_grad=True)
                        for kk, vv in v.items()}
        else:
            metas[k] = torch.empty(v.shape, device="meta",
                                   requires_grad=True)
    moe_apply_sharded(metas, xm, mesh, top_k=2, act="silu",
                      capacity_factor=0.5).sum().backward()
    counted = {k: v[:2] for k, v in mesh.stats.items()}
    assert counted
    for rank in real_stats[world]:
        assert rank[shape] == counted


def test_smoke_train_cell_flops_near_hlo_cost():
    """smollm-135m SMOKE, one float32 train step of 4 x 64 tokens on one
    device: the port's count within 25% of JAX's ``hlo_cost`` (module
    doc: measured 0.798)."""
    arch, B, S = "smollm-135m", 4, 64
    jcfg = jget_config(arch, smoke=True)
    p = JM.init_params(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": jnp.zeros((B, S), jnp.int32),
             "targets": jnp.zeros((B, S), jnp.int32)}
    step = jax.jit(jmake_train_step(jcfg, JHyper(),
                                    compute_dtype=jnp.float32))
    want = hlo_cost.analyze_hlo(
        step.lower(p, jadamw_init(p), batch).compile().as_text()).flops
    rec, cost = dryrun.trace_cell(
        arch, "smoke", CountingMesh((1, 1), ("data", "model")),
        cfg=get_config(arch, smoke=True),
        shape=ShapeConfig("smoke", S, B, "train"),
        compute_dtype=torch.float32)
    assert 0.75 <= cost.flops / want <= 1.25, cost.flops / want
    assert rec["num_microbatches"] == 1


def test_smollm_train_4k_traces_at_full_size():
    mesh = dryrun.production_mesh(False)
    rec, cost = dryrun.trace_cell("smollm-135m", "train_4k", mesh)
    cfg = get_config("smollm-135m", pad_for_mesh=True, model_axis=16)
    mb = rec["num_microbatches"]
    n_attn = cfg.num_layers
    assert {k: v[0] for k, v in cost.kernels.items()} == {
        "flash_attention_fwd": 2 * n_attn * mb,
        "flash_attention_bwd": n_attn * mb}
    params, opt = dryrun.rank_state(cfg, mesh)
    shard = sum(p.numel() * 4 for p in params.parameters())
    whole = sum(p.numel() * 4 for p in M.abstract_params(cfg).parameters())
    assert shard < whole / 8               # FSDP over 16 data ranks
    rows = 256 // 16 * 4096 * 4 * 2        # the rank's tokens and targets
    assert rec["memory"]["argument_bytes"] == 3 * shard + 4 + rows
    assert rec["fits"] and rec["tensor_parallel"] == {   # every layer's
        "model_ranks": 16, "dense_leaves_split": 7 * cfg.num_layers + 1,
        "dense_leaves_whole": 0}     # wq, wk, wv, wo and MLP; the embed
    assert rec["collectives"]["stats"]["all_reduce_sum:model"][0] > 0
    assert rec["collectives"]["count_by_kind"]["all-gather"] > 0
    assert rec["roofline"]["param_count"] == cfg.param_count()


REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "padded_dims", "kind",
                  "memory", "collectives", "op_census_top", "roofline",
                  "status"}


def test_cli_writes_records_with_the_reference_s_keys(tmp_path, capsys):
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        "--mesh", "both", "--out", str(tmp_path)]) == 0
    for mesh in ("16x16", "2x16x16"):
        rec = json.loads((tmp_path / f"{mesh}__smollm-135m__decode_32k"
                          ".json").read_text())
        assert REFERENCE_KEYS <= set(rec) and rec["status"] == "ok"
        assert {"flops", "bytes"} <= set(rec["cost"])
        assert {"argument_bytes", "output_bytes", "temp_bytes",
                "total_bytes"} <= set(rec["memory"])
        assert {"bytes_by_kind", "count_by_kind", "total_bytes",
                "largest_static"} <= set(rec["collectives"])
        assert {"t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                "param_count", "model_flops_global", "model_flops_per_chip",
                "useful_flops_ratio"} <= set(rec["roofline"])
        assert "trace_s" in rec and "fits" in rec
    assert "done: 2 cells, 0 errors" in capsys.readouterr().out


def test_search_cell_counts_one_shard(tmp_path):
    assert dryrun_search.main(["--mesh", "single", "--n", "8192",
                               "--queries", "16", "--out",
                               str(tmp_path)]) == 0
    (path,) = tmp_path.glob("16x16__bst-sharded-search__*.json")
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["cost"]["kernels"]["sparse_verify_batch_batched"]["calls"] >= 1
    assert rec["collectives"]["count_by_kind"]["all-gather"] == 4
    assert rec["overflow"] == 0


def test_profile_cell_prints_the_breakdown(capsys):
    assert profile_cell.main(["--arch", "smollm-135m", "--shape",
                              "decode_32k", "--min-gb", "0.01"]) == 0
    out = capsys.readouterr().out
    assert "counted on meta, no card" in out and "by scope" in out
    assert "decode_step" in out


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-3b-a800m",
                                  "zamba2-2.7b"])
def test_extrapolated_train_count_matches_the_whole_step(arch, monkeypatch):
    """A train cell of many units and microbatches is counted at 1 and 2
    units and 2 and 3 microbatches and extrapolated: FLOPs, bytes,
    kernels, ops and the collectives' calls and bytes equal the count of
    the whole step, and the peak lies within 10% of it (SMOKE config at
    3 units, 4 microbatches a rank at (2, 2))."""
    monkeypatch.setattr(dryrun, "STASH_BUDGET", 1e3)
    base = get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, num_layers=3 * base.period)
    shape = ShapeConfig("x", 64, 8, "train")
    got, want = (CountingMesh((2, 2), ("data", "model")) for _ in range(2))
    rec, cost = dryrun.trace_cell(arch, "x", got, cfg=cfg, shape=shape)
    whole = dryrun.trace_cell(arch, "x", want, cfg=cfg, shape=shape,
                              exact=True)[1]
    assert rec["num_microbatches"] == 4
    for field in ("flops", "bytes", "kernels", "by_op", "coll_bytes",
                  "coll_count", "coll_by_axis"):
        assert getattr(cost, field) == getattr(whole, field), field
    assert {k: v[:2] for k, v in got.stats.items()} == \
        {k: v[:2] for k, v in want.stats.items()}
    assert abs(cost.peak_bytes / whole.peak_bytes - 1) <= 0.10
