"""The model under a mesh of CPU ranks, and the serve CLI under
``torch.distributed.run``, against the JAX package and the port's one-rank
run.

SMOKE granite-moe-3b-a800m (its MoE blocks on the expert-parallel path,
each model rank holding half the experts) and yi-9b (its decode cache
split over the sequence axis, ``decode_kv_shard="seq"``), their dense
layers tensor parallel over "model" (granite's KV caches split over the
heads), with the JAX
package's parameters carried across: prefill and three teacher-forced
decode steps in a group of 2 gloo ranks at meshes (1, 2) and (2, 1),
every rank's rows assembled.  Tolerances: the prefill logits within
1e-4 of JAX's (float32 both sides) and the decode logits within 2e-2
(they read bf16 caches; the JAX package's own prefill/decode test's),
both within 1e-5 of the port's one-rank run (float32 on both, sums in
another order at most), the caches within a bf16 ulp (1e-2) of it; the
collectives that ran are the ones each path needs (at (2, 1) the
experts' FSDP shards are gathered over "data", as in the reference's
body).  Then
``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
repro_torch.launch.serve --smoke --device cpu`` prints one rank's
continuation ids, for smollm-135m and for granite-moe (whose MoE
capacity spans both ranks' rows).
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import (leave_after_collective_worker, model_worker,
                          run_cli, run_ranks)
from repro.configs.registry import get_config as jget_config
from repro.models import model as JM
from repro.train.steps import make_decode_step as jdecode_step
from repro.train.steps import make_prefill_step as jprefill_step
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve
from repro_torch.models import model as TM

ARCHS = ["granite-moe-3b-a800m", "yi-9b"]
MESHES = [(1, 2), (2, 1)]
B, S, GEN = 2, 12, 3
S_MAX = S + GEN + 1


def _inputs(arch):
    jcfg = jget_config(arch, smoke=True)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     JM.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S + GEN))
    return jcfg, jparams, toks.astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{arch: (JAX's logits of every step, the port's one-rank logits and
    caches, the ranks' results per mesh)}."""
    cases, out = [], {}
    for arch in ARCHS:
        jcfg, jparams, toks = _inputs(arch)
        pre = jax.jit(jprefill_step(jcfg, s_max=S_MAX,
                                    compute_dtype=jnp.float32))
        dec = jax.jit(jdecode_step(jcfg, compute_dtype=jnp.float32))
        jl, jcache, jlen = pre(jparams, {"tokens": jnp.asarray(toks[:, :S])})
        want = [np.asarray(jl)]
        for i in range(GEN):
            jl, jcache = dec(jparams, jnp.asarray(toks[:, S + i:S + i + 1]),
                             jcache, jlen + i)
            want.append(np.asarray(jl))
        cfg = get_config(arch, smoke=True)
        params = TM.params_from_jax(jparams, cfg, device="cpu")
        fed = torch.from_numpy(toks[:, S:])
        logits, cache, n = TM.prefill(params, cfg,
                                      {"tokens": torch.from_numpy(
                                          toks[:, :S])}, s_max=S_MAX)
        caches = [[t.float().numpy().copy() for t in layer]
                  for unit in cache for layer in unit.values()]
        one = [logits.numpy()]
        for i in range(GEN):
            logits, cache = TM.decode_step(params, cfg, fed[:, i:i + 1],
                                           cache, n + i)
            one.append(logits.numpy())
        out[arch] = (want, one, caches)
        cases.append(dict(arch=arch, params=jparams, toks=toks[:, :S],
                          fed=toks[:, S:], s_max=S_MAX))
    results = run_ranks(model_worker, 2, tmp_path_factory.mktemp("ranks"),
                        dict(cases=cases, meshes=MESHES))
    return {arch: out[arch] + ([[r[a * len(MESHES) + m] for r in results]
                                for m in range(len(MESHES))],)
            for a, arch in enumerate(ARCHS)}


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_decode_match(arch, mesh, runs):
    want, one, caches, per_mesh = runs[arch]
    ranks = per_mesh[MESHES.index(mesh)]
    D, M = mesh
    for step in range(GEN + 1):
        rows = [ranks[d * M]["logits"][step] for d in range(D)]
        for d in range(D):
            for m in range(1, M):
                np.testing.assert_array_equal(
                    ranks[d * M + m]["logits"][step], rows[d])
        got = np.concatenate(rows)
        _close(got, one[step], 1e-5)
        _close(got, want[step], 1e-4 if step == 0 else 2e-2)
    # caches: the ranks' rows (data), sequence slices (model, yi's
    # global layers) and KV heads (model, where it divides granite's) put
    # back together are the one-rank run's
    cfg = get_config(arch, smoke=True)
    seq = cfg.decode_kv_shard == "seq" and M > 1
    heads = not seq and M > 1 and cfg.n_kv % M == 0
    for li, layer in enumerate(caches):
        for ti, whole in enumerate(layer):
            parts = [[ranks[d * M + m]["caches"][li][ti] for m in range(M)]
                     for d in range(D)]
            if heads:
                assert parts[0][0].shape[2] == cfg.n_kv // M
                got = np.concatenate([np.concatenate(row, axis=2)
                                      for row in parts])
            elif not seq:
                for row in parts:
                    for p in row[1:]:
                        np.testing.assert_array_equal(p, row[0])
                got = np.concatenate([row[0] for row in parts])
            else:
                assert parts[0][0].shape[1] == S_MAX // M
                got = np.concatenate([np.concatenate(row, axis=1)
                                      for row in parts])
            _close(got, whole, 1e-2)
    stats = ranks[0]["stats"]
    if M > 1 and cfg.n_experts:         # the expert-parallel combine
        assert stats["all_reduce_sum:model"][0] > 0
    if M > 1 and seq:                   # the distributed softmax
        assert stats["all_reduce_max:model"][0] == GEN * cfg.num_layers
    if D > 1 and cfg.n_experts:         # the experts' FSDP shards
        assert stats["all_gather:data"][0] > 0
    if M > 1:                           # tensor parallelism of the dense
        assert stats["all_reduce_sum:model"][0] > 0     # layers
    if not cfg.n_experts and not seq:   # dense rows: only the FSDP gathers
        assert set(stats) == ({"all_gather:data"} if D > 1 else set())


def _continuation(out: str):
    lines = [ln for ln in out.splitlines()
             if ln.startswith("continuation ids:")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-3b-a800m"])
def test_serve_cli_over_two_ranks_prints_one_rank_s_tokens(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
            "--prompt-len", "9", "--gen-len", "5"]
    assert serve.main(argv) == 0
    want = _continuation(capsys.readouterr().out)
    out = run_cli([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc-per-node", "2", "-m",
                   "repro_torch.launch.serve", *argv])
    assert _continuation(out) == want
    assert "process group: backend gloo, 2 ranks" in out
    assert re.search(r"served 4 requests x 5 tokens on cpu over 2 data "
                     r"ranks", out)


def test_rank_leaving_after_a_collective_waits_for_its_peer(tmp_path):
    """Rank 1 leaves straight after a collective while rank 0 is held
    back: both exit 0 through ``shutdown_distributed``'s barrier (F12)."""
    assert run_ranks(leave_after_collective_worker, 2, tmp_path, 0.5) \
        == [3.0, 3.0]
