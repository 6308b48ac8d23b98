"""The port's expert-parallel MoE (``repro_torch.models.moe_sharded``)
and its data-parallel global capacity (``moe.moe_apply(mesh=)``) against
the JAX package.

At mesh (1, 1), in this process, the three tests of
``tests/test_moe_sharded.py`` on the port: the output within 1e-5 of
JAX's ``moe_apply_sharded`` and ``moe_apply`` (shared experts or not),
the gradients within 1e-4, and the same dropped tokens at a tight
capacity.  Then groups of 2 and 4 CPU processes (gloo) at meshes
(1, 2), (2, 2) and (1, 4) within 1e-5, lossless and at capacity factor
0.5 (drops): (2, 2) against JAX's ``moe_apply_sharded`` on a (2, 2) mesh
of four host devices (a subprocess), (1, 2) and (1, 4) against JAX's
``moe_apply`` with one group, which ``moe_apply_sharded`` equals at a
data axis of 1 (the three tests above and the JAX package's); at the
lossless
capacity each rank's gradients are its slices of JAX's ``moe_apply``
gradients (the one global function) within 1e-4.  Float32 throughout:
the tolerances are those of the JAX package's own test.  Last, a
("data",) mesh of 2 and 4 ranks with one MoE group over the global
batch: the kept (token, slot) mask equals one rank's exactly, and the
output is one rank's within 1e-5; with ``moe_groups`` 2 and 4 the
model's dispatch gives JAX's ``moe_apply(num_groups=)`` within 1e-5.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import (env_with_src, moe_data_parallel_worker,
                          moe_sharded_worker, run_ranks)
from repro.models import moe as JMOE
from repro.models.moe_sharded import moe_apply_sharded as jmoe_sharded
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as TMOE
from repro_torch.models.moe_sharded import (MOE_SPECS, moe_apply_sharded,
                                            shard_moe_params)
from repro_torch.distributed.sharding import local_shard

LOSSLESS = 8 / 2
# (shared experts, seed, capacity factor, gradients)
CASES = {"plain": (0, 0, LOSSLESS, True), "shared": (1, 0, LOSSLESS, True),
         "drops": (0, 3, 0.5, False)}
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}


def _setup(E=8, k=2, d=32, ff=16, shared=0, seed=0):
    params = JMOE.moe_init(jax.random.PRNGKey(seed), d, E, ff, shared,
                           jnp.float32)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((2, 12, d)), jnp.float32)
    return params, x


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


MESH11 = None


def _mesh11():
    global MESH11
    MESH11 = MESH11 or make_mesh((1, 1), ("data", "model"))
    return MESH11


def _jax(fn, **kw):
    """``fn(params, x, **kw)`` jitted (eager ``shard_map`` is slow)."""
    return jax.jit(lambda p, x: fn(p, x, top_k=2, act="silu", **kw))


# -- mesh (1, 1): tests/test_moe_sharded.py on the port ----------------------

@pytest.mark.parametrize("shared", [0, 1])
def test_sharded_matches_local(shared):
    params, x = _setup(shared=shared)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    tp = shard_moe_params(_t(_np(params)), _mesh11())
    got = moe_apply_sharded(tp, _t(x), _mesh11(), top_k=2, act="silu",
                            capacity_factor=LOSSLESS)
    for want in (_jax(jmoe_sharded, mesh=jmesh,
                      capacity_factor=LOSSLESS)(params, x),
                 _jax(JMOE.moe_apply, capacity_factor=LOSSLESS)(params, x),
                 _jax(JMOE.moe_apply_dense)(params, x)):
        _close(got, want, 1e-5)
    _close(got, TMOE.moe_apply(_t(_np(params)), _t(x), top_k=2, act="silu",
                               capacity_factor=LOSSLESS), 1e-5)


def test_sharded_grads_match_local():
    params, x = _setup()
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jg = jax.jit(jax.grad(lambda p: jmoe_sharded(
        p, x, jmesh, top_k=2, act="silu",
        capacity_factor=LOSSLESS).sum()))(params)
    jg_local = jax.jit(jax.grad(lambda p: JMOE.moe_apply(
        p, x, top_k=2, act="silu", capacity_factor=LOSSLESS).sum()))(params)
    tp = shard_moe_params(_t(_np(params)), _mesh11())
    for v in tp.values():
        v.requires_grad_(True)
    moe_apply_sharded(tp, _t(x), _mesh11(), top_k=2, act="silu",
                      capacity_factor=LOSSLESS).sum().backward()
    for name in tp:
        _close(tp[name].grad, jg[name], 1e-4)
        _close(tp[name].grad, jg_local[name], 1e-4)


def test_sharded_capacity_drops_match_local():
    """With a tight capacity both packages drop the SAME tokens (same
    deterministic cumsum order)."""
    params, x = _setup(seed=3)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    tp = shard_moe_params(_t(_np(params)), _mesh11())
    got = moe_apply_sharded(tp, _t(x), _mesh11(), top_k=2, act="silu",
                            capacity_factor=0.5)
    _close(got, _jax(jmoe_sharded, mesh=jmesh,
                     capacity_factor=0.5)(params, x), 1e-5)
    _close(got, _jax(JMOE.moe_apply, capacity_factor=0.5)(params, x), 1e-5)
    lossless = moe_apply_sharded(tp, _t(x), _mesh11(), top_k=2, act="silu",
                                 capacity_factor=LOSSLESS)
    assert (got - lossless).abs().max() > 1e-2      # pairs were dropped


# -- groups of CPU ranks -------------------------------------------------------

_JAX_REF = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.models import moe as JMOE
from repro.models.moe_sharded import moe_apply_sharded
cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
assert len(jax.devices()) == 4, jax.devices()
out = {}
for name, (shared, seed, cf, _) in cases.items():
    params = JMOE.moe_init(jax.random.PRNGKey(seed), 32, 8, 16, shared,
                           jnp.float32)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((2, 12, 32)),
                    jnp.float32)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    y = jax.jit(lambda p, x: moe_apply_sharded(
        p, x, mesh, top_k=2, act="silu", capacity_factor=cf))(params, x)
    out[f"{name}/y/2x2"] = np.asarray(y)
    out[f"{name}/y/one_group"] = np.asarray(jax.jit(lambda p, x: JMOE.moe_apply(
        p, x, top_k=2, act="silu", capacity_factor=cf))(params, x))
    g, gx = jax.jit(jax.grad(lambda p, x: JMOE.moe_apply(
        p, x, top_k=2, act="silu", capacity_factor=cf).sum(),
        argnums=(0, 1)))(params, x)
    out[f"{name}/dx"] = np.asarray(gx)
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        key = ".".join(str(k.key) for k in path)
        out[f"{name}/grad/{key}"] = np.asarray(leaf)
np.savez(out_path, **out)
'''


@pytest.fixture(scope="module")
def jax_ranks(tmp_path_factory):
    """JAX's ``moe_apply_sharded`` on a (2, 2) mesh of host devices and
    ``moe_apply``'s outputs and gradients, from a subprocess."""
    path = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(env_with_src(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _JAX_REF, json.dumps(CASES),
                           str(path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def torch_ranks(tmp_path_factory):
    """The port at every mesh, in groups of 2 and 4 ranks: {world:
    per-rank results, in (mesh, case) order}."""
    cases = []
    for shared, seed, cf, grad in CASES.values():
        params, x = _setup(shared=shared, seed=seed)
        cases.append(dict(params=_np(params), x=np.asarray(x), cf=cf,
                          grad=grad))
    tmp = tmp_path_factory.mktemp("ranks")
    return {world: run_ranks(moe_sharded_worker, world, tmp,
                             dict(meshes=meshes, cases=cases))
            for world, meshes in MESHES.items()}


class _Rank:
    """A mesh's shape and one rank's coordinates, as ``local_shard``
    reads them."""

    def __init__(self, shape, rank):
        self.shape = {"data": shape[0], "model": shape[1]}
        self.coords = {"data": rank // shape[1], "model": rank % shape[1]}

    def coord(self, axis):
        return self.coords[axis]


MESH_CASES = [(w, s, c) for w, meshes in MESHES.items() for s in meshes
              for c in CASES]


@pytest.mark.parametrize("world,shape,case", MESH_CASES)
def test_ranks_match_jax_sharded(world, shape, case, jax_ranks,
                                 torch_ranks):
    """The ranks' output rows, assembled, equal JAX's: on the (2, 2)
    mesh, or with one group at a data axis of 1; every model rank holds
    the same rows."""
    results = torch_ranks[world]
    i = MESHES[world].index(shape) * len(CASES) + list(CASES).index(case)
    D, M = shape
    rows = [results[d * M][i]["y"] for d in range(D)]
    for d in range(D):
        for m in range(1, M):
            np.testing.assert_array_equal(results[d * M + m][i]["y"],
                                          rows[d])
    want = jax_ranks[f"{case}/y/" + ("2x2" if D == 2 else "one_group")]
    _close(np.concatenate(rows), want, 1e-5)


@pytest.mark.parametrize("world,shape,case",
                         [c for c in MESH_CASES if CASES[c[2]][3]])
def test_rank_grads_are_slices_of_the_global(world, shape, case, jax_ranks,
                                             torch_ranks):
    """At the lossless capacity: each rank's gradients on its shards are
    its slices of JAX's ``moe_apply`` gradients, and its input rows'."""
    results = torch_ranks[world]
    i = MESHES[world].index(shape) * len(CASES) + list(CASES).index(case)
    D, M = shape
    dx = jax_ranks[f"{case}/dx"]
    for rank in range(world):
        got = results[rank][i]
        where = _Rank(shape, rank)
        rows = dx.shape[0] // D
        d = where.coord("data")
        _close(got["dx"], dx[d * rows:(d + 1) * rows], 1e-4)
        assert got["grads"].keys() == {k for k in MOE_SPECS
                                       if CASES[case][0] or "shared" not in k}
        for name, g in got["grads"].items():
            full = torch.from_numpy(jax_ranks[f"{case}/grad/{name}"])
            _close(g, local_shard(full, MOE_SPECS[name], where), 1e-4)


@pytest.fixture(scope="module")
def data_parallel(tmp_path_factory):
    """("data",) meshes of 2 and 4 ranks, one MoE group over the batch of
    4 x 6 tokens at capacity 0.5 and lossless; the routings of the first
    case for the plan's own check."""
    params, _ = _setup(seed=5)
    x = np.random.default_rng(5).standard_normal((4, 6, 32)).astype(
        np.float32)
    _, idx = TMOE._route(_t(_np(params))["router"],
                         torch.from_numpy(x).reshape(1, 24, 32), 2)
    cases = [dict(params=_np(params), x=x, cf=cf, E=8, idx=idx.numpy())
             for cf in (0.5, LOSSLESS)]
    tmp = tmp_path_factory.mktemp("dp")
    return cases, {world: run_ranks(moe_data_parallel_worker, world, tmp,
                                    dict(cases=cases, moe_groups=(2, 4)))
                   for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cf", [0.5, LOSSLESS])
def test_data_parallel_keeps_one_rank_s_pairs(world, cf, data_parallel):
    cases, results = data_parallel
    i = [c["cf"] for c in cases].index(cf)
    case = cases[i]
    keep, _, _ = TMOE._capacity_plan(torch.from_numpy(case["idx"]), 8, cf)
    got = np.concatenate([r[i]["keep"] for r in results[world]], axis=1)
    np.testing.assert_array_equal(got, keep.numpy())
    assert keep.all() == (cf == LOSSLESS)
    y = np.concatenate([r[i]["y"] for r in results[world]])
    want = TMOE.moe_apply(_t(case["params"]), torch.from_numpy(case["x"]),
                          top_k=2, act="silu", capacity_factor=cf)
    _close(y, want, 1e-5)
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    _close(y, JMOE.moe_apply(params, jnp.asarray(case["x"]), top_k=2,
                             act="silu", capacity_factor=cf), 1e-5)


@pytest.mark.parametrize("world,groups", [(2, 2), (2, 4), (4, 4), (4, 2)])
@pytest.mark.parametrize("cf", [0.5, LOSSLESS])
def test_data_parallel_moe_groups_match_jax(world, groups, cf,
                                            data_parallel):
    """The model's MoE dispatch with ``moe_groups`` G over a ("data",)
    mesh: each rank's rows are G / ranks whole groups of the global
    batch, so the ranks' rows are JAX's ``moe_apply(num_groups=G)`` on
    the whole batch within 1e-5 (drops at capacity 0.5 included); G
    neither 1 nor a multiple of the ranks raises."""
    cases, results = data_parallel
    i = [c["cf"] for c in cases].index(cf)
    got = [r[i]["grouped"][groups] for r in results[world]]
    if groups % world:
        assert all("MoE groups over" in g for g in got)
        return
    params = jax.tree_util.tree_map(jnp.asarray, cases[i]["params"])
    want = JMOE.moe_apply(params, jnp.asarray(cases[i]["x"]), top_k=2,
                          act="silu", num_groups=groups, capacity_factor=cf)
    _close(np.concatenate(got), want, 1e-5)
    if cf != LOSSLESS:     # the groups drop pairs of their own
        one = JMOE.moe_apply(params, jnp.asarray(cases[i]["x"]), top_k=2,
                             act="silu", capacity_factor=cf)
        assert np.abs(np.concatenate(got) - np.asarray(one)).max() > 1e-3
