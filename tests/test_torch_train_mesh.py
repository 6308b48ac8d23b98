"""Training under a mesh of ranks — FSDP over "data", expert-parallel MoE
over "model", the global loss and norm, logical checkpoints with elastic
restore — held against the JAX package's train step.

The SMOKE configs of smollm-135m, granite-moe-3b-a800m and mamba2-1.3b
take three float32 steps on three global batches of 4 x 32 tokens at
meshes (2,), (1, 2), (2, 1) (groups of two gloo ranks) and (2, 2) (four
ranks), every rank on its shards of the training placement and its rows
of the batch, with ``moe_groups`` = the mesh's data-parallel shards.
The reference is JAX's ``make_train_step`` on the global batch at that
``moe_groups`` on one device — which the expert-parallel MoE equals
wherever the data axis or the model axis is 1 (``test_torch_moe_sharded``
holds why) — and, at (2, 2), JAX's step under a (2, 2) mesh of four host
devices, in a subprocess.  The rule is ``test_three_train_steps_match_jax``'s:
losses within 1e-5 relative, parameters within 1e-5 absolute after the
third step except where a step was ill-conditioned (JAX's clipped |g|
within ten eps), and the gradient norm within 1e-4 of JAX's.  The norm
equals the port's one-rank norm within 1e-5 relative (the shards' sums
add in another order).

A batch whose masked targets fall unevenly over the ranks gives the
one-process loss, not the mean of the ranks' means; the two-rank restart
drill through ``launch.train.main`` resumes bit for bit; a checkpoint
saved under (2, 2) restores under (1, 2), (2, 1) and with no mesh bit for
bit (the counterpart of ``tests/test_checkpoint.py``'s
``test_elastic_restore_different_mesh``).
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import env_with_src, run_ranks, train_mesh_worker
from repro.configs.registry import get_config as jget_config
from repro.models import model as JM
from repro.optim.adamw import Hyper as JHyper
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_config
from repro_torch.distributed.checkpoint import (AsyncCheckpointer,
                                                restore_checkpoint)
from repro_torch.distributed.sharding import local_shard, train_specs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import Hyper, abstract_opt_state, adamw_init
from repro_torch.train.steps import make_train_step

ARCHS = ["smollm-135m", "granite-moe-3b-a800m", "mamba2-1.3b"]
MESHES = [(2,), (1, 2), (2, 1), (2, 2)]
HYPER = dict(base_lr=1e-3, total_steps=10, warmup_steps=1)
EPS = JHyper().eps


def _batches(cfg):
    out = []
    for seed in (10, 11, 12):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32)
        out.append({"tokens": toks[:, :-1].copy(),
                    "targets": toks[:, 1:].copy()})
    return out


def _groups(cfg, shape):
    return shape[0] if cfg.n_experts else 1


_JAX = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.registry import get_config
from repro.distributed.sharding import use_mesh
from repro.models import model as JM
from repro.optim.adamw import Hyper, adamw_init
from repro.train.steps import make_train_step
runs, hyper, out_path = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
assert len(jax.devices()) == 4, jax.devices()
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for arch, groups, on_mesh in runs:
    tag = f"{arch}/{'2x2' if on_mesh else groups}"
    cfg = get_config(arch, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(1), cfg)
    opt = adamw_init(params)
    step = jax.jit(make_train_step(cfg, Hyper(**hyper), moe_groups=groups,
                                   compute_dtype=jnp.float32))
    for i, seed in enumerate((10, 11, 12)):
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab, (4, 33)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks[:, :-1]),
                 "targets": jnp.asarray(toks[:, 1:])}
        if on_mesh:
            with use_mesh(mesh):
                params, opt, m = step(params, opt, batch)
        else:
            params, opt, m = step(params, opt, batch)
        out[f"{tag}/loss/{i}"] = np.asarray(m["loss"])
        out[f"{tag}/norm/{i}"] = np.asarray(m["grad_norm"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        key = "/".join(str(k.key) for k in path)
        out[f"{tag}/p/{key}"] = np.asarray(leaf)
np.savez(out_path, **out)
'''


def _jax_runs():
    """(arch, moe_groups, under the (2, 2) mesh) of every reference."""
    runs = []
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        groups = sorted({_groups(cfg, m) for m in MESHES})
        runs += [(arch, g, False) for g in groups] + [(arch, 2, True)]
    return runs


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """JAX's three steps of every reference run — on one device at each
    ``moe_groups``, and under a (2, 2) mesh of four host devices — in a
    subprocess started at once (read when a test needs it)."""
    path = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(env_with_src(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _JAX,
                             json.dumps(_jax_runs()), json.dumps(HYPER),
                             str(path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    done = {}

    def result():
        if not done:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            done["r"] = dict(np.load(path))
        return done["r"]
    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def cases():
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch, smoke=True)
        jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
        out[arch] = dict(arch=arch, params=jax.tree_util.tree_map(
            np.asarray, jparams), batches=_batches(jcfg))
    return out


@pytest.fixture(scope="module")
def ranks(jax_ref, cases, tmp_path_factory):
    """{mesh: runs} of the port, and the extras of each group: four ranks
    first (they save the elastic checkpoint), then two."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    base = dict(cases=list(cases.values()), hyper=HYPER)
    four = run_ranks(train_mesh_worker, 4, tmp,
                     dict(base, meshes=[(2, 2)], save_dir=str(tmp / "el"),
                          elastic_arch=ARCHS[1]),
                     timeout=180)
    uneven = dict(cases[ARCHS[0]]["batches"][0])
    uneven["targets"] = uneven["targets"].copy()
    uneven["targets"][0, ::2] = -1          # rank 0's rows: 3/4 unmasked
    uneven["targets"][1, :] = -1            # and one row wholly masked
    two = run_ranks(train_mesh_worker, 2, tmp,
                    dict(base, meshes=[(2,), (1, 2), (2, 1)],
                         uneven=dict(arch=ARCHS[0],
                                     params=cases[ARCHS[0]]["params"],
                                     batch=uneven),
                         drill=dict(a=str(tmp / "drill_a"),
                                    b=str(tmp / "drill_b")),
                         elastic_dir=str(tmp / "el"),
                         elastic_arch=ARCHS[1]),
                    timeout=180)
    runs = {**four[0]["runs"], **two[0]["runs"]}
    return dict(runs=runs, four=four, two=two, uneven=uneven, tmp=tmp)


_ILL: dict = {}


def _ill_conditioned(case, groups):
    """Per weight, whether any of JAX's three one-device steps at
    ``moe_groups`` was ill-conditioned there: the clipped |g| within ten
    eps (``test_three_train_steps_match_jax``'s exemption)."""
    key = (case["arch"], groups)
    if key not in _ILL:
        _ILL[key] = _ill_mask(case, groups)
    return _ILL[key]


def _ill_mask(case, groups):
    jcfg = jget_config(case["arch"], smoke=True)
    cfg = get_config(case["arch"], smoke=True)
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    opt = jadamw_init(params)
    step = jax.jit(jmake_train_step(jcfg, JHyper(**HYPER),
                                    moe_groups=groups,
                                    compute_dtype=jnp.float32))
    grad = jax.jit(jax.grad(lambda p, b: JM.loss_fn(
        p, jcfg, b, moe_groups=groups, remat=True)))
    ill = None
    for b in case["batches"]:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        g = M.params_from_jax(jax.tree_util.tree_map(
            np.asarray, grad(params, jb)), cfg, device="cpu")
        params, opt, m = step(params, opt, jb)
        clip = min(1.0, 1.0 / float(m["grad_norm"]))
        now = {n: x.abs() * clip < 10 * EPS for n, x in g.named_parameters()}
        ill = now if ill is None else {n: ill[n] | now[n] for n in now}
    return ill


def _reference(arch, shape, jax_ref):
    """The subprocess's run for ``shape``: losses, norms, final
    parameters by the port's names."""
    cfg = get_config(arch, smoke=True)
    tag = f"{arch}/{'2x2' if shape == (2, 2) else _groups(cfg, shape)}"
    r = jax_ref()
    tree = _unflatten({k[len(tag) + 3:]: v for k, v in r.items()
                       if k.startswith(f"{tag}/p/")})
    final = M.params_from_jax(tree, cfg, device="cpu")
    return dict(loss=[float(r[f"{tag}/loss/{i}"]) for i in range(3)],
                norm=[float(r[f"{tag}/norm/{i}"]) for i in range(3)],
                params={n: p.detach() for n, p in final.named_parameters()})


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_steps_match_jax(arch, shape, ranks, cases, jax_ref):
    run = ranks["runs"][shape][ARCHS.index(arch)]
    want = _reference(arch, shape, jax_ref)
    np.testing.assert_allclose(run["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(run["norm"], want["norm"], rtol=1e-4)
    ill = None
    off_total = 0
    for name, got in run["params"].items():
        got = torch.from_numpy(got)
        off = (got - want["params"][name]).abs() > 1e-5
        if off.any():
            cfg = get_config(arch, smoke=True)
            ill = ill or _ill_conditioned(cases[arch], _groups(cfg, shape))
            assert not (off & ~ill[name]).any(), name
            off_total += int(off.sum())
        np.testing.assert_allclose(got[~off].numpy(),
                                   want["params"][name][~off].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert off_total <= 4


_ONE: dict = {}


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_grad_norm_is_one_rank(arch, shape, ranks, cases):
    """Each step's global norm over the shards equals the port's own
    one-process norm (no mesh) within 1e-5, and every step's loss
    within 1e-6."""
    cfg = get_config(arch, smoke=True)
    groups = _groups(cfg, shape)
    if (arch, groups) not in _ONE:
        params = M.params_from_jax(cases[arch]["params"], cfg, device="cpu")
        step = make_train_step(cfg, Hyper(**HYPER), moe_groups=groups,
                               compute_dtype=torch.float32)
        opt, got = adamw_init(params), []
        for b in cases[arch]["batches"]:
            params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                                for k, v in b.items()})
            got.append((float(m["loss"]), float(m["grad_norm"])))
        _ONE[(arch, groups)] = got
    one = _ONE[(arch, groups)]
    run = ranks["runs"][shape][ARCHS.index(arch)]
    np.testing.assert_allclose(run["norm"], [n for _, n in one], rtol=1e-5)
    np.testing.assert_allclose(run["loss"], [x for x, _ in one], rtol=1e-6)


def test_uneven_mask_gives_the_global_mean(ranks, cases):
    """Rank 0 holds 24 unmasked targets, rank 1 64: the two ranks' loss
    is the one-process loss of the whole batch, which the mean of the
    ranks' means is not."""
    arch = ARCHS[0]
    cfg = get_config(arch, smoke=True)
    params = M.params_from_jax(cases[arch]["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ranks["uneven"].items()}
    whole = float(M.loss_fn(params, cfg, batch))
    halves = [float(M.loss_fn(params, cfg, {k: v[i:i + 2] for k, v in
                                            batch.items()}))
              for i in (0, 2)]
    got = [r["uneven"] for r in ranks["two"]]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], whole, rtol=1e-6)
    assert abs(np.mean(halves) - whole) > 1e-3


def test_two_rank_restart_drill_resumes_bit_for_bit(ranks):
    """``launch.train.main`` over two ranks: ``--fail-at 4`` returns 13,
    the rerun resumes at step 4 and ends on the uninterrupted run's
    losses and last checkpoint, bit for bit."""
    r = ranks["two"][0]
    assert r["drill"] == [13, 0, 0]
    res, straight = r["drill_losses"]["resumed"], r["drill_losses"][
        "straight"]
    assert sorted(res) == [4, 5]
    assert all(res[s] == straight[s] for s in res)
    tmp = ranks["tmp"]
    a = np.load(tmp / "drill_a" / "step_0000006" / "arrays.npz")
    b = np.load(tmp / "drill_b" / "step_0000006" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _Rank(AbstractMesh):
    def __init__(self, shape, coords):
        super().__init__(shape, ("data", "model"))
        self.coords = coords

    def coord(self, axis):
        return self.coords[axis]


def test_checkpoint_under_a_mesh_needs_the_specs(tmp_path):
    """``AsyncCheckpointer`` under a mesh of several ranks refuses to
    save without the placement's specs (its writer would save its own
    shards as if they were the whole arrays) and writes nothing."""
    cfg = get_config(ARCHS[0], smoke=True)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    ck = AsyncCheckpointer(str(tmp_path), mesh=_Rank((2, 1), {"data": 0,
                                                              "model": 0}))
    with pytest.raises(ValueError, match="specs"):
        ck.save(1, {"params": params})
    assert not any(tmp_path.iterdir())


def test_placement_runs_no_arithmetic_on_meta():
    """``model.placement`` (read by every forward, prefill and decode step
    under a mesh with a data axis) builds its abstract parameters without
    an elementwise op on ``meta``, which would import torch's compiler
    stack: seconds on the first call of a serving process."""
    code = ("import sys\n"
            "from repro_torch.configs.registry import get_config\n"
            "from repro_torch.launch.mesh import AbstractMesh\n"
            "from repro_torch.models import model as M\n"
            "for arch in ('granite-moe-3b-a800m', 'zamba2-2.7b'):\n"
            "    M.placement(get_config(arch), AbstractMesh((2,), "
            "('data',)))\n"
            "print('torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env_with_src(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("target", ["(1, 2)", "(2, 1)", "none"])
def test_elastic_restore_different_mesh(target, ranks):
    """A checkpoint saved by four ranks at (2, 2) (granite: FSDP leaves,
    experts over "model", moments) restores whole with no mesh, equal to
    the ranks' gathered state bit for bit; under (1, 2) and (2, 1) each
    rank's shards are its slices of that whole state by the new mesh's
    training placement, bit for bit."""
    arch = ARCHS[1]
    cfg = get_config(arch, smoke=True)
    abstract = M.abstract_params(cfg)
    whole = restore_checkpoint(
        str(ranks["tmp"] / "el"), 3,
        {"params": abstract, "opt": abstract_opt_state(abstract)},
        device="cpu")
    saved = ranks["four"][0]["runs"][(2, 2)][ARCHS.index(arch)]["params"]
    if target == "none":
        for n, p in whole["params"].named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), saved[n],
                                          err_msg=n)
        assert int(whole["opt"].step) == 3
        return
    shape = tuple(int(x) for x in target.strip("()").split(","))
    specs = train_specs(whole["params"], _Rank(shape, {"data": 0,
                                                       "model": 0}))
    assert any(any(s) for s in specs.values())
    mus = dict(whole["opt"].mu.named_parameters())
    for r in ranks["two"]:
        got = r["elastic"][shape]
        assert got["step"] == 3
        where = _Rank(shape, got["coords"])
        for n, p in whole["params"].named_parameters():
            np.testing.assert_array_equal(
                got["params"][n], local_shard(p.detach(), specs[n],
                                              where).numpy(), err_msg=n)
            np.testing.assert_array_equal(
                got["mu"][n], local_shard(mus[n].detach(), specs[n],
                                          where).numpy(), err_msg=n)
