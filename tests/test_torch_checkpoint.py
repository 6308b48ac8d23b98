"""The port's checkpoint/restart and fault tolerance — the tests of
``tests/test_checkpoint.py`` on the port (atomic saves, bitwise-identical
resume, stale-directory sweeps, the straggler policy, the failure drill,
int8 gradient compression, the async writer), the JAX package's mesh
case as a restore onto another device, and checkpoints restored across
the two packages both ways with identical npz keys, shapes, dtypes and
arrays."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.distributed import checkpoint as jckpt
from repro.models import model as JM
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SketchDedupPipeline
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression
from repro_torch.distributed.fault_tolerance import (FailurePlan,
                                                     SimulatedFailure,
                                                     StragglerMonitor,
                                                     resume_or_init)
from repro_torch.models import model as M
from repro_torch.optim.adamw import (AdamWState, Hyper, abstract_opt_state,
                                     adamw_init)
from repro_torch.store.faults import CrashPoint
from repro_torch.train.steps import make_train_step

ARCH = "smollm-135m"


def _assert_same_params(a, b):
    """Two ``Params`` equal tensor for tensor, matched by name (the JAX
    package's pytrees list their keys sorted, the port in its order)."""
    na = {n: p.detach() for n, p in a.named_parameters()}
    nb = {n: p.detach() for n, p in b.named_parameters()}
    assert sorted(na) == sorted(nb)
    for n in na:
        assert torch.equal(na[n], nb[n]), n


def _setup(steps=6):
    cfg = get_config(ARCH, smoke=True)
    hyper = Hyper(total_steps=steps, warmup_steps=1)
    data = SketchDedupPipeline(DataConfig(vocab=cfg.vocab, batch=4, seq=16),
                               device="cpu")
    return cfg, data, make_train_step(cfg, hyper, compute_dtype=torch.float32)


def _init(cfg):
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    return params, adamw_init(params)


def _run(data, step_fn, ckpt_dir, start, steps, params, opt, plan=None,
         ckpt_every=2):
    losses = {}
    for step in range(start, steps):
        if plan is not None:
            plan.maybe_fail(step)
        params, opt, metrics = step_fn(params, opt, data.batch_for_step(step))
        losses[step] = float(metrics["loss"])
        if (step + 1) % ckpt_every == 0:
            ckpt.save_checkpoint(ckpt_dir, step + 1,
                                 {"params": params, "opt": opt})
    return params, opt, losses


def _abstract(cfg):
    abstract = M.abstract_params(cfg)
    return {"params": abstract, "opt": abstract_opt_state(abstract)}


def test_restart_is_bitwise_identical(tmp_path):
    cfg, data, step_fn = _setup()
    d = str(tmp_path / "ck")
    p_full, _, losses_full = _run(data, step_fn, d + "_a", 0, 6, *_init(cfg))

    plan = FailurePlan(fail_at_step=4)
    with pytest.raises(SimulatedFailure):
        _run(data, step_fn, d, 0, 6, *_init(cfg), plan=plan)
    assert ckpt.latest_checkpoint(d) == 4
    state, start = resume_or_init(d, _abstract(cfg), lambda: None,
                                  device="cpu")
    assert start == 4
    assert isinstance(state["opt"], AdamWState) and int(state["opt"].step) == 4
    _, data2, _ = _setup()
    p_resumed, _, losses_resumed = _run(data2, step_fn, d, start, 6,
                                        state["params"], state["opt"])
    for s in (4, 5):
        assert losses_full[s] == losses_resumed[s], (s, losses_full,
                                                     losses_resumed)
    for a, b in zip(p_full.parameters(), p_resumed.parameters()):
        assert torch.equal(a, b)


def test_atomic_no_partial_checkpoints(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 1, {"w": torch.ones((4, 4))})
    os.makedirs(os.path.join(d, "step_0000002.tmp-999"), exist_ok=True)
    assert ckpt.list_checkpoints(d) == [1]


def test_sweep_stale_tmp_dirs(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 1, {"w": torch.ones((2, 2))})
    stale = [os.path.join(d, "step_0000002.tmp-999"),
             os.path.join(d, "step_0000001.old-999"),
             os.path.join(d, "step_0000000.rm")]
    for p in stale:
        os.makedirs(p, exist_ok=True)
        with open(os.path.join(p, "junk.bin"), "wb") as f:
            f.write(b"x" * 64)
    removed = ckpt.sweep_stale(d)
    assert sorted(removed) == sorted(stale)
    for p in stale:
        assert not os.path.exists(p)
    assert ckpt.list_checkpoints(d) == [1]
    for p in stale:
        os.makedirs(p, exist_ok=True)
    ckpt.AsyncCheckpointer(d, keep=2)
    assert not any(os.path.exists(p) for p in stale)
    d2 = str(tmp_path / "ck2")
    stale2 = os.path.join(d2, "step_0000004.tmp-999")
    os.makedirs(stale2)
    state, start = resume_or_init(d2, None, lambda: "fresh", device="cpu")
    assert (state, start) == ("fresh", 0)
    assert not os.path.exists(stale2)


def test_sweep_keeps_own_inflight_tmp(tmp_path):
    d = str(tmp_path / "ck")
    mine = os.path.join(d, f"step_0000009.tmp-{os.getpid()}")
    os.makedirs(mine)
    assert ckpt.sweep_stale(d) == []
    assert os.path.isdir(mine)


def test_restore_onto_another_device(tmp_path):
    """The JAX package's elastic case on one card: arrays are saved as
    logical host copies, so a restore places them on any device — here
    from meta-device structure onto the CPU (and onto the card where
    there is one), dtypes from the structure."""
    d = str(tmp_path / "ck")
    tree = {"embed": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "step": torch.tensor(3, dtype=torch.int32)}
    ckpt.save_checkpoint(d, 3, tree)
    abstract = {"embed": torch.empty((8, 8), device="meta"),
                "step": torch.empty((), dtype=torch.int32, device="meta")}
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        got = ckpt.restore_checkpoint(d, 3, abstract, device=dev)
        assert got["embed"].device.type == dev
        assert torch.equal(got["embed"].cpu(), tree["embed"])
        assert got["step"].dtype == torch.int32 and int(got["step"]) == 3
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, 3, {"embed": torch.empty((4, 8),
                                                            device="meta")},
                                device="cpu")
    with pytest.raises(ValueError, match="lacks keys"):
        ckpt.restore_checkpoint(d, 3, {"other": torch.empty(2, device="meta")},
                                device="cpu")


def test_straggler_monitor_flags_slow_worker():
    mon = StragglerMonitor(n_workers=4, warmup=2)
    for _ in range(5):
        mon.observe([1.0, 1.1, 0.9, 4.5])
    assert mon.check() == [3]
    mon2 = StragglerMonitor(n_workers=4, warmup=2)
    for _ in range(5):
        mon2.observe([1.0, 1.1, 0.9, 1.2])
    assert mon2.check() == []


def test_simulated_failure_is_a_crash_point():
    plan = FailurePlan(fail_at_step=2)
    plan.maybe_fail(1)
    with pytest.raises(CrashPoint, match="step 2"):
        plan.maybe_fail(2)
    plan.maybe_fail(2)                       # fires once


def test_grad_compression_roundtrip_and_error_feedback():
    rng = np.random.default_rng(0)
    grads = {"a": torch.from_numpy(rng.standard_normal((64, 64)).astype(
                 np.float32)),
             "b": torch.from_numpy(rng.standard_normal((7,)).astype(
                 np.float32))}
    err = compression.init_error_feedback(grads)
    c, err1 = compression.compress(grads, err)
    out = compression.decompress(c)
    for k in grads:
        assert c.q[k].dtype == torch.int8
        scale = float(grads[k].abs().max()) / 127.0
        assert float((out[k] - grads[k]).abs().max()) <= scale * 0.5 + 1e-7
        np.testing.assert_allclose((out[k] + err1[k]).numpy(),
                                   grads[k].numpy(), atol=1e-6)
    assert compression.compressed_bytes(c) < sum(
        g.numel() * 4 for g in grads.values()) / 3.5


def test_grad_compression_matches_jax():
    from repro.distributed import compression as jcomp
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((16, 8)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    e = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
         for k, v in g.items()}
    jc, je = jcomp.compress({k: jnp.asarray(v) for k, v in g.items()},
                            {k: jnp.asarray(v) for k, v in e.items()})
    tc, te = compression.compress(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()})
    for k in g:
        np.testing.assert_array_equal(tc.q[k].numpy(), np.asarray(jc.q[k]))
        np.testing.assert_array_equal(tc.scale[k].numpy(),
                                      np.asarray(jc.scale[k]))
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ck")
    acp = ckpt.AsyncCheckpointer(d, keep=2)
    w = torch.zeros(2)
    for s in (1, 2, 3):
        w.fill_(float(s))                     # updated in place, as a step
        acp.save(s, {"w": w})                 # would: the copy is taken now
    acp.wait()
    assert ckpt.list_checkpoints(d) == [2, 3]
    for s in (2, 3):
        got = ckpt.restore_checkpoint(d, s, {"w": torch.empty(2)},
                                      device="cpu")
        assert got["w"].tolist() == [float(s)] * 2


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _jax_state():
    jcfg = jget_config(ARCH, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(3), jcfg)
    opt = jadamw_init(params)
    rng = np.random.default_rng(4)
    bump = lambda x: jnp.asarray(                             # noqa: E731
        rng.standard_normal(x.shape).astype(np.float32))
    opt = opt._replace(step=jnp.int32(7),
                       mu=jax.tree_util.tree_map(bump, opt.mu),
                       nu=jax.tree_util.tree_map(bump, opt.nu))
    return jcfg, {"params": params, "opt": opt}


def _jax_abstract(jcfg):
    abstract = JM.abstract_params(jcfg)
    return {"params": abstract,
            "opt": jax.eval_shape(jadamw_init, abstract)}


def _same_files(a: str, b: str):
    with open(os.path.join(a, "manifest.json")) as f:
        ma = json.load(f)
    with open(os.path.join(b, "manifest.json")) as f:
        mb = json.load(f)
    for key in ("step", "keys", "shapes", "dtypes"):
        assert ma[key] == mb[key], key
    with np.load(os.path.join(a, "arrays.npz")) as na, \
            np.load(os.path.join(b, "arrays.npz")) as nb:
        assert sorted(na.files) == sorted(nb.files)
        for k in na.files:
            assert na[k].dtype == nb[k].dtype, k
            np.testing.assert_array_equal(na[k], nb[k], err_msg=k)


def test_port_restores_jax_checkpoint(tmp_path):
    jcfg, jstate = _jax_state()
    d = str(tmp_path / "jax")
    jckpt.save_checkpoint(d, 7, jstate)
    cfg = get_config(ARCH, smoke=True)
    state, start = resume_or_init(d, _abstract(cfg), lambda: None,
                                  device="cpu")
    assert start == 7 and int(state["opt"].step) == 7
    want = M.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jstate["params"]),
                             cfg, device="cpu")
    _assert_same_params(state["params"], want)
    want_mu = M.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jstate["opt"].mu),
                                cfg, device="cpu")
    _assert_same_params(state["opt"].mu, want_mu)
    # the port writes the same state back as the same files
    ckpt.save_checkpoint(str(tmp_path / "port"), 7, state)
    _same_files(os.path.join(d, "step_0000007"),
                str(tmp_path / "port" / "step_0000007"))


def test_jax_restores_port_checkpoint(tmp_path):
    cfg = get_config(ARCH, smoke=True)
    params, opt = _init(cfg)
    step_fn = make_train_step(cfg, Hyper(total_steps=4, warmup_steps=1),
                              compute_dtype=torch.float32)
    data = SketchDedupPipeline(DataConfig(vocab=cfg.vocab, batch=2, seq=8),
                               device="cpu")
    params, opt, _ = step_fn(params, opt, data.batch_for_step(0))
    d = str(tmp_path / "port")
    ckpt.save_checkpoint(d, 1, {"params": params, "opt": opt})
    jcfg = jget_config(ARCH, smoke=True)
    restored = jckpt.restore_checkpoint(d, 1, _jax_abstract(jcfg))
    assert int(restored["opt"].step) == 1
    back = M.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    restored["params"]),
                             cfg, device="cpu")
    _assert_same_params(params, back)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, restored)
    _same_files(os.path.join(d, "step_0000001"),
                str(tmp_path / "jax" / "step_0000001"))
