"""The port's train step: the four invariants of
``tests/test_train_invariants.py`` (microbatch count, remat, the compute
cast's scope, loss masking) on the port, and one ``make_train_step`` of
smollm-135m, hubert-xlarge and the four MoE, SSM and hybrid SMOKE
configs held against the JAX package's from the same parameters
(``params_from_jax``) and batch.

Tolerances against JAX: both steps run in float32 on the CPU (the
port's attention through the plain flash forward and backward); the
loss within 1e-5 relative and the gradient norm within 1e-4 relative
(the sums of 2 layers run in another order); the new parameters within
1e-5 absolute, a hundredth of the step: the first AdamW step moves a
weight by lr·g/(|g| + eps) with lr = 1e-3, which is ±lr wherever |g| is
well above eps = 1e-8 but amplifies the sums' rounding where |g| is
near eps (measured: one weight in a few thousand moves 2.4e-6 apart,
the rest within 1e-6).  smollm and hubert are held so, every weight.
For the four new families only, one exemption: where the clipped |g|
is within ten eps that amplification can pass 1e-5 (a few weights of
the MoE and hybrid SMOKE steps, whose rarely routed experts and shared
block see clipped gradients of 1e-8), and those weights are held at
their gradients instead, within 1e-5 of the tensor's largest gradient.
The weight decay reaches the units' per-layer vectors in both packages
(ROADMAP F8, mirrored: the reference's unit stack makes them 2-D), so
the SSM's ``A_log``, ``D`` and ``dt_bias`` compare as they are.  Three
steps of one dense and one SSM config are held the same way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import model as JM
from repro.optim.adamw import Hyper as JHyper
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim.adamw import Hyper, adamw_init
from repro_torch.train.steps import (cast_for_compute, make_eval_step,
                                     make_train_step)

ARCH = "smollm-135m"


def _batch(cfg, B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.inputs_embeds:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                              dtype=np.float32),
                "targets": rng.integers(0, cfg.vocab, (B, S)).astype(
                    np.int32)}
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _setup():
    cfg = get_config(ARCH, smoke=True)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    return cfg, params, _torch_batch(_batch(cfg))


def _clone(params):
    return type(params)(_copy_tree(params.tree()))


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(u) for u in tree]
    return tree.clone()


def test_microbatch_invariance():
    """mb=1, 2, 4 produce the same updated params."""
    cfg, params, batch = _setup()
    hyper = Hyper(total_steps=10, warmup_steps=1)
    results = []
    for mb in (1, 2, 4):
        step = make_train_step(cfg, hyper, num_microbatches=mb,
                               compute_dtype=torch.float32)
        p = _clone(params)
        new_p, _, metrics = step(p, adamw_init(p), batch)
        results.append((mb, new_p, float(metrics["loss"])))
    _, p1, l1 = results[0]
    for mb, pn, ln in results[1:]:
        assert abs(l1 - ln) < 1e-4, (mb, l1, ln)
        for a, b in zip(p1.parameters(), pn.parameters()):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=f"mb={mb}")


def test_remat_value_invariance():
    """remat=True/False give identical losses and gradients (recompute,
    same math)."""
    cfg, params, batch = _setup()
    params.requires_grad_(True)
    leaves = list(params.parameters())
    out = {}
    for remat in (False, True):
        loss = M.loss_fn(params, cfg, batch, remat=remat)
        out[remat] = (float(loss.detach()),
                      torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(out[False][0], out[True][0], rtol=1e-6)
    for a, b in zip(out[False][1], out[True][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_cast_for_compute_scope():
    """Only float32 matrices are cast; norms keep their dtype; under
    autograd the cast copy stays differentiable to the masters."""
    cfg, params, _ = _setup()
    cast = cast_for_compute(params, torch.bfloat16)
    for (name, orig), new in zip(params.named_parameters(),
                                 cast.parameters()):
        # F8, mirrored: a unit's vectors are matrices in the JAX stack
        if orig.dtype == torch.float32 and (orig.dim() >= 2
                                            or name.startswith("units.")):
            assert new.dtype == torch.bfloat16, name
        else:
            assert new.dtype == orig.dtype, name
    assert cast["final_norm"].dtype == torch.float32
    assert cast["units"][0]["l0"]["ln1"].dtype == torch.bfloat16
    params.requires_grad_(True)
    tree = cast_for_compute(params, torch.bfloat16)
    assert isinstance(tree, dict) and tree["embed"].requires_grad
    assert tree["embed"].grad_fn is not None
    assert tree["final_norm"] is params["final_norm"]


def test_loss_masking():
    """targets < 0 are excluded from the loss."""
    cfg, params, batch = _setup()
    full = float(M.loss_fn(params, cfg, batch))
    masked_batch = dict(batch)
    masked_batch["targets"] = batch["targets"].clone()
    masked_batch["targets"][:, ::2] = -1
    masked = float(M.loss_fn(params, cfg, masked_batch))
    assert np.isfinite(masked) and masked != full
    all_masked = dict(batch, targets=torch.full_like(batch["targets"], -1))
    assert float(M.loss_fn(params, cfg, all_masked)) == 0.0


def test_abstract_params_are_meta_shapes():
    cfg, params, _ = _setup()
    abstract = M.abstract_params(cfg)
    got = [(n, tuple(p.shape), p.dtype, p.device.type)
           for n, p in abstract.named_parameters()]
    want = [(n, tuple(p.shape), p.dtype, "meta")
            for n, p in params.named_parameters()]
    assert got == want


NEW_FAMILIES = ("granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-1.3b",
                "zamba2-2.7b")


@pytest.mark.parametrize("arch", ("smollm-135m", "hubert-xlarge")
                         + NEW_FAMILIES)
def test_train_step_matches_jax(arch):
    cfg = get_config(arch, smoke=True)
    jcfg = jget_config(arch, smoke=True)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    batch = _batch(cfg, seed=2)
    jhyper = JHyper(base_lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jmake_train_step(jcfg, jhyper,
                                     compute_dtype=jnp.float32))
    j_new, _, j_metrics = jstep(jparams, jadamw_init(jparams),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    step = make_train_step(cfg, Hyper(*jhyper), compute_dtype=torch.float32)
    ops.reset_kernel_stats()
    new, opt, metrics = step(params, adamw_init(params), _torch_batch(batch))
    n_attn = M.n_attention_layers(cfg)
    # remat: each layer's forward runs again in the backward
    assert ops.kernel_stats() == ({"flash_attention_fwd:ref": 2 * n_attn,
                                   "flash_attention_bwd:ref": n_attn}
                                  if n_attn else {})
    assert int(opt.step) == 1
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(j_metrics["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["lr"]), float(j_metrics["lr"]),
                               rtol=1e-7)
    want = M.params_from_jax(jax.tree_util.tree_map(np.asarray, j_new), cfg,
                             device="cpu")
    exempt = arch in NEW_FAMILIES
    grads = None
    clip = min(1.0, jhyper.clip_norm / float(j_metrics["grad_norm"]))
    for (name, a), b in zip(new.named_parameters(), want.parameters()):
        got = a.detach()
        off = ((got - b).abs() > 1e-5) & exempt
        if off.any():
            # Adam's first step is ill-conditioned where the clipped |g|
            # is near eps: lr·g/(|g| + eps) moves by lr·eps/(|g| + eps)²
            # ≈ 3e4 times the gradient's rounding there.  Such weights are
            # held at the gradient instead, within 1e-5 of the tensor's
            # largest gradient.
            grads = grads or _grads_both(jcfg, jparams, cfg, batch)
            gt, gj = grads[0][name], grads[1][name]
            assert (gj[off].abs() * clip < 10 * jhyper.eps).all(), (name, gj)
            np.testing.assert_allclose(gt[off].numpy(), gj[off].numpy(),
                                       rtol=0, atol=1e-5 * float(
                                           gj.abs().max()), err_msg=name)
        np.testing.assert_allclose(got[~off].numpy(), b[~off].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch,microbatches", [
    pytest.param(a, 1, id=a) for a in
    ("smollm-135m", "mamba2-1.3b", "zamba2-2.7b", "granite-moe-3b-a800m",
     "hubert-xlarge")] + [
    pytest.param("granite-moe-3b-a800m", 2, id="granite-moe-3b-a800m-mb2")])
def test_three_train_steps_match_jax(arch, microbatches):
    """Three steps on three batches (the per-layer vectors decayed in both
    packages, F8): the losses within 1e-5 relative, the parameters within
    1e-5 absolute after the last, except where a step was ill-conditioned
    (the clipped |g| of JAX's gradient within ten eps at some step, as in
    ``test_train_step_matches_jax``; mamba2: 1 weight of 8,192 in one
    matrix; at most 2).  The hybrid, MoE and encoder families too, and
    the MoE in two microbatches (gradients summed over both, the capacity
    a microbatch's) as the card's full-width training runs it; where the
    hybrid's shared block and rarely routed experts see clipped gradients
    near eps, as in the one-step test, at most one weight in 10,000 lands
    off (zamba2: 6 of 170,144, each at an ill-conditioned step)."""
    cfg = get_config(arch, smoke=True)
    jcfg = jget_config(arch, smoke=True)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    jhyper = JHyper(base_lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jmake_train_step(jcfg, jhyper,
                                     num_microbatches=microbatches,
                                     compute_dtype=jnp.float32))
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    step = make_train_step(cfg, Hyper(*jhyper),
                           num_microbatches=microbatches,
                           compute_dtype=torch.float32)
    jgrad = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, jcfg, b,
                                                     remat=True)))
    jopt, opt = jadamw_init(jparams), adamw_init(params)
    small = None
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        g = M.params_from_jax(jax.tree_util.tree_map(
            np.asarray, jgrad(jparams, jb)), cfg, device="cpu")
        jparams, jopt, j_metrics = jstep(jparams, jopt, jb)
        params, opt, metrics = step(params, opt, _torch_batch(batch))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(j_metrics["loss"]), rtol=1e-5)
        clip = min(1.0, jhyper.clip_norm / float(j_metrics["grad_norm"]))
        now = [gi.abs() * clip < 10 * jhyper.eps for gi in g.parameters()]
        small = now if small is None else [a | b for a, b in zip(small, now)]
    want = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    off_total = 0
    for (name, a), b, ill in zip(params.named_parameters(),
                                 want.parameters(), small):
        off = (a.detach() - b).abs() > 1e-5
        assert not (off & ~ill).any(), name
        off_total += int(off.sum())
        np.testing.assert_allclose(a.detach()[~off].numpy(), b[~off].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    cap = 2 if arch in ("smollm-135m", "mamba2-1.3b") else sum(
        p.numel() for p in want.parameters()) // 10_000
    assert off_total <= cap


def _grads_both(jcfg, jparams, cfg, batch):
    """The float32 loss gradients of both packages, by the port's
    parameter names."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.grad(lambda p: JM.loss_fn(p, jcfg, jb, remat=True))(jparams)
    jg = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jg), cfg,
                           device="cpu")
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu").requires_grad_(True)
    names = [n for n, _ in params.named_parameters()]
    loss = M.loss_fn(params, cfg, _torch_batch(batch), remat=True)
    tg = torch.autograd.grad(loss, list(params.parameters()))
    return (dict(zip(names, tg)),
            dict(zip(names, (g.detach() for g in jg.parameters()))))


def test_eval_step_is_the_loss():
    cfg, params, batch = _setup()
    got = make_eval_step(cfg, compute_dtype=torch.float32)(params, batch)
    assert not got.requires_grad
    assert float(got) == float(M.loss_fn(params, cfg, batch))
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    np.testing.assert_allclose(float(M.loss_fn(params, ref_cfg, batch)),
                               float(got), rtol=1e-5)
