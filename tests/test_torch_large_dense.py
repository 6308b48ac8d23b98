"""``chip_smoke.py`` phase 18's CPU-checkable parts at SMOKE sizes: the
streamed float32 plain path it holds the large models against (the
three dense ones and the MoE stacks, deepseek-moe-16b's and
granite-moe's: routed and dropped as ``M.prefill`` routes and drops),
and gemma2's rolling cache across two wraps of its ring, against the JAX
package.

Tolerances and why:

  * the streamed path against ``M.prefill`` on a whole float32 copy: bit
    for bit (the same functions on the same float32 values; the head's
    vocabulary chunks change no sum, each logit is one row's dot product);
  * against JAX's float32 prefill logits and gemma2's prefill: 1e-4, as
    ``tests/test_torch_models.py`` holds the f32 logits (the sums run in
    another order);
  * gemma2's decode steps read bf16 caches: 2e-2 each, with equal greedy
    tokens (``test_prefill_decode_match_jax``'s rule).
"""

import copy
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import model as JM
from repro.train.steps import make_decode_step as jdecode_step
from repro.train.steps import make_prefill_step as jprefill_step
from repro_torch.configs.registry import get_config
from repro_torch.models import model as TM
from repro_torch.train.steps import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
LARGE = ["gemma2-27b", "command-r-35b", "chameleon-34b"]
MOE = ["deepseek-moe-16b", "granite-moe-3b-a800m"]
B, S = 2, 12
HEAD_ROWS = 96        # three vocabulary chunks of SMOKE's 256, the last ragged


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy(),
        np.asarray(jnp.asarray(want, jnp.float32)), rtol=tol, atol=tol)


def tokens(cfg, n: int = S) -> np.ndarray:
    return np.random.default_rng(7).integers(0, cfg.vocab, (B, n)).astype(
        np.int32)


def test_large_dense_are_phase_18s(chip_smoke):
    assert [a for a, _, _ in chip_smoke.LARGE_MODELS] == LARGE + MOE[:1]


@pytest.mark.parametrize("arch", LARGE + MOE)
def test_streamed_prefill_equals_whole_f32_copy(chip_smoke, arch):
    """bf16 parameters (as phase 18 draws them): the streamed path, one
    unit and one head chunk in float32 at a time, against ``M.prefill``
    with ``attn_impl="ref"`` on a whole float32 copy."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="bfloat16")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = {"tokens": t(tokens(cfg))}
    got = chip_smoke.streamed_prefill_f32(params, cfg, batch,
                                          head_rows=HEAD_ROWS)
    whole = copy.deepcopy(params).float()
    want = TM.prefill(whole, dataclasses.replace(cfg, attn_impl="ref"),
                      batch)[0]
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
    assert torch.equal(got, want)


@pytest.mark.parametrize("moe_groups", [1, 2])
def test_streamed_prefill_drops_as_prefill(chip_smoke, moe_groups):
    """deepseek's SMOKE stack at capacity factor 1 (pairs dropped) in one
    and two MoE groups: the streamed path keeps and drops the (token,
    slot) pairs ``M.prefill`` does at the same ``moe_groups``, bit for
    bit."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              param_dtype="bfloat16", capacity_factor=1.0)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = {"tokens": t(tokens(cfg))}
    plan, dropped = moe._capacity_plan, []

    def counting(idx, *a, **kw):
        out = plan(idx, *a, **kw)
        dropped.append(int((~out[0]).sum()))
        return out
    moe._capacity_plan = counting
    try:
        got = chip_smoke.streamed_prefill_f32(params, cfg, batch,
                                              head_rows=HEAD_ROWS,
                                              moe_groups=moe_groups)
    finally:
        moe._capacity_plan = plan
    whole = copy.deepcopy(params).float()
    want = TM.prefill(whole, dataclasses.replace(cfg, attn_impl="ref"),
                      batch, moe_groups=moe_groups)[0]
    assert sum(dropped) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", LARGE + MOE)
def test_streamed_prefill_matches_jax(chip_smoke, arch):
    """JAX's float32 SMOKE parameters carried across: the streamed path
    against JAX's float32 prefill logits (its plain attention)."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               attn_impl="ref")
    cfg = get_config(arch, smoke=True)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                cfg, device="cpu")
    toks = tokens(cfg)
    want = jax.jit(jprefill_step(jcfg, s_max=S, compute_dtype=jnp.float32))(
        jparams, {"tokens": jnp.asarray(toks)})[0]
    got = chip_smoke.streamed_prefill_f32(params, cfg, {"tokens": t(toks)},
                                          head_rows=HEAD_ROWS)
    close(got, want, 1e-4)


def test_streamed_prefill_refuses_ssm_stacks(chip_smoke):
    cfg = get_config("mamba2-1.3b", smoke=True)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    with pytest.raises(ValueError, match="attention layers only"):
        chip_smoke.streamed_prefill_f32(params, cfg,
                                        {"tokens": t(tokens(cfg))})


WINDOW = 8
PROMPT = 3 * WINDOW - 1           # the ring holds the last 8 of 23
STEPS = 2 * WINDOW                # decoding wraps it twice more


@pytest.mark.parametrize("attn_impl", ["flash", "ref"])
def test_gemma2_rolling_cache_wraps_twice_matches_jax(attn_impl):
    """gemma2 at d_model 72 (√72 is not exact in bf16), head dim 16 and
    window 8: prefill 3 windows less a token, then decode 2 windows'
    worth of greedy tokens (JAX's, fed to both), so each local layer's
    ring of 8 slots wraps twice; every step's logits against JAX's."""
    kw = dict(d_model=72, head_dim=16, window=WINDOW, attn_impl=attn_impl)
    jcfg = dataclasses.replace(jget_config("gemma2-27b", smoke=True), **kw)
    cfg = dataclasses.replace(get_config("gemma2-27b", smoke=True), **kw)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                cfg, device="cpu")
    toks = tokens(cfg, PROMPT)
    s_max = PROMPT + STEPS
    jpre = jax.jit(jprefill_step(jcfg, s_max=s_max,
                                 compute_dtype=jnp.float32))
    jdec = jax.jit(jdecode_step(jcfg, compute_dtype=jnp.float32))
    pre = make_prefill_step(cfg, s_max=s_max, compute_dtype=torch.float32)
    dec = make_decode_step(cfg, compute_dtype=torch.float32)

    jl, jcache, jlen = jpre(jparams, {"tokens": jnp.asarray(toks)})
    tl, tcache, tlen = pre(params, {"tokens": t(toks)})
    assert tlen == int(jlen) == PROMPT
    close(tl, jl, 1e-4)
    rings = {TM._layer_kind(cfg, pos): tcache[0][f"l{pos}"][0].shape[1]
             for pos in range(cfg.period)}
    assert rings == {"local": WINDOW, "global": s_max}
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    assert torch.equal(torch.argmax(tl, dim=-1), t(tok[:, 0]).long())
    for i in range(STEPS):
        jl, jcache = jdec(jparams, tok, jcache, jlen + i)
        tl, tcache = dec(params, t(tok), tcache, tlen + i)
        close(tl, jl, 2e-2)
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
        assert torch.equal(torch.argmax(tl, dim=-1), t(tok[:, 0]).long())
