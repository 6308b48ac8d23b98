"""The port's model serving path against the JAX package, at SMOKE sizes:
the dense families, the MoE families (granite-moe, deepseek-moe), the
Mamba2 SSM and the hybrid (zamba2, with its shared attention block).

The JAX package draws the parameters (``init_params`` from a PRNG key);
``params_from_jax`` carries them across; the same numpy prompts go
through both.  Tolerances and why:

  * layers and the f32 forward / prefill logits: 1e-4 (float32 on both
    sides; the sums run in another order, a few ulps on logits of
    magnitude ~10);
  * the KV caches: bf16 (both sides round the same float32 keys and
    values to bf16; one that lies on a rounding boundary may land one
    bf16 ulp apart), so 1e-2;
  * the SSM caches: the conv windows bf16 (1e-2, as the KV caches), the
    state float32 (1e-4, as the logits);
  * decode logits read those bf16 caches: 2e-2, the tolerance of the
    JAX package's own prefill/decode test; greedy tokens equal; so is
    prefill-then-decode against the full forward at the next position
    (the JAX package's ``test_prefill_decode_consistency``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.train.steps import make_decode_step as jdecode_step
from repro.train.steps import make_prefill_step as jprefill_step
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train.steps import (cast_for_compute, make_decode_step,
                                     make_prefill_step)

# every dense-attention arch of the registry: no experts, no SSM, tokens in
DENSE = [a for a in ARCH_IDS
         if not (get_config(a).n_experts or get_config(a).ssm
                 or get_config(a).inputs_embeds)]
# the families with experts, an SSM or the hybrid's shared block
NEW = ["granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-1.3b",
       "zamba2-2.7b"]
TOKEN_ARCHS = DENSE + NEW
B, S, GEN = 2, 12, 3


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy(),
        np.asarray(jnp.asarray(want, jnp.float32)), rtol=tol, atol=tol)


def test_dense_archs_are_the_five():
    assert DENSE == ["gemma2-27b", "command-r-35b", "smollm-135m", "yi-9b",
                     "chameleon-34b"]


def test_new_families_are_the_four():
    assert sorted(set(ARCH_IDS) - set(DENSE) - {"hubert-xlarge"}) == \
        sorted(NEW)


def test_configs_are_copies():
    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                    == dataclasses.asdict(jget_config(arch, smoke=smoke)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    s = rng.standard_normal(48).astype(np.float32) * 0.1
    close(TL.rms_norm(t(x), t(s), 1e-6),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6), 1e-5)


@pytest.mark.parametrize("theta", [10000.0, 8_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)[None, :]
    close(TL.apply_rope(t(x), t(pos), theta),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-4)


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0), (True, 5, 0.0),
                                               (True, 0, 20.0),
                                               (False, 0, 0.0)])
def test_blockwise_attention_matches_jax(causal, window, cap):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 21, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 21, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 21, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, cap=cap, q_block=8, kv_block=8)
    close(TL.blockwise_attention(t(q), t(k), t(v), **kw),
          JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw), 1e-5)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (0, 30.0)])
def test_decode_attention_matches_jax(window, cap):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    for clen in (13, np.array([7, 20], np.int32)):
        close(TL.decode_attention(t(q), t(kc), t(vc), torch.as_tensor(clen),
                                  cap=cap, window=window),
              JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(clen),
                                  cap=cap, window=window), 1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_apply_matches_jax(act):
    p = JL.mlp_init(jax.random.PRNGKey(4), 48, 96, jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, 5, 48)).astype(np.float32)
    close(TL.mlp_apply({k: t(v) for k, v in p.items()}, t(x), act),
          JL.mlp_apply(p, jnp.asarray(x), act), 1e-4)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_init_params_shapes_match_jax(arch):
    """The port's random init has the JAX package's tree, shapes, dtypes
    and (roughly) scales; the numbers differ (another generator)."""
    cfg = get_config(arch, smoke=True)
    mine = TM.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    theirs = TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, JM.init_params(
            jax.random.PRNGKey(0), jget_config(arch, smoke=True))),
        cfg, device="cpu")
    a, b = dict(mine.named_parameters()), dict(theirs.named_parameters())
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].shape == b[name].shape, name
        assert a[name].dtype == b[name].dtype == torch.float32, name
        if a[name].dim() >= 2:
            ratio = a[name].std() / b[name].std()
            assert 0.8 < ratio < 1.25, (name, ratio)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------

def _both(arch, attn_impl):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               attn_impl=attn_impl)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl=attn_impl)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, S + GEN))
    return jcfg, cfg, jparams, params, toks.astype(np.int32)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_forward_matches_jax(arch):
    jcfg, cfg, jparams, params, toks = _both(arch, "flash")
    want = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got = TM.forward(params, cfg, {"tokens": t(toks)})
    assert got.shape == (B, S + GEN, cfg.vocab) and got.dtype == torch.float32
    close(got, want, 1e-4)


@pytest.mark.parametrize("attn_impl", ["flash", "ref"])
def test_hubert_forward_head_dim_80_matches_jax(attn_impl):
    """hubert-xlarge (frame embeddings in, bidirectional) at SMOKE width
    with its full head dim, 80: the flash path runs the plain version on
    the CPU at a head dim no kernel of the SMOKE configs uses."""
    jcfg = dataclasses.replace(jget_config("hubert-xlarge", smoke=True),
                               head_dim=80, attn_impl=attn_impl)
    cfg = dataclasses.replace(get_config("hubert-xlarge", smoke=True),
                              head_dim=80, attn_impl=attn_impl)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                cfg, device="cpu")
    emb = np.random.default_rng(7).standard_normal(
        (B, 16, cfg.d_model)).astype(np.float32)
    ops.reset_kernel_stats()
    got = TM.forward(params, cfg, {"embeds": t(emb)})
    want = JM.forward(jparams, jcfg, {"embeds": jnp.asarray(emb)})
    assert got.shape == (B, 16, cfg.vocab) and got.dtype == torch.float32
    close(got, want, 1e-4)
    assert ops.kernel_stats().get("flash_attention_fwd:ref", 0) == (
        cfg.num_layers if attn_impl == "flash" else 0)


@pytest.mark.parametrize("attn_impl", ["flash", "ref"])
@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_prefill_decode_match_jax(arch, attn_impl):
    """Prefill logits and caches, then GEN greedy decode steps.  gemma2's
    SMOKE window (8) is below the prompt (12), so its local layers use
    the rolling cache; zamba2's units also hold the shared block's."""
    jcfg, cfg, jparams, params, toks = _both(arch, attn_impl)
    s_max = S + GEN + 1
    jpre = jax.jit(jprefill_step(jcfg, s_max=s_max,
                                 compute_dtype=jnp.float32))
    jdec = jax.jit(jdecode_step(jcfg, compute_dtype=jnp.float32))
    pre = make_prefill_step(cfg, s_max=s_max, compute_dtype=torch.float32)
    dec = make_decode_step(cfg, compute_dtype=torch.float32)

    ops.reset_kernel_stats()
    jl, jcache, jlen = jpre(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tcache, tlen = pre(params, {"tokens": t(toks[:, :S])})
    assert tlen == int(jlen) == S
    close(tl, jl, 1e-4)
    flash_calls = ops.kernel_stats().get("flash_attention_fwd:ref", 0)
    assert flash_calls == (TM.n_attention_layers(cfg) if attn_impl == "flash" else 0)
    for u, ucache in enumerate(tcache):
        assert ucache.keys() == jcache.keys()
        for name, layer in ucache.items():
            for got, want in zip(layer, jcache[name]):
                assert got.shape == want.shape[1:]
                if got.dtype == torch.float32:      # an SSM state
                    assert cfg.ssm and got.dim() == 4
                    close(got, want[u], 1e-4)
                else:
                    assert got.dtype == torch.bfloat16
                    close(got, want[u], 1e-2)
    if arch == "gemma2-27b":
        assert tcache[0]["l0"][0].shape[1] == cfg.window < s_max

    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    assert torch.equal(torch.argmax(tl, dim=-1), t(tok[:, 0]).long())
    for i in range(GEN):
        jl, jcache = jdec(jparams, tok, jcache, jlen + i)
        tl, tcache = dec(params, t(tok), tcache, tlen + i)
        close(tl, jl, 2e-2)
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
        assert torch.equal(torch.argmax(tl, dim=-1), t(tok[:, 0]).long())


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_prefill_decode_consistency(arch):
    """The JAX package's own check (``test_models_smoke.py``) on the port,
    with its inputs (JAX's parameters from key 0, 2 x 32 tokens from
    numpy seed 0): prefill all but the last token, decode it, and the
    logits match the full-sequence forward at that position (2e-2,
    float32 compute, bf16 caches)."""
    _, cfg, _, params, _ = _both(arch, "flash")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)).astype(
        np.int32)
    pre = make_prefill_step(cfg, s_max=32 + 4, compute_dtype=torch.float32)
    dec = make_decode_step(cfg, compute_dtype=torch.float32)
    _, cache, n = pre(params, {"tokens": t(toks[:, :-1])})
    got, _ = dec(params, t(toks[:, -1:]), cache, n)
    want = TM.forward(params, cfg, {"tokens": t(toks)})[:, -1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_concrete(arch):
    """``abstract_params`` is ``init_params``'s tree on the meta device,
    and its leaves are JAX's ``abstract_params``' (units unstacked)."""
    cfg = get_config(arch, smoke=True)
    abstract = TM.abstract_params(cfg)
    concrete = TM.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    got = [(n, tuple(p.shape), p.dtype) for n, p in
           abstract.named_parameters()]
    assert all(p.device.type == "meta" for p in abstract.parameters())
    assert got == [(n, tuple(p.shape), p.dtype)
                   for n, p in concrete.named_parameters()]
    want = {"/".join(str(k.key) for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                JM.abstract_params(jget_config(arch, smoke=True)))}
    mine = {}
    for n, p in abstract.named_parameters():
        parts = n.split(".")
        if parts[0] == "units":                  # JAX stacks the units
            key, shape = "/".join(["units"] + parts[2:]), (cfg.n_units,)
        else:
            key, shape = "/".join(parts), ()
        mine.setdefault(key, (shape + tuple(p.shape),
                              str(p.dtype).split(".")[-1]))
    assert mine == want


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-moe-16b"])
def test_moe_forward_with_drops_matches_jax(arch):
    """At capacity factor 1.0 the SMOKE forward drops (token, slot)
    pairs; the port's one-group dispatch drops the JAX package's
    (``moe_groups=1``), so the logits agree at the forward's 1e-4."""
    jcfg, cfg, jparams, params, toks = _both(arch, "flash")
    jcfg = dataclasses.replace(jcfg, capacity_factor=1.0)
    lossless = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                   / cfg.top_k)
    cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    got = TM.forward(params, cfg, {"tokens": t(toks)})
    close(got, JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                          moe_groups=1), 1e-4)
    keep_all = TM.forward(params, lossless, {"tokens": t(toks)})
    assert (got - keep_all).abs().max() > 1e-3      # pairs were dropped


def test_cast_for_compute_casts_matrices_once():
    cfg = get_config("smollm-135m", smoke=True)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    half = cast_for_compute(params, torch.bfloat16)
    assert half["embed"].dtype == torch.bfloat16
    # F8, mirrored: a unit's vectors are matrices in the JAX unit stack
    assert half["units"][0]["l0"]["ln1"].dtype == torch.bfloat16
    assert half["final_norm"].dtype == torch.float32
    assert half["units"][0]["l0"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert cast_for_compute(half, torch.bfloat16) is half
    assert cast_for_compute(params, torch.float32) is params
    logits, cache, n = TM.prefill(half, cfg, {"tokens": torch.zeros(
        (1, 5), dtype=torch.int32)}, s_max=8)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert cache[0]["l0"][0].shape == (1, 8, cfg.n_kv, cfg.head_dim)


def test_serve_main_runs_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "9", "--gen-len", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests x 4 tokens on cpu" in out
    assert "sample continuation ids" in out
    assert serve.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                       "cpu"]) == 0
    assert "encoder-only" in capsys.readouterr().out
    # the retrieval plane is ported: both modes run on the CPU too
    # (held against the JAX package's CLI in tests/test_torch_serve_cli.py)
    for flag, line in (("--retrieval", "retrieval: tau=3 hits per request"),
                       ("--ingest", "post-merge scheduled topk")):
        assert serve.main(["--smoke", "--device", "cpu", "--index-size",
                           "256", flag]) == 0
        assert line in capsys.readouterr().out


@pytest.mark.parametrize("arch", NEW)
def test_serve_main_serves_the_new_families(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "9",
                       "--gen-len", "4"]) == 0
    assert "served 2 requests x 4 tokens on cpu" in capsys.readouterr().out
