"""The dense-attention model: the port of the JAX package's
``models/model.py`` for the families with no experts and no SSM.

Structure: an embedding, ``n_units`` repeating *units* (``period``
consecutive attention layers, global or sliding-window, each followed by
a gated MLP), a final norm and a (tied) LM head.  The parameters are a
``layers.Params`` module read like the JAX pytree (``params["units"]``
is a ``ModuleList`` of units, unit ``u`` holding ``l0 .. l{period-1}``);
``params_from_jax`` carries a JAX parameter pytree across, unstacking
its ``(n_units, …)`` leading axis.

Entry points: ``forward`` (full-sequence logits, differentiable, with
``remat`` per unit as the JAX package's ``jax.checkpoint``), ``loss_fn``
(the masked mean next-token NLL of training), ``prefill`` (forward +
bf16 KV caches) and ``decode_step`` (one token against the caches);
``abstract_params`` gives the parameters' shapes and dtypes on the
``meta`` device.  The caches are a list over units of
``{"l{pos}": (k, v)}``, each (B, S_cache, Hkv, D); ``decode_step``
writes the new token's keys and values into them in place (saving a
copy of every cache per token) and returns the same list.

One card, no mesh: the JAX package's ``constrain`` annotations and its
sequence-sharded decode branch have no counterpart.  MoE
(``n_experts``), SSM (``ssm``) and hybrid (``shared_attn_every``)
configurations raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.hamming import resolve_device
from .config import ModelConfig
from .flash import flash_attention
from .layers import (Params, apply_rope, blockwise_attention,
                     decode_attention, mlp_apply, mlp_init, normal, rms_norm,
                     softcap)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Cache = List[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families this port does not run yet."""
    for flag, what in ((cfg.n_experts, "MoE layers (n_experts)"),
                       (cfg.ssm, "Mamba2 SSD layers (ssm)"),
                       (cfg.shared_attn_every,
                        "the hybrid shared attention block")):
        if flag:
            raise NotImplementedError(
                f"{cfg.arch_id}: {what} are not ported yet (ROADMAP Queue "
                "1, items 1.11-1.12)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_layer_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                     dtype) -> dict:
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    so = 1.0 / np.sqrt(H * hd)
    dev = gen.device if gen is not None else torch.device("meta")
    p = {
        "ln1": torch.zeros((d,), dtype=dtype, device=dev),
        "wq": (normal(gen, d, H, hd) * s).to(dtype),
        "wk": (normal(gen, d, Kv, hd) * s).to(dtype),
        "wv": (normal(gen, d, Kv, hd) * s).to(dtype),
        "wo": (normal(gen, H, hd, d) * so).to(dtype),
        "ln2": torch.zeros((d,), dtype=dtype, device=dev),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype),
    }
    if cfg.post_norms:
        p["post_ln1"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["post_ln2"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def _param_tree(gen: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """The parameters' nested dict, drawn from ``gen`` on its device (on
    the ``meta`` device, undrawn, when ``gen`` is None)."""
    check_supported(cfg)
    dtype = _DTYPES[cfg.param_dtype]
    dev = gen.device if gen is not None else torch.device("meta")
    tree: dict = {}
    if not cfg.inputs_embeds:
        tree["embed"] = normal(gen, cfg.vocab, cfg.d_model).to(dtype)
    tree["units"] = [{f"l{pos}": _attn_layer_init(gen, cfg, dtype)
                      for pos in range(cfg.period)}
                     for _ in range(cfg.n_units)]
    tree["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings or cfg.inputs_embeds:
        tree["lm_head"] = (normal(gen, cfg.d_model, cfg.vocab)
                           / np.sqrt(cfg.d_model)).to(dtype)
    return tree


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> Params:
    """Random parameters with the JAX package's shapes and scales, drawn
    from ``generator`` (on its own device, so a CPU generator gives the
    same weights for every ``device``) and moved to ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    return Params(_param_tree(generator, cfg)).to(dev)


def abstract_params(cfg: ModelConfig) -> Params:
    """``init_params``'s parameters as shapes and dtypes on the ``meta``
    device (no memory, no draws): the structure a checkpoint is restored
    into."""
    return Params(_param_tree(None, cfg))


def params_from_jax(params: dict, cfg: ModelConfig, *,
                    device="cuda") -> Params:
    """A JAX parameter pytree (nested dicts of numpy arrays, units stacked
    along a leading ``n_units`` axis) as the port's ``Params`` on
    ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def unstack(tree, u):
        return {k: unstack(v, u) if isinstance(v, dict) else tensor(v[u])
                for k, v in tree.items()}

    tree = {k: tensor(v) for k, v in params.items() if k != "units"}
    tree["units"] = [unstack(params["units"], u) for u in range(cfg.n_units)]
    return Params(tree)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _project_qkv(p, h: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    return q, k, v


def _attn_decode_tail(p, x: torch.Tensor, cfg: ModelConfig,
                      attn: torch.Tensor) -> torch.Tensor:
    """Output projection, residual, MLP and residual of one layer (the
    prefill layer shares it)."""
    out = torch.einsum("bshk,hkd->bsd", attn, p["wo"])
    if cfg.post_norms:
        out = rms_norm(out, p["post_ln1"], cfg.norm_eps)
    x = x + out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = mlp_apply(p["mlp"], h2, cfg.act)
    if cfg.post_norms:
        m = rms_norm(m, p["post_ln2"], cfg.norm_eps)
    return x + m


def _attn_layer(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor, emit_cache: bool = False):
    window = cfg.window if kind == "local" else 0
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn_fn = (flash_attention if cfg.attn_impl == "flash"
               else blockwise_attention)
    attn = attn_fn(q, k, v, causal=cfg.causal, window=window,
                   cap=cfg.softcap_attn)
    x = _attn_decode_tail(p, x, cfg, attn)
    return x, ((k, v) if emit_cache else None)


def _attn_layer_decode(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                       cache: Tuple[torch.Tensor, torch.Tensor],
                       cache_len: int):
    """One-token attention layer against a (B, S_cache, Kv, hd) cache
    pair, written in place.

    Sliding-window ("local") layers use a ROLLING cache of width
    ``min(window, s_max)``: key at absolute position p lives in slot
    p % W, so the buffer always holds exactly the attention window.
    Softmax is permutation-invariant over keys, so slot order is
    irrelevant; RoPE is applied at absolute positions before caching.
    """
    k_cache, v_cache = cache
    W = k_cache.shape[1]
    rolling = kind == "local" and W <= cfg.window
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h)
    pos = torch.full((1, 1), cache_len, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    slot = cache_len % W if rolling else cache_len
    if slot >= W:
        raise ValueError(f"decode position {cache_len} past the cache's "
                         f"{W} slots")
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    if rolling:
        attn = decode_attention(q, k_cache, v_cache, min(cache_len + 1, W),
                                cap=cfg.softcap_attn)
    else:
        attn = decode_attention(q, k_cache, v_cache, cache_len + 1,
                                cap=cfg.softcap_attn,
                                window=cfg.window if kind == "local" else 0)
    return _attn_decode_tail(p, x, cfg, attn)


def _layer_kind(cfg: ModelConfig, pos: int) -> str:
    return cfg.attn_kinds[pos % len(cfg.attn_kinds)]


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _compute_dtype_of(params) -> torch.dtype:
    """The residual-stream dtype follows the (possibly bf16-cast) params —
    callers control precision via ``train.steps.cast_for_compute``."""
    ref = params["embed"] if "embed" in params else params["lm_head"]
    return ref.dtype


def embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    dtype = _compute_dtype_of(params)
    if cfg.inputs_embeds:
        return batch["embeds"].to(dtype)
    x = params["embed"][batch["tokens"].long()].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if "lm_head" in params:
        logits = x @ params["lm_head"]
    else:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    return softcap(logits.to(torch.float32), cfg.softcap_final)


def forward(params, cfg: ModelConfig, batch: Dict, *,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> (B, S, vocab) f32 logits, differentiable
    in the parameters.  ``remat`` recomputes each unit's activations in
    the backward (``torch.utils.checkpoint`` per unit, the JAX package's
    ``jax.checkpoint`` around its scanned unit)."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]

    def unit_fn(h, unit):
        for pos in range(cfg.period):
            h, _ = _attn_layer(unit[f"l{pos}"], h, cfg, _layer_kind(cfg, pos),
                               positions=positions)
        return h

    for unit in params["units"]:
        x = (checkpoint(unit_fn, x, unit, use_reentrant=False) if remat
             else unit_fn(x, unit))
    return _lm_logits(params, cfg, x)


def loss_fn(params, cfg: ModelConfig, batch: Dict, *,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token (or frame-label) cross entropy, a float32 scalar.

    LM batches: {"tokens" (B,S), "targets" (B,S)} — targets are the
    pipeline-shifted next tokens; positions with target < 0 are masked.
    Frontend-stub batches: {"embeds" (B,S,d), "targets" (B,S)}.
    """
    logits = forward(params, cfg, batch, remat=remat)
    targets = batch["targets"]
    mask = (targets >= 0).to(torch.float32)
    t_safe = torch.clamp(targets, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, device="cuda") -> Cache:
    """Empty per-unit caches."""
    check_supported(cfg)
    dev = resolve_device(device)

    def kv(pos):
        # local layers: rolling window cache
        s_c = (min(cfg.window, s_max) if _layer_kind(cfg, pos) == "local"
               else s_max)
        shape = (batch, s_c, cfg.n_kv, cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    return [{f"l{pos}": kv(pos) for pos in range(cfg.period)}
            for _ in range(cfg.n_units)]


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: Dict, *,
            s_max: Optional[int] = None, cache_dtype=torch.bfloat16):
    """Forward + emit caches.  Returns (last-position logits (B, vocab)
    f32, cache, cache_len)."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    s_max = s_max or S
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]

    def pad_kv(kv, kind):
        W = min(cfg.window, s_max) if kind == "local" else s_max
        rolling = kind == "local" and W < s_max
        W = W if rolling else max(W, S)
        out = []
        for t in kv:
            buf = torch.zeros((B, W) + t.shape[2:], dtype=cache_dtype,
                              device=t.device)
            if rolling:
                # rolling cache: keep the last W keys, each at slot p % W
                lo = max(S - W, 0)
                buf[:, torch.arange(lo, S, device=t.device) % W] = \
                    t[:, lo:S].to(cache_dtype)
            else:
                buf[:, :S] = t.to(cache_dtype)
            out.append(buf)
        return tuple(out)

    cache: Cache = []
    for unit in params["units"]:
        caches = {}
        for pos in range(cfg.period):
            kind = _layer_kind(cfg, pos)
            x, kv = _attn_layer(unit[f"l{pos}"], x, cfg, kind,
                                positions=positions, emit_cache=True)
            caches[f"l{pos}"] = pad_kv(kv, kind)
        cache.append(caches)
    logits = _lm_logits(params, cfg, x[:, -1:])
    return logits[:, 0], cache, S


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Cache, cache_len: int):
    """One decode step.  tokens: (B, 1) int (or embeds (B, 1, d));
    ``cache_len``: the position the new token takes.  Returns (logits
    (B, vocab) f32, cache), the cache updated in place."""
    check_supported(cfg)
    cache_len = int(cache_len)
    batch = {"tokens": tokens} if not cfg.inputs_embeds else {"embeds": tokens}
    x = embed_inputs(params, cfg, batch)
    for unit, ucache in zip(params["units"], cache):
        for pos in range(cfg.period):
            x = _attn_layer_decode(unit[f"l{pos}"], x, cfg,
                                   _layer_kind(cfg, pos),
                                   cache=ucache[f"l{pos}"],
                                   cache_len=cache_len)
    logits = _lm_logits(params, cfg, x)
    return logits[:, 0], cache
