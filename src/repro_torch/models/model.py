"""Unified model: the port of the JAX package's ``models/model.py`` —
every architecture of the registry is one ``ModelConfig`` interpreted by
the same apply functions.

Structure: an embedding (or frontend-supplied embeds), ``n_units``
repeating *units*, a final norm and a (tied) LM head.  A unit is
``period`` consecutive layers — attention (global or sliding-window)
followed by a gated MLP or a Mixture-of-Experts block (``moe.py``), or a
Mamba2 SSD block (``ssm.py``); Zamba2-style hybrids also run a *shared*
attention block (``params["shared"]``, the same parameters at every
invocation) at the end of each unit.  The parameters are a
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
``{"l{pos}": (k, v)}``, each (B, S_cache, Hkv, D), or an
``ssm.SSMCache`` (conv windows in the cache dtype, the state in float32)
for an SSM layer, plus ``"shared": (k, v)`` for the hybrid's shared
block; ``decode_step`` writes the new token's keys and values into the
KV caches in place (saving a copy of every cache per token), replaces
the SSM caches, and returns the same list.

Under a mesh (``distributed.sharding.use_mesh``, a
``launch.mesh.Mesh`` of ranks) every entry point runs on this rank's
rows of the batch, as the JAX package's do under ``use_mesh``:

  * with a "model" axis the MoE blocks take the expert-parallel path
    (``moe_sharded.moe_apply_sharded``; their weights are the rank's
    shards, ``distributed.sharding.shard_state``), and a config with
    ``decode_kv_shard="seq"`` keeps each rank's slice of the sequence
    axis of every non-rolling KV cache (``init_cache``, ``prefill``) and
    decodes through ``decode_sp.decode_attention_seq_sharded``;
  * otherwise MoE dispatch runs ``moe_groups`` groups over the global
    batch (``prefill`` and ``decode_step`` take it; ``forward`` runs one
    group): each rank's rows hold ``moe_groups / ranks`` whole groups,
    or with ``moe_groups=1`` the ranks exchange their per-expert counts,
    so capacity and drops are the global batch's (``moe.moe_apply``'s
    ``mesh=``).

Training runs under a mesh too (``train.steps.make_train_step``):
``forward`` and ``loss_fn`` take ``moe_groups`` as the JAX package's do,
the parameters are the rank's shards of the training placement
(``distributed.sharding.shard_state``: FSDP over "data", experts over
"model"), and

  * each unit gathers its FSDP-sharded leaves over "data" *inside* its
    ``checkpoint`` region (``moe_sharded._GatherData``: an all-gather
    whose backward sums the gradient over "data" and keeps the rank's
    slice), so remat re-gathers them in the backward, as XLA
    rematerialises an FSDP all-gather, and no whole weight is saved for
    the backward; the top-level leaves (embedding, final norm, LM head)
    are gathered once a call.  The parameters arrive already cast to the
    compute type (``train.steps.cast_for_compute``), so the gathers carry
    bf16 on the card, as the JAX package's ``distributed/compression.py``
    tier 1 says, and so does the gradient's reduction over "data" (the
    gradient of the compute copy, cast to float32 after it);
  * ``loss_fn`` returns the global mean: Σ nll and Σ mask, each summed
    over (pod, data) — not the mean of the ranks' means, which differs
    wherever the ranks' unmasked counts differ.  The sum's backward is
    the identity, so each rank's gradients are its rows' share, summed
    over the ranks by the train step.

A leaf whose shape is already whole (serving with a data axis of 1, the
divisibility fallback) is not gathered.  The dense layers run whole on
every model rank: the JAX package's ``constrain`` annotations have no
counterpart (``distributed/sharding.py`` says why).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.hamming import resolve_device
from ..distributed.sharding import dp_shards, get_global_mesh, train_specs
from .config import ModelConfig
from .decode_sp import decode_attention_seq_sharded
from .flash import flash_attention
from .layers import (Params, apply_rope, blockwise_attention,
                     decode_attention, mlp_apply, mlp_init, normal, rms_norm,
                     scaled_normal, softcap)
from .moe import moe_apply, moe_init
from .moe_sharded import _GatherData, moe_apply_sharded
from .ssm import (SSMCache, SSMConfig, ssm_apply, ssm_cache_init,
                  ssm_decode_step, ssm_init, ssm_prefill_cache)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Cache = List[Dict[str, object]]


def ssm_cfg(cfg: ModelConfig) -> SSMConfig:
    return SSMConfig(d_model=cfg.d_model, d_inner=cfg.d_inner,
                     d_state=cfg.d_state, head_dim=cfg.ssm_head_dim,
                     d_conv=cfg.d_conv, chunk=cfg.chunk)


def _has_shared(cfg: ModelConfig) -> bool:
    return bool(cfg.ssm and cfg.shared_attn_every)


def n_attention_layers(cfg: ModelConfig) -> int:
    """Attention layers a forward or prefill runs: every layer of an
    attention stack, the hybrid's shared block once a unit, none in an
    SSM."""
    return (0 if cfg.ssm else cfg.num_layers) + (
        cfg.n_units if _has_shared(cfg) else 0)


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
        "wq": scaled_normal(gen, s, dtype, d, H, hd),
        "wk": scaled_normal(gen, s, dtype, d, Kv, hd),
        "wv": scaled_normal(gen, s, dtype, d, Kv, hd),
        "wo": scaled_normal(gen, so, dtype, H, hd, d),
        "ln2": torch.zeros((d,), dtype=dtype, device=dev),
    }
    if cfg.n_experts:
        p["moe"] = moe_init(gen, d, cfg.n_experts, cfg.moe_d_ff,
                            cfg.n_shared, dtype)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, dtype)
    if cfg.post_norms:
        p["post_ln1"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["post_ln2"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def _ssm_layer_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                    dtype) -> dict:
    dev = gen.device if gen is not None else torch.device("meta")
    return {"ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
            "ssm": ssm_init(gen, ssm_cfg(cfg), dtype)}


def _param_tree(gen: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """The parameters' nested dict, drawn from ``gen`` on its device (on
    the ``meta`` device, undrawn, when ``gen`` is None)."""
    dtype = _DTYPES[cfg.param_dtype]
    dev = gen.device if gen is not None else torch.device("meta")
    layer_init = _ssm_layer_init if cfg.ssm else _attn_layer_init
    tree: dict = {}
    if not cfg.inputs_embeds:
        tree["embed"] = normal(gen, cfg.vocab, cfg.d_model).to(dtype)
    tree["units"] = [{f"l{pos}": layer_init(gen, cfg, dtype)
                      for pos in range(cfg.period)}
                     for _ in range(cfg.n_units)]
    if _has_shared(cfg):
        tree["shared"] = _attn_layer_init(gen, cfg, dtype)
    tree["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings or cfg.inputs_embeds:
        head = normal(gen, cfg.d_model, cfg.vocab)
        tree["lm_head"] = (head if gen is None      # no arithmetic on meta
                           else head / np.sqrt(cfg.d_model)).to(dtype)
    return tree


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> Params:
    """Random parameters with the JAX package's shapes and scales, drawn
    from ``generator`` (on its own device, so a CPU generator gives the
    same weights for every ``device``) and moved to ``device``."""
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
    ``device``, every leaf under its own name:

      * top level: ``embed``, ``final_norm``, ``lm_head``, and the
        hybrid's ``shared`` block (an attention layer, not stacked);
      * ``units[u]["l{pos}"]`` of an attention layer: ``ln1``, ``wq``,
        ``wk``, ``wv``, ``wo``, ``ln2``, ``post_ln1`` / ``post_ln2``,
        and either ``mlp.{w_gate, w_up, w_down}`` or ``moe.{router,
        w_gate, w_up, w_down}`` (routed experts stacked (E, d, ff)) with
        ``moe.shared.{w_gate, w_up, w_down}`` where there are shared
        experts;
      * of an SSM layer: ``ln1`` and ``ssm.{wz, wx, wB, wC, wdt,
        out_proj, conv_x, conv_bx, conv_B, conv_bB, conv_C, conv_bC,
        A_log, D, dt_bias, norm}``.
    """
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def tree_of(tree, u=None):
        return {k: tree_of(v, u) if isinstance(v, dict)
                else tensor(v if u is None else v[u])
                for k, v in tree.items()}

    tree = tree_of({k: v for k, v in params.items() if k != "units"})
    tree["units"] = [tree_of(params["units"], u)
                     for u in range(cfg.n_units)]
    return Params(tree)


_PLACEMENTS: dict = {}


def placement(cfg: ModelConfig, mesh) -> Tuple[dict, dict]:
    """({name: spec}, {name: whole shape}) of the training placement of
    ``cfg``'s parameters under ``mesh`` (cached per config and mesh
    shape)."""
    key = (cfg, mesh.axis_names, tuple(mesh.shape[a]
                                       for a in mesh.axis_names))
    if key not in _PLACEMENTS:
        abstract = abstract_params(cfg)
        _PLACEMENTS[key] = (train_specs(abstract, mesh),
                            {n: tuple(p.shape)
                             for n, p in abstract.named_parameters()})
    return _PLACEMENTS[key]


def _gathered(tree, prefix: str, cfg: ModelConfig, mesh):
    """``tree`` (a ``Params`` or a nested dict) with every FSDP shard
    gathered whole over "data" (``_GatherData``); a leaf already whole is
    kept.  ``prefix`` names the tree's leaves as the training placement
    does (a unit's as unit 0's: every unit has the same).  With a "model"
    axis the MoE blocks are left to ``moe_apply_sharded``, which gathers
    its own shards."""
    specs, shapes = placement(cfg, mesh)
    skip_moe = "model" in mesh.axis_names

    def walk(t, name):
        if isinstance(t, Params):
            t = t.tree(detach=False)
        if isinstance(t, dict):
            if skip_moe and name.endswith("moe."):
                return t
            return {k: walk(v, f"{name}{k}.") for k, v in t.items()}
        if tuple(t.shape) == shapes[name[:-1]]:
            return t
        for dim, entry in enumerate(specs[name[:-1]]):
            if entry is not None:           # "data": the only axis cut here
                t = _GatherData.apply(t, mesh, dim)
        return t

    return walk(tree, prefix)


def _fsdp_mesh():
    """The global mesh when its "data" axis splits parameters, else None."""
    mesh = get_global_mesh()
    return mesh if mesh is not None and mesh.shape.get("data", 1) > 1 \
        else None


def _whole_top(params, cfg: ModelConfig, mesh):
    """``params`` read with its top-level leaves (embedding, final norm,
    LM head) gathered whole; the units and the shared block untouched
    (gathered per unit)."""
    if mesh is None:
        return params
    keys = (list(params._parameters) + list(params._modules)
            if isinstance(params, Params) else list(params))
    return {k: params[k] if k in ("units", "shared")
            else _gathered(params[k], f"{k}.", cfg, mesh) for k in keys}


def _whole_unit(unit, cfg: ModelConfig, mesh):
    return unit if mesh is None else _gathered(unit, "units.0.", cfg, mesh)


def _whole_shared(params, cfg: ModelConfig, mesh):
    shared = params["shared"]
    return shared if mesh is None else _gathered(shared, "shared.", cfg,
                                                 mesh)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _project_qkv(p, h: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    return q, k, v


def _moe_dispatch(moe_params, h: torch.Tensor, cfg: ModelConfig,
                  moe_groups: int) -> torch.Tensor:
    """Pick the MoE path (module doc): explicit expert parallelism when
    the mesh has a "model" axis, grouped dispatch over the global batch
    otherwise."""
    mesh = get_global_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        return moe_apply_sharded(moe_params, h, mesh, top_k=cfg.top_k,
                                 act=cfg.act,
                                 capacity_factor=cfg.capacity_factor)
    n = dp_shards(mesh) if mesh is not None else 1
    kw = dict(top_k=cfg.top_k, act=cfg.act,
              capacity_factor=cfg.capacity_factor)
    if moe_groups % n == 0:               # each rank's rows: whole groups
        return moe_apply(moe_params, h, num_groups=moe_groups // n, **kw)
    if moe_groups == 1:                   # one group over the global batch
        return moe_apply(moe_params, h, mesh=mesh, **kw)
    raise ValueError(f"{moe_groups} MoE groups over {n} data shards")


def _seq_mesh(cfg: ModelConfig, kind: str):
    """The mesh whose "model" axis splits this layer's KV cache over the
    sequence (a non-rolling layer of a ``decode_kv_shard="seq"`` config),
    or None."""
    mesh = get_global_mesh()
    if (kind != "local" and cfg.decode_kv_shard == "seq"
            and mesh is not None and "model" in mesh.axis_names):
        return mesh
    return None


def _seq_slice(mesh, s_max: int) -> Tuple[int, int]:
    """[lo, hi): this model rank's slots of an ``s_max``-slot cache."""
    m = mesh.shape["model"]
    if s_max % m:
        raise ValueError(f"{s_max} cache slots do not split over {m} model "
                         "ranks")
    n = s_max // m
    return mesh.coord("model") * n, (mesh.coord("model") + 1) * n


def _attn_decode_tail(p, x: torch.Tensor, cfg: ModelConfig,
                      attn: torch.Tensor, moe_groups: int) -> torch.Tensor:
    """Output projection, residual, MLP (or MoE) and residual of one
    layer (the prefill layer shares it)."""
    out = torch.einsum("bshk,hkd->bsd", attn, p["wo"])
    if cfg.post_norms:
        out = rms_norm(out, p["post_ln1"], cfg.norm_eps)
    x = x + out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        m = _moe_dispatch(p["moe"], h2, cfg, moe_groups)
    else:
        m = mlp_apply(p["mlp"], h2, cfg.act)
    if cfg.post_norms:
        m = rms_norm(m, p["post_ln2"], cfg.norm_eps)
    return x + m


def _attn_layer(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor, moe_groups: int = 1,
                emit_cache: bool = False):
    window = cfg.window if kind == "local" else 0
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn_fn = (flash_attention if cfg.attn_impl == "flash"
               else blockwise_attention)
    attn = attn_fn(q, k, v, causal=cfg.causal, window=window,
                   cap=cfg.softcap_attn)
    x = _attn_decode_tail(p, x, cfg, attn, moe_groups)
    return x, ((k, v) if emit_cache else None)


def _attn_layer_decode(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                       cache: Tuple[torch.Tensor, torch.Tensor],
                       cache_len: int, moe_groups: int = 1):
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
    mesh = _seq_mesh(cfg, kind)          # never a rolling (local) layer
    if mesh is not None:               # this rank's slice of the sequence
        if cache_len >= W * mesh.shape["model"]:
            raise ValueError(f"decode position {cache_len} past the cache's "
                             f"{W * mesh.shape['model']} slots")
        attn, _, _ = decode_attention_seq_sharded(
            q, k, v, k_cache, v_cache, cache_len, mesh, cap=cfg.softcap_attn)
        return _attn_decode_tail(p, x, cfg, attn, moe_groups)
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
    return _attn_decode_tail(p, x, cfg, attn, moe_groups)


def _ssm_layer(p, x: torch.Tensor, cfg: ModelConfig, *,
               cache_dtype: Optional[torch.dtype] = None):
    """One SSM layer; given a ``cache_dtype``, also its ``SSMCache``
    (conv windows in that dtype, the state in float32)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cache_dtype is None:
        return x + ssm_apply(p["ssm"], h, ssm_cfg(cfg),
                             norm_eps=cfg.norm_eps), None
    out, state = ssm_apply(p["ssm"], h, ssm_cfg(cfg), norm_eps=cfg.norm_eps,
                           return_state=True)
    return x + out, ssm_prefill_cache(p["ssm"], h, state, ssm_cfg(cfg),
                                      dtype=cache_dtype)


def _ssm_layer_decode(p, x: torch.Tensor, cfg: ModelConfig, *,
                      cache: SSMCache):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, new_cache = ssm_decode_step(p["ssm"], h, cache, ssm_cfg(cfg),
                                     norm_eps=cfg.norm_eps)
    return x + out, new_cache


def _layer_kind(cfg: ModelConfig, pos: int) -> str:
    if cfg.ssm:
        return "ssm"
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


def forward(params, cfg: ModelConfig, batch: Dict, *, moe_groups: int = 1,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> (B, S, vocab) f32 logits, differentiable
    in the parameters.  ``remat`` recomputes each unit's activations in
    the backward (``torch.utils.checkpoint`` per unit, the JAX package's
    ``jax.checkpoint`` around its scanned unit); under a mesh each unit
    gathers its FSDP shards inside that region (module doc)."""
    mesh = _fsdp_mesh()
    params = _whole_top(params, cfg, mesh)
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]

    def unit_fn(h, unit):
        unit = _whole_unit(unit, cfg, mesh)
        for pos in range(cfg.period):
            kind = _layer_kind(cfg, pos)
            if kind == "ssm":
                h, _ = _ssm_layer(unit[f"l{pos}"], h, cfg)
            else:
                h, _ = _attn_layer(unit[f"l{pos}"], h, cfg, kind,
                                   positions=positions,
                                   moe_groups=moe_groups)
        if _has_shared(cfg):
            h, _ = _attn_layer(_whole_shared(params, cfg, mesh), h, cfg,
                               "global", positions=positions,
                               moe_groups=moe_groups)
        return h

    for unit in params["units"]:
        x = (checkpoint(unit_fn, x, unit, use_reentrant=False) if remat
             else unit_fn(x, unit))
    return _lm_logits(params, cfg, x)


class _SumRanks(torch.autograd.Function):
    """All-reduce (sum) over (pod, data); the backward is the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(), ("pod", "data"))

    @staticmethod
    def backward(ctx, g):
        return g, None


def loss_fn(params, cfg: ModelConfig, batch: Dict, *, moe_groups: int = 1,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token (or frame-label) cross entropy, a float32 scalar.

    LM batches: {"tokens" (B,S), "targets" (B,S)} — targets are the
    pipeline-shifted next tokens; positions with target < 0 are masked.
    Frontend-stub batches: {"embeds" (B,S,d), "targets" (B,S)}.  Under a
    mesh, ``batch`` is this rank's rows and the mean is the global
    batch's (module doc): every rank returns the same value.
    """
    logits = forward(params, cfg, batch, moe_groups=moe_groups, remat=remat)
    targets = batch["targets"]
    mask = (targets >= 0).to(torch.float32)
    t_safe = torch.clamp(targets, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    mesh = get_global_mesh()
    if mesh is None:
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    sums = _SumRanks.apply(torch.stack([nll.sum(), mask.sum()]), mesh)
    return sums[0] / torch.clamp(sums[1], min=1.0)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, *, device="cuda") -> Cache:
    """Empty per-unit caches for ``batch`` rows (this rank's, under a
    mesh) of ``s_max`` positions; under a mesh that splits the sequence
    (module doc) a non-rolling KV cache holds this rank's s_max / m
    slots."""
    dev = resolve_device(device)

    def kv(kind):
        # local layers: rolling window cache
        s_c = min(cfg.window, s_max) if kind == "local" else s_max
        mesh = _seq_mesh(cfg, kind)
        if mesh is not None:
            lo, hi = _seq_slice(mesh, s_max)
            s_c = hi - lo
        shape = (batch, s_c, cfg.n_kv, cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def layer(pos):
        kind = _layer_kind(cfg, pos)
        if kind == "ssm":
            return ssm_cache_init(batch, ssm_cfg(cfg), dtype, device=dev)
        return kv(kind)

    def unit():
        caches = {f"l{pos}": layer(pos) for pos in range(cfg.period)}
        if _has_shared(cfg):
            caches["shared"] = kv("global")
        return caches

    return [unit() for _ in range(cfg.n_units)]


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: Dict, *,
            s_max: Optional[int] = None, moe_groups: int = 1,
            cache_dtype=torch.bfloat16):
    """Forward + emit caches.  Returns (last-position logits (B, vocab)
    f32, cache, cache_len); under a mesh that splits the sequence each
    non-rolling KV cache is this rank's slice (``init_cache``)."""
    mesh = _fsdp_mesh()
    params = _whole_top(params, cfg, mesh)
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    s_max = s_max or S
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]

    def pad_kv(kv, kind):
        W = min(cfg.window, s_max) if kind == "local" else s_max
        rolling = kind == "local" and W < s_max
        W = W if rolling else max(W, S)
        mesh = _seq_mesh(cfg, kind)
        lo, hi = _seq_slice(mesh, W) if mesh is not None else (0, W)
        out = []
        for t in kv:
            buf = torch.zeros((B, hi - lo) + t.shape[2:], dtype=cache_dtype,
                              device=t.device)
            if rolling:
                # rolling cache: keep the last W keys, each at slot p % W
                first = max(S - W, 0)
                buf[:, torch.arange(first, S, device=t.device) % W] = \
                    t[:, first:S].to(cache_dtype)
            elif lo < S:                   # this rank's slots [lo, hi)
                buf[:, :min(hi, S) - lo] = t[:, lo:hi].to(cache_dtype)
            out.append(buf)
        return tuple(out)

    cache: Cache = []
    for unit in params["units"]:
        unit = _whole_unit(unit, cfg, mesh)
        caches = {}
        for pos in range(cfg.period):
            kind = _layer_kind(cfg, pos)
            if kind == "ssm":
                x, caches[f"l{pos}"] = _ssm_layer(unit[f"l{pos}"], x, cfg,
                                                  cache_dtype=cache_dtype)
                continue
            x, kv = _attn_layer(unit[f"l{pos}"], x, cfg, kind,
                                positions=positions, moe_groups=moe_groups,
                                emit_cache=True)
            caches[f"l{pos}"] = pad_kv(kv, kind)
        if _has_shared(cfg):
            x, kv = _attn_layer(_whole_shared(params, cfg, mesh), x, cfg,
                                "global", positions=positions,
                                moe_groups=moe_groups, emit_cache=True)
            caches["shared"] = pad_kv(kv, "global")
        cache.append(caches)
    logits = _lm_logits(params, cfg, x[:, -1:])
    return logits[:, 0], cache, S


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Cache, cache_len: int, *, moe_groups: int = 1):
    """One decode step.  tokens: (B, 1) int (or embeds (B, 1, d));
    ``cache_len``: the position the new token takes.  Returns (logits
    (B, vocab) f32, cache), the KV caches updated in place and the SSM
    caches replaced in the same list."""
    cache_len = int(cache_len)
    batch = {"tokens": tokens} if not cfg.inputs_embeds else {"embeds": tokens}
    mesh = _fsdp_mesh()
    params = _whole_top(params, cfg, mesh)
    x = embed_inputs(params, cfg, batch)
    for unit, ucache in zip(params["units"], cache):
        unit = _whole_unit(unit, cfg, mesh)
        for pos in range(cfg.period):
            kind = _layer_kind(cfg, pos)
            if kind == "ssm":
                x, ucache[f"l{pos}"] = _ssm_layer_decode(
                    unit[f"l{pos}"], x, cfg, cache=ucache[f"l{pos}"])
            else:
                x = _attn_layer_decode(unit[f"l{pos}"], x, cfg, kind,
                                       cache=ucache[f"l{pos}"],
                                       cache_len=cache_len,
                                       moe_groups=moe_groups)
        if _has_shared(cfg):
            x = _attn_layer_decode(_whole_shared(params, cfg, mesh), x, cfg,
                                   "global", cache=ucache["shared"],
                                   cache_len=cache_len,
                                   moe_groups=moe_groups)
    logits = _lm_logits(params, cfg, x)
    return logits[:, 0], cache
