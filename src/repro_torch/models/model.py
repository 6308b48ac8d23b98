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
rows of the batch and this rank's shards of the parameters
(``distributed.sharding.shard_state``), as the JAX package's do under
``use_mesh``:

  * a "model" axis of m ranks runs the dense layers tensor parallel —
    the program GSPMD derives from the JAX package's placement and its
    ``constrain`` annotations, written out for one rank with the
    Megatron pair of ``distributed.sharding`` (``_ToModel`` into a
    region, ``_FromModel`` out of it).  Attention runs on the rank's
    H / m heads and the MLP on its d_ff / m slice, each summed over
    "model" once (after ``wo``, after ``w_down``: before gemma2's post
    norms and the residual add); where "model" splits the q heads but
    not the KV heads, ``wk`` / ``wv`` stay whole and the rank reads the
    KV heads its q heads map to.  The embedding looks up the rank's
    rows of the vocabulary (zero elsewhere) and sums over "model"; the
    LM head computes the rank's slice of the logits, which ``forward``,
    ``prefill`` and ``decode_step`` gather whole and ``loss_fn`` reduces
    vocab-parallel (a MAX over "model" of the row maxima, sums of
    exponentials and the gold logit summed over "model").  The SSM
    block runs on the rank's heads (``ssm.py``).  A dimension the axis
    does not divide stays whole (the divisibility fallback of the
    placement): that part runs whole on every rank, outside any
    region.  The norms act on the replicated residual stream on every
    rank;
  * with a "model" axis the MoE blocks take the expert-parallel path
    (``moe_sharded.moe_apply_sharded``), and a config with
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
and

  * each unit gathers its FSDP-sharded leaves over "data" *inside* its
    ``checkpoint`` region (``sharding._GatherData``: an all-gather whose
    backward sums the gradient over "data" and keeps the rank's slice),
    so remat re-gathers them in the backward, as XLA rematerialises an
    FSDP all-gather, and no whole weight is saved for the backward; the
    top-level leaves (embedding, final norm, LM head) are gathered once
    a call.  The parameters arrive already cast to the compute type
    (``train.steps.cast_for_compute``), so the gathers carry bf16 on
    the card, as the JAX package's ``distributed/compression.py`` tier
    1 says, and so does the gradient's reduction over "data" (the
    gradient of the compute copy, cast to float32 after it);
  * a leaf that every model rank holds whole but reads inside a
    tensor-parallel region (``wk`` / ``wv`` under the fallback, the SSM
    block's whole leaves, the router) enters it through ``_ToModel``, so
    its gradient sums the ranks' shares; a leaf applied to the
    replicated stream (the norms, a block left whole) gets the same
    whole gradient on every rank and is not summed;
  * ``loss_fn`` returns the global mean: Σ nll and Σ mask, each summed
    over (pod, data) — not the mean of the ranks' means, which differs
    wherever the ranks' unmasked counts differ.  The sum's backward is
    the identity, so each rank's gradients are its rows' share, summed
    over the ranks by the train step.

A leaf handed in whole where the placement splits it (serving from
whole parameters) is cut to the rank's slice over "model" and not
gathered over "data".
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.hamming import resolve_device
from ..distributed.sharding import (_GatherData, dp_shards, from_model,
                                     gather_model, get_global_mesh,
                                     model_ranks, model_slice, to_model,
                                     train_specs)
from .config import ModelConfig
from .decode_sp import decode_attention_seq_sharded
from .flash import flash_attention
from .layers import (Params, apply_rope, blockwise_attention,
                     decode_attention, mlp_apply, mlp_init, normal, rms_norm,
                     scaled_normal, softcap)
from .moe import moe_apply, moe_init
from .moe_sharded import moe_apply_sharded, shard_moe_params
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
    """({name: spec}, {name: whole shape}) of the placement of ``cfg``'s
    parameters under ``mesh`` (``distributed.sharding.train_specs``;
    cached per config and mesh shape)."""
    key = (cfg, mesh.axis_names, tuple(mesh.shape[a]
                                       for a in mesh.axis_names))
    if key not in _PLACEMENTS:
        abstract = abstract_params(cfg)
        _PLACEMENTS[key] = (train_specs(abstract, mesh),
                            {n: tuple(p.shape)
                             for n, p in abstract.named_parameters()})
    return _PLACEMENTS[key]


def _gathered(tree, prefix: str, cfg: ModelConfig, mesh):
    """``tree`` (a ``Params`` or a nested dict) as this rank computes with
    it: every FSDP shard gathered whole over "data" (``_GatherData``),
    every dimension the "model" axis splits at the rank's slice — a leaf
    handed in whole (serving from whole parameters) is cut to it, a
    view.  ``prefix`` names the tree's leaves as the placement does (a
    unit's as unit 0's: every unit has the same).  With a "model" axis
    the MoE blocks are left to ``moe_apply_sharded``, which gathers its
    own shards; a block handed in whole is cut to them
    (``shard_moe_params``, views)."""
    specs, shapes = placement(cfg, mesh)
    skip_moe = "model" in mesh.axis_names

    def walk(t, name):
        if isinstance(t, Params):
            t = t.tree(detach=False)
        if isinstance(t, dict):
            if skip_moe and name.endswith("moe."):
                whole = tuple(t["w_gate"].shape) == shapes[f"{name}w_gate"]
                return shard_moe_params(t, mesh, copy=False) if whole else t
            return {k: walk(v, f"{name}{k}.") for k, v in t.items()}
        whole = shapes[name[:-1]]
        for dim, entry in enumerate(specs[name[:-1]]):
            if entry == "data" and t.shape[dim] != whole[dim]:
                t = _GatherData.apply(t, mesh, dim)
            elif entry == "model" and t.shape[dim] == whole[dim]:
                lo, hi = model_slice(whole[dim], mesh)
                t = t.narrow(dim, lo, hi - lo)
        return t

    return walk(tree, prefix)


def _placed_mesh():
    """The global mesh when an axis of it splits parameters ("data" or
    "model" above 1), else None."""
    mesh = get_global_mesh()
    if mesh is None or (mesh.shape.get("data", 1) == 1
                        and model_ranks(mesh) == 1):
        return None
    return mesh


# the leaves (a name's last part, outside the MoE blocks) and the
# dimension of each whose placement decides a dense dimension's split
_TP_LEAVES = {"heads": (("wq", 1),), "kv": (("wk", 1),),
              "ffn": (("w_up", 1),), "vocab": (("embed", 0), ("lm_head", 1)),
              "d_inner": (("wx", 1),)}
_TP_SPLITS: dict = {}


def tp_splits(cfg: ModelConfig, mesh) -> frozenset:
    """The dense dimensions ("heads", "kv", "ffn", "vocab", "d_inner")
    that the placement (``placement``) splits over "model" under
    ``mesh``, read from their leaves' resolved specs, so the layers
    follow its divisibility fallback; cached per config and mesh shape."""
    specs, _ = placement(cfg, mesh)
    key = (cfg, mesh.axis_names, tuple(mesh.shape[a]
                                       for a in mesh.axis_names))
    if key not in _TP_SPLITS:
        split = set()
        for name, spec in specs.items():
            if ".moe." in name:
                continue
            for dim_name, leaves in _TP_LEAVES.items():
                if any(name.rsplit(".", 1)[-1] == leaf and spec[d] == "model"
                       for leaf, d in leaves):
                    split.add(dim_name)
        _TP_SPLITS[key] = frozenset(split)
    return _TP_SPLITS[key]


def _tp_mesh(cfg: ModelConfig, dim: str):
    """The global mesh when the placement splits the dense dimension
    ``dim`` over a "model" axis of several ranks (``tp_splits``), else
    None: the mesh a tensor-parallel region runs under."""
    mesh = get_global_mesh()
    if model_ranks(mesh) == 1:
        return None
    return mesh if dim in tp_splits(cfg, mesh) else None


def _ssm_tp(cfg: ModelConfig):
    """(the mesh an SSM block runs on the rank's heads under, the mesh
    that splits its d_inner leaves): the heads are local where the
    placement splits d_inner and the "model" axis divides the SSM heads
    (the scan's state is per head); else the block runs whole."""
    whole = _tp_mesh(cfg, "d_inner")
    if whole is None or cfg.n_ssm_heads % model_ranks(whole):
        return None, whole
    return whole, whole


def _whole_top(params, cfg: ModelConfig, mesh):
    """``params`` read with its top-level leaves (embedding, final norm,
    LM head) at the placement (``_gathered``); the units and the shared
    block untouched (read per unit)."""
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

def _kv_for_heads(k: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """The KV heads of ``k`` (..., Kv, D), every KV head, that this model
    rank's q heads read when "model" splits the q heads but not the KV
    heads: the one KV head they share where the axis is a multiple of
    Kv, else one KV head per q head."""
    m, r = model_ranks(mesh), mesh.coord("model")
    hl, rep = cfg.n_heads // m, cfg.n_heads // cfg.n_kv
    if m % cfg.n_kv == 0:
        return k.narrow(2, r * hl // rep, 1)
    idx = torch.arange(r * hl, (r + 1) * hl, device=k.device) // rep
    return k.index_select(2, idx)


def _project_qkv(p, h: torch.Tensor, cfg: ModelConfig, mesh=None):
    """q, k, v of the normalised input ``h``.  Under tensor parallelism
    (``mesh``: ``h`` already in the region) q holds the rank's heads, k
    and v its KV heads where "model" splits them, else every KV head:
    the whole leaves enter the region through ``_ToModel``, so their
    gradients sum the ranks' shares."""
    wk, wv = p["wk"], p["wv"]
    if mesh is not None and _tp_mesh(cfg, "kv") is None:
        wk, wv = to_model(mesh, wk, wv)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, wk)
    v = torch.einsum("bsd,dhk->bshk", h, wv)
    return q, k, v


def _attn_kv(k, v, cfg: ModelConfig, mesh):
    """The k and v (caches too) the rank's q heads attend to."""
    if mesh is None or _tp_mesh(cfg, "kv") is not None:
        return k, v
    return _kv_for_heads(k, cfg, mesh), _kv_for_heads(v, cfg, mesh)


def _mlp(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated MLP; under tensor parallelism of its ffn, the rank's
    slice's partial product summed over "model"."""
    mesh = _tp_mesh(cfg, "ffn")
    return from_model(mlp_apply(p, to_model(mesh, h), cfg.act), mesh)


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
    layer (the prefill layer shares it).  Under tensor parallelism the
    projection of the rank's heads is summed over "model" before the
    post-norm and the residual, as is the MLP's."""
    out = torch.einsum("bshk,hkd->bsd", attn, p["wo"])
    out = from_model(out, _tp_mesh(cfg, "heads"))
    if cfg.post_norms:
        out = rms_norm(out, p["post_ln1"], cfg.norm_eps)
    x = x + out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        m = _moe_dispatch(p["moe"], h2, cfg, moe_groups)
    else:
        m = _mlp(p["mlp"], h2, cfg)
    if cfg.post_norms:
        m = rms_norm(m, p["post_ln2"], cfg.norm_eps)
    return x + m


def _attn_layer(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor, moe_groups: int = 1,
                emit_cache: bool = False):
    """One attention layer; under tensor parallelism (``_tp_mesh``) on the
    rank's heads, the normalised input entering the region through
    ``_ToModel``.  The emitted (k, v) hold the KV heads the cache keeps
    (``init_cache``)."""
    window = cfg.window if kind == "local" else 0
    mesh = _tp_mesh(cfg, "heads")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, to_model(mesh, h), cfg, mesh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn_fn = (flash_attention if cfg.attn_impl == "flash"
               else blockwise_attention)
    ka, va = _attn_kv(k, v, cfg, mesh)
    attn = attn_fn(q, ka, va, causal=cfg.causal, window=window,
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
    Under tensor parallelism q holds the rank's heads and the cache the
    KV heads ``init_cache`` gives it.
    """
    k_cache, v_cache = cache
    W = k_cache.shape[1]
    rolling = kind == "local" and W <= cfg.window
    tp = _tp_mesh(cfg, "heads")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg, tp)
    pos = torch.full((1, 1), cache_len, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    mesh = _seq_mesh(cfg, kind)          # never a rolling (local) layer
    if mesh is not None:               # this rank's slice of the sequence
        if cache_len >= W * mesh.shape["model"]:
            raise ValueError(f"decode position {cache_len} past the cache's "
                             f"{W * mesh.shape['model']} slots")
        attn, _, _ = decode_attention_seq_sharded(
            q, k, v, k_cache, v_cache, cache_len, mesh, cap=cfg.softcap_attn,
            heads_split=tp is not None)
        return _attn_decode_tail(p, x, cfg, attn, moe_groups)
    slot = cache_len % W if rolling else cache_len
    if slot >= W:
        raise ValueError(f"decode position {cache_len} past the cache's "
                         f"{W} slots")
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    kc, vc = _attn_kv(k_cache, v_cache, cfg, tp)
    if rolling:
        attn = decode_attention(q, kc, vc, min(cache_len + 1, W),
                                cap=cfg.softcap_attn)
    else:
        attn = decode_attention(q, kc, vc, cache_len + 1,
                                cap=cfg.softcap_attn,
                                window=cfg.window if kind == "local" else 0)
    return _attn_decode_tail(p, x, cfg, attn, moe_groups)


def _ssm_block(p, cfg: ModelConfig):
    """(the SSM block's leaves, the tensor-parallel mesh or None).  Under
    a "model" axis that splits the SSM heads the block runs on the
    rank's heads (``ssm.py``); one that splits d_inner but not the heads
    gathers the block's d_inner leaves whole (``_GatherModel``: each
    rank keeps its slice's gradient) and every rank runs it whole."""
    mesh, whole = _ssm_tp(cfg)
    if mesh is not None or whole is None:
        return p, mesh
    return {**p, **{n: gather_model(p[n], whole, dim) for n, dim in
                    (("wz", 1), ("wx", 1), ("conv_x", 1), ("out_proj", 0))}
            }, None


def _ssm_layer(p, x: torch.Tensor, cfg: ModelConfig, *,
               cache_dtype: Optional[torch.dtype] = None):
    """One SSM layer; given a ``cache_dtype``, also its ``SSMCache``
    (conv windows in that dtype, the state in float32)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    sp, mesh = _ssm_block(p["ssm"], cfg)
    if cache_dtype is None:
        return x + ssm_apply(sp, h, ssm_cfg(cfg), norm_eps=cfg.norm_eps,
                             mesh=mesh), None
    out, state = ssm_apply(sp, h, ssm_cfg(cfg), norm_eps=cfg.norm_eps,
                           return_state=True, mesh=mesh)
    return x + out, ssm_prefill_cache(sp, h, state, ssm_cfg(cfg),
                                      dtype=cache_dtype, mesh=mesh)


def _ssm_layer_decode(p, x: torch.Tensor, cfg: ModelConfig, *,
                      cache: SSMCache):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    sp, mesh = _ssm_block(p["ssm"], cfg)
    out, new_cache = ssm_decode_step(sp, h, cache, ssm_cfg(cfg),
                                     norm_eps=cfg.norm_eps, mesh=mesh)
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
    """The input embeddings.  Under a "model" axis that splits the
    vocabulary each rank looks up the tokens of its rows of the table
    (zero elsewhere) and one sum over "model" completes them."""
    dtype = _compute_dtype_of(params)
    if cfg.inputs_embeds:
        return batch["embeds"].to(dtype)
    tokens = batch["tokens"].long()
    mesh = _tp_mesh(cfg, "vocab")
    if mesh is None:
        x = params["embed"][tokens].to(dtype)
    else:
        lo, hi = model_slice(cfg.vocab, mesh)
        local = tokens - lo
        own = (local >= 0) & (local < hi - lo)
        rows = params["embed"][local.clamp(0, hi - lo - 1)]
        x = from_model(torch.where(own[..., None], rows, 0).to(dtype), mesh)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits after the final norm and softcap; under a "model" axis
    that splits the vocabulary, the rank's slice of them (the normalised
    input entering the region through ``_ToModel``; the softcap is
    elementwise)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    x = to_model(_tp_mesh(cfg, "vocab"), x)
    if "lm_head" in params:
        logits = x @ params["lm_head"]
    else:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    return softcap(logits.to(torch.float32), cfg.softcap_final)


def _whole_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``_lm_logits``' output over the whole vocabulary, as the JAX
    package's global logits hold it."""
    return gather_model(logits, _tp_mesh(cfg, "vocab"), -1)


def _hidden(params, cfg: ModelConfig, batch: Dict, moe_groups: int,
            remat: bool):
    """(the parameters with the top-level leaves at the placement, the
    residual stream after the last unit)."""
    mesh = _placed_mesh()
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
    return params, x


def forward(params, cfg: ModelConfig, batch: Dict, *, moe_groups: int = 1,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> (B, S, vocab) f32 logits, differentiable
    in the parameters.  ``remat`` recomputes each unit's activations in
    the backward (``torch.utils.checkpoint`` per unit, the JAX package's
    ``jax.checkpoint`` around its scanned unit); under a mesh each unit
    gathers its FSDP shards inside that region (module doc)."""
    params, x = _hidden(params, cfg, batch, moe_groups, remat)
    return _whole_vocab(_lm_logits(params, cfg, x), cfg)


class _SumRanks(torch.autograd.Function):
    """All-reduce (sum) over (pod, data); the backward is the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(), ("pod", "data"))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                        cfg: ModelConfig, mesh) -> torch.Tensor:
    """logsumexp - gold logit per position from each rank's slice of the
    vocabulary's logits: a MAX over "model" of the detached row maxima,
    the sums of exponentials summed over "model", the gold logit from
    the rank that owns it — no rank holds a whole (B, S, V)."""
    lo, hi = model_slice(cfg.vocab, mesh)
    mx = mesh.all_reduce(logits.detach().amax(dim=-1), "model", op="max")
    sumexp = from_model(torch.exp(logits - mx[..., None]).sum(dim=-1), mesh)
    local = targets - lo
    own = (local >= 0) & (local < hi - lo)
    mine = torch.gather(logits, -1, local.clamp(0, hi - lo - 1)[..., None])
    gold = from_model(torch.where(own, mine[..., 0], 0.0), mesh)
    return torch.log(sumexp) + mx - gold


def loss_fn(params, cfg: ModelConfig, batch: Dict, *, moe_groups: int = 1,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token (or frame-label) cross entropy, a float32 scalar.

    LM batches: {"tokens" (B,S), "targets" (B,S)} — targets are the
    pipeline-shifted next tokens; positions with target < 0 are masked.
    Frontend-stub batches: {"embeds" (B,S,d), "targets" (B,S)}.  Under a
    mesh, ``batch`` is this rank's rows and the mean is the global
    batch's (module doc): every rank returns the same value.
    """
    params, x = _hidden(params, cfg, batch, moe_groups, remat)
    logits = _lm_logits(params, cfg, x)
    targets = batch["targets"]
    mask = (targets >= 0).to(torch.float32)
    t_safe = torch.clamp(targets, min=0).long()
    tp = _tp_mesh(cfg, "vocab")
    if tp is not None:
        nll = _vocab_parallel_nll(logits, t_safe, cfg, tp) * mask
    else:
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
    slots, every KV head; otherwise a "model" axis that splits the KV
    heads leaves the rank its Kv / m of them (``cache_specs``' "heads"
    rule), and one that splits the SSM heads its heads of the state and
    d_inner channels of the conv window (``ssm.ssm_cache_init``)."""
    dev = resolve_device(device)

    def kv(kind):
        # local layers: rolling window cache
        s_c = min(cfg.window, s_max) if kind == "local" else s_max
        n_kv = cfg.n_kv
        mesh = _seq_mesh(cfg, kind)
        if mesh is not None:
            lo, hi = _seq_slice(mesh, s_max)
            s_c = hi - lo
        elif _tp_mesh(cfg, "kv") is not None:
            n_kv //= model_ranks(get_global_mesh())
        shape = (batch, s_c, n_kv, cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def layer(pos):
        kind = _layer_kind(cfg, pos)
        if kind == "ssm":
            return ssm_cache_init(batch, ssm_cfg(cfg), dtype, device=dev,
                                  mesh=_ssm_tp(cfg)[0])
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
    f32, cache, cache_len); under a mesh each cache is this rank's slice
    (``init_cache``)."""
    mesh = _placed_mesh()
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
        if mesh is not None and kv[0].shape[2] != cfg.n_kv:
            # the rank's KV heads: a sequence slice keeps every head
            kv = mesh.all_gather(torch.stack(kv), "model", dim=3).unbind(0)
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
    logits = _whole_vocab(_lm_logits(params, cfg, x[:, -1:]), cfg)
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
    mesh = _placed_mesh()
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
    logits = _whole_vocab(_lm_logits(params, cfg, x), cfg)
    return logits[:, 0], cache
