"""Unified model configuration covering all assigned architecture families
(a copy of the JAX package's ``models/config.py``: pure data, no jax).

One ``ModelConfig`` describes a stack of ``num_layers`` blocks built from a
repeating *unit* of ``period`` consecutive layers (gemma2's local/global
alternation is period=2; most archs are period=1).  Mixer per position in
the unit: global attention, sliding-window attention, or — when ``ssm`` is
set — a Mamba2 SSD block (optionally interleaved with a *shared* attention
block every ``shared_attn_every`` layers, the Zamba2 scheme).  The MLP is
dense or MoE (shared + routed experts, top-k).

Mesh-divisibility padding: dimensions sharded over the 16-wide "model"
axis must divide it.  ``padded()`` records the published (logical) values
and pads heads / experts / vocab upward; the roofline report exposes the
resulting useful-FLOPs ratio so the padding cost is visible rather than
hidden.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    period: int = 1
    attn_kinds: Tuple[str, ...] = ("global",)   # per unit position
    attn_impl: str = "flash"     # "flash" (custom-vjp bwd) | "ref" (naive bwd)
    decode_kv_shard: str = "heads"  # "seq": seq-parallel decode cache (P9)
    window: int = 4096
    softcap_attn: float = 0.0
    softcap_final: float = 0.0
    causal: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25   # E/top_k => lossless (no token drops)
    # SSM (Mamba2 SSD)
    ssm: bool = False
    d_state: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256
    shared_attn_every: int = 0       # zamba2: shared attn block cadence
    # io / misc
    tie_embeddings: bool = True
    inputs_embeds: bool = False      # hubert-style: frontend supplies embeds
    norm_eps: float = 1e-6
    post_norms: bool = False         # gemma2: extra post-sublayer norms
    act: str = "silu"
    embed_scale: bool = False        # gemma2 scales embeddings by sqrt(d)
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # bookkeeping: published values that were padded for the mesh
    logical: Tuple[Tuple[str, int], ...] = ()

    # ------------------------------------------------------------------
    @property
    def n_units(self) -> int:
        assert self.num_layers % self.period == 0, (self.num_layers, self.period)
        return self.num_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def padded(self, model_axis: int = 16) -> "ModelConfig":
        """Pad mesh-sharded dims to divisibility; record originals."""
        changes: Dict[str, int] = {}
        upd: Dict[str, object] = {}
        if self.n_heads and self.n_heads % model_axis:
            changes["n_heads"] = self.n_heads
            upd["n_heads"] = _ceil_to(self.n_heads, model_axis)
        if (self.n_kv and self.n_kv % model_axis
                and self.decode_kv_shard != "seq"):
            # KV heads must divide the TP axis for head-sharded caches; the
            # padding waste (e.g. yi-9b kv 4 -> 16) is visible in the
            # useful-FLOPs ratio.  §Perf P9 removes the need: archs with
            # decode_kv_shard="seq" keep their true KV count and shard the
            # decode cache over the sequence axis instead.
            changes["n_kv"] = self.n_kv
            upd["n_kv"] = _ceil_to(self.n_kv, model_axis)
        if self.vocab % 128:
            changes["vocab"] = self.vocab
            upd["vocab"] = _ceil_to(self.vocab, 128)
        if self.n_experts and self.n_experts % model_axis:
            changes["n_experts"] = self.n_experts
            upd["n_experts"] = _ceil_to(self.n_experts, model_axis)
        if not changes:
            return self
        upd["logical"] = tuple(changes.items())
        return dataclasses.replace(self, **upd)

    # parameter counts (for 6·N·D roofline bookkeeping) ----------------
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.num_layers
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.ssm:
            di, ns = self.d_inner, self.d_state
            nh = self.n_ssm_heads
            # in_proj: d -> 2*di + 2*groups*ns + nh (z, x, B, C, dt)
            per_layer += d * (2 * di + 2 * ns + nh)
            per_layer += di * d                      # out_proj
            per_layer += self.d_conv * (di + 2 * ns)  # conv
            per_layer += 3 * nh                      # A_log, D, dt_bias
            per_layer += d                           # norm
            if self.shared_attn_every:
                # shared attn block params counted once below
                pass
        else:
            hd = self.head_dim
            per_layer += d * (self.n_heads + 2 * self.n_kv) * hd  # qkv
            per_layer += self.n_heads * hd * d                    # o
            per_layer += 2 * d                                    # norms
            if self.post_norms:
                per_layer += 2 * d
        if self.n_experts:
            e_ff = self.moe_d_ff
            routed = self.n_experts * 3 * d * e_ff
            shared = self.n_shared * 3 * d * e_ff
            router = d * self.n_experts
            if active_only:
                routed = self.top_k * 3 * d * e_ff
            per_layer += routed + shared + router
        elif self.d_ff and not self.ssm:
            per_layer += 3 * d * self.d_ff
        total += per_layer * L
        if self.ssm and self.shared_attn_every:
            hd = self.head_dim or (d // max(self.n_heads, 1))
            total += d * (self.n_heads + 2 * self.n_kv) * hd + self.n_heads * hd * d
            total += 3 * d * (self.d_ff or 4 * d)
        total += d  # final norm
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the assigned input-shape grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
