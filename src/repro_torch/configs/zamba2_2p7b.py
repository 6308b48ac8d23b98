"""zamba2-2.7b [arXiv:2411.15242; hf]: 54 Mamba2 blocks, d_model 2560,
ssm_state 64, plus a SHARED attention block (32 heads, kv=32, head_dim
80, d_ff 10240) invoked every 6 mamba layers — same parameters each
invocation (9 invocations total).

Simplification (DESIGN.md): the released model concatenates the shared
block's input with the original embedding and applies per-invocation
LoRA deltas; we use a standard residual shared block — the
memory/communication shape (shared params, 9 KV caches) is preserved.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    vocab=32000,
    n_heads=32,
    n_kv=32,
    head_dim=80,
    d_ff=10240,
    ssm=True,
    d_state=64,
    ssm_head_dim=64,
    expand=2,
    chunk=256,
    period=6,
    shared_attn_every=6,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=4, d_model=64, vocab=256, n_heads=4, n_kv=4,
    head_dim=16, d_ff=128, d_state=16, ssm_head_dim=16, chunk=8,
    period=2, shared_attn_every=2)
