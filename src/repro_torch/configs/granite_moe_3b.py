"""granite-moe-3b-a800m [hf:ibm-granite; hf]: 32L, d_model 1536,
24 heads (GQA kv=8, head_dim 64), vocab 49155, fine-grained MoE:
40 experts, top-8, expert d_ff 512 (per assignment)."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    vocab=49155,
    n_heads=24,
    n_kv=8,
    head_dim=64,
    d_ff=0,
    n_experts=40,
    top_k=8,
    n_shared=0,
    moe_d_ff=512,
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab=256, n_heads=4, n_kv=2,
    head_dim=16, n_experts=8, top_k=2, moe_d_ff=32, capacity_factor=4.0)
