"""yi-9b [arXiv:2403.04652; hf]: 48L, d_model 4096, 32 heads (GQA kv=4,
head_dim 128), d_ff 11008, vocab 64000 — llama-arch GQA, untied."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    vocab=64000,
    n_heads=32,
    n_kv=4,
    head_dim=128,
    d_ff=11008,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    decode_kv_shard="seq",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab=256, n_heads=4, n_kv=1,
    head_dim=16, d_ff=128)
