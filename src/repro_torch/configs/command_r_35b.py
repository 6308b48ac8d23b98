"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified]: 40L,
d_model 8192, 64 heads (GQA kv=8, head_dim 128), d_ff 22528,
vocab 256000 — no biases, tied embeddings, rope theta 8e6.

(The real model uses parallel attention+MLP blocks and layernorm; we use
the framework's standard pre-norm sequential block — noted in DESIGN.md.)
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    vocab=256000,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=22528,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    decode_kv_shard="seq",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab=256, n_heads=4, n_kv=2,
    head_dim=16, d_ff=128)
