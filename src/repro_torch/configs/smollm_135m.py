"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf]: 30L, d_model 576,
9 heads (GQA kv=3, head_dim 64), d_ff 1536, vocab 49152 — llama-style
small model.  This is also the ~100M end-to-end training example."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    vocab=49152,
    n_heads=9,
    n_kv=3,
    head_dim=64,
    d_ff=1536,
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=48, vocab=256, n_heads=3, n_kv=1,
    head_dim=16, d_ff=96)
