"""mamba2-1.3b [arXiv:2405.21060; unverified]: 48 attention-free SSD
blocks, d_model 2048 (d_inner 4096, 64 ssm-heads of dim 64),
ssm_state 128, vocab 50280."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    vocab=50280,
    d_ff=0,
    ssm=True,
    d_state=128,
    ssm_head_dim=64,
    expand=2,
    chunk=256,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab=256, d_state=16,
    ssm_head_dim=16, chunk=8)
