"""gemma2-27b [arXiv:2408.00118; hf]: 46L, d_model 4608, 32 heads
(GQA kv=16, head_dim 128), d_ff 36864, vocab 256000 — local(4096)/global
alternating attention, attn logit softcap 50, final softcap 30, extra
post-sublayer norms, sqrt(d)-scaled embeddings."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    vocab=256000,
    n_heads=32,
    n_kv=16,
    head_dim=128,
    d_ff=36864,
    period=2,
    attn_kinds=("local", "global"),
    window=4096,
    softcap_attn=50.0,
    softcap_final=30.0,
    rope_theta=10000.0,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    act="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=4, d_model=64, vocab=256, n_heads=4, n_kv=2,
    head_dim=16, d_ff=128, window=8)
