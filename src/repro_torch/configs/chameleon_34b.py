"""chameleon-34b [arXiv:2405.09818; unverified]: 48L, d_model 8192,
64 heads (GQA kv=8, head_dim 128), d_ff 22016, vocab 65536 — early
fusion: text tokens and VQ image codes share one vocabulary, so the
backbone input is a plain int32 token stream.

Frontend stub (per assignment): the VQ-VAE image tokenizer is NOT
implemented — ``input_specs`` supplies token ids directly (interleaved
text + image codes).  Note the pleasing inverse connection to the paper:
VQ codes ARE integer sketches, so bST dedup applies to raw image-token
streams with no extra hashing (DESIGN.md §4).  The released model's
qk-norm is replaced by the framework's standard pre-norm block.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    vocab=65536,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=22016,
    rope_theta=10000.0,
    tie_embeddings=False,
    decode_kv_shard="seq",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab=256, n_heads=4, n_kv=2,
    head_dim=16, d_ff=128)
