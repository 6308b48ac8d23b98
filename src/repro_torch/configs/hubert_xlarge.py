"""hubert-xlarge [arXiv:2106.07447; unverified]: 48L encoder-only,
d_model 1280, 16 heads (kv=16, head_dim 80), d_ff 5120, vocab 504
(masked-prediction cluster targets).

Frontend stub (per assignment): the conv waveform feature extractor is
NOT implemented — ``input_specs`` supplies precomputed (B, S, d_model)
frame embeddings.  Encoder-only => bidirectional attention, no decode
shapes.  RoPE stands in for the conv positional embedding (DESIGN.md).
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    vocab=504,
    n_heads=16,
    n_kv=16,
    head_dim=80,
    d_ff=5120,
    causal=False,
    inputs_embeds=True,
    tie_embeddings=False,
    act="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab=64, n_heads=4, n_kv=4,
    head_dim=16, d_ff=128)
