"""deepseek-moe-16b [arXiv:2401.06066; hf]: 28L, d_model 2048, 16 heads
(kv=16 — MHA, head_dim 128), vocab 102400, fine-grained MoE: 2 shared +
64 routed experts, top-6, expert d_ff 1408.

Simplification (DESIGN.md): the released model's layer 0 is a dense MLP
(d_ff 10944); we use a uniform MoE stack so the layer scan stays
homogeneous — parameter count differs by <1%.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    vocab=102400,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=0,
    n_experts=64,
    top_k=6,
    n_shared=2,
    moe_d_ff=1408,
    rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab=256, n_heads=4, n_kv=4,
    head_dim=16, n_experts=8, top_k=2, n_shared=1, moe_d_ff=32,
    capacity_factor=4.0)
