"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.

Jamba block = 8 layers: attention at in-block index 4, Mamba elsewhere
(1:7 attn:mamba); MoE (16 experts, top-2) on every odd layer, dense MLP
(d_ff=14336) on even layers. 4 blocks = 32 layers.
"""
from .base import ArchConfig, LayerSpec

_spec = tuple(
    LayerSpec(kind=("attn" if i == 4 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    group_spec=_spec, n_groups=4,
    n_experts=16, top_k=2, expert_d_ff=14336, capacity_factor=1.25,
    d_state=16, d_conv=4, expand=2, mamba_chunk=64,
    rope_theta=10000.0, act="silu",
    sub_quadratic=True,
)
