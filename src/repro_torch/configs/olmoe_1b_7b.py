"""olmoe-1b-7b [moe] — arXiv:2409.02060. 64 experts, top-8, MHA (kv=16)."""
from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    group_spec=(LayerSpec(kind="attn", moe=True),), n_groups=16,
    n_experts=64, top_k=8, expert_d_ff=1024, capacity_factor=1.25,
    rope_theta=10000.0, act="silu",
)
