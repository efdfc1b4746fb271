"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base.

Dense-MoE hybrid: every layer has a 128-expert top-2 MoE FFN *in parallel
with* a dense residual MLP (d_ff=4864 both).
"""
from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    group_spec=(LayerSpec(kind="attn", moe=True, dense_residual=True),),
    n_groups=35,
    n_experts=128, top_k=2, expert_d_ff=4864, capacity_factor=1.25,
    rope_theta=10000.0, act="silu",
)
