"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407."""
from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768,
    group_spec=(LayerSpec(kind="attn"),), n_groups=88,
    rope_theta=1000000.0, act="silu",
)
