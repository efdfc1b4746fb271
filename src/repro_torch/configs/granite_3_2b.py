"""granite-3-2b [dense, GQA] — hf:ibm-granite/granite-3.0-2b-base."""
from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155,
    group_spec=(LayerSpec(kind="attn"),), n_groups=40,
    rope_theta=10000.0, act="silu", tie_embeddings=True,
)
