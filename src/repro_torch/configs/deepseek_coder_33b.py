"""deepseek-coder-33b [dense, llama-arch] — arXiv:2401.14196."""
from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256,
    group_spec=(LayerSpec(kind="attn"),), n_groups=62,
    rope_theta=100000.0, act="silu",
)
