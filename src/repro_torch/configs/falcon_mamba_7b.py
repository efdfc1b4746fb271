"""falcon-mamba-7b [ssm, attn-free] — arXiv:2410.05355.

64 pure Mamba-1 blocks (no attention, no separate FFN: d_ff=0).
d_inner = expand * d_model = 8192, ssm_state = 16. n_heads is unused
(attention-free) but kept for config completeness.
"""
from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=65024,
    group_spec=(LayerSpec(kind="mamba"),), n_groups=64,
    d_state=16, d_conv=4, expand=2, mamba_chunk=64,
    act="silu", sub_quadratic=True,
)
