"""paper_pim — the paper's own deployment scenario as an architecture config.

A ~2B dense LM served on (simulated) PIM hardware with NB-LDPC protection
enabled on the attn-output and MLP-down projections — the configuration whose
roofline/hillclimb represents the paper's technique itself (serve mode;
protection is a deploy-time feature per DESIGN.md §4).
"""
from .base import ArchConfig, LayerSpec, PIMSpec

CONFIG = ArchConfig(
    name="paper-pim-2b", family="dense",
    d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155,
    group_spec=(LayerSpec(kind="attn"),), n_groups=24,
    rope_theta=10000.0, act="silu", tie_embeddings=True,
    pim=PIMSpec(enabled=True, code_name="wl320_r08", mode="correct",
                n_iters=4, damping=0.3,
                targets=("mlp_down", "attn_o"),
                row_parallelism=64, adc_levels=0, use_kernels=False),
)
