"""gemma2-27b [dense; local+global alternating, logit softcaps] — arXiv:2408.00118.

head_dim=128 per the HF config (d_model/n_heads=144 is not the released
geometry). Local layers use a 4096-token sliding window; logits are
soft-capped (attn 50.0, final 30.0); embeddings scaled by sqrt(d_model).
"""
from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    group_spec=(LayerSpec(kind="attn", local_window=4096),
                LayerSpec(kind="attn")),
    n_groups=23,
    rope_theta=10000.0, act="gelu",
    softcap_attn=50.0, softcap_final=30.0,
    embed_scale=True, tie_embeddings=True,
    sub_quadratic=True,   # local layers O(S·W); long_500k runs w/ seq-sharded KV
)
