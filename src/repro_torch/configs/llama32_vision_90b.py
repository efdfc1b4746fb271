"""llama-3.2-vision-90b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision family.

100 layers: a cross-attention (image) layer after every 4 self-attention
layers (20 cross + 80 self). The vision tower is a STUB per the brief:
input_specs() provides precomputed patch embeddings (B, 1601, d_model).
"""
from .base import ArchConfig, LayerSpec

_spec = (LayerSpec(kind="attn"),) * 4 + (LayerSpec(kind="attn", cross=True),)

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    group_spec=_spec, n_groups=20,
    aux_kind="image", n_aux_tokens=1601,
    rope_theta=500000.0, act="silu",
)
