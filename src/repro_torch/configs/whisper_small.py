"""whisper-small [audio enc-dec] — arXiv:2212.04356.

Conv frontend is a STUB per the brief: input_specs() provides precomputed
frame embeddings (B, 1500, d_model). Encoder: 12 bidirectional layers.
Decoder: 12 layers, each self-attn + cross-attn + MLP (kind="encdec").
RoPE replaces whisper's learned absolute positions (documented deviation).
"""
from .base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    group_spec=(LayerSpec(kind="encdec"),), n_groups=12,
    encoder_groups=12, aux_kind="audio", n_aux_tokens=1500,
    rope_theta=10000.0, act="gelu",
)
