"""Architecture configuration schema + registry.

The port's own copy of the JAX package's `configs/base.py` (pure data, no
framework). Each architecture gets a module `repro_torch/configs/<id>.py`
exporting `CONFIG: ArchConfig`; models are built from the config alone
(`repro_torch.models.lm`). `attn_impl`, `remat` and `unroll_groups` are kept
so that configs stay field for field equal to the reference's; the port
reads `attn_impl` ("naive" or "flash"; "standin", cost tooling, raises),
`remat` and `remat_policy` ("full" or "dots").

A transformer stack is described as `n_groups` repetitions of `group_spec`
(a tuple of LayerSpec) — uniform stacks have a single-entry spec; gemma2
alternates (local, global); jamba repeats an 8-layer mamba/attn/MoE block;
llama-3.2-vision inserts a cross-attention layer every 5th layer.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "deepseek_coder_33b", "granite_3_2b", "gemma2_27b", "mistral_large_123b",
    "arctic_480b", "olmoe_1b_7b", "whisper_small", "jamba_v01_52b",
    "llama32_vision_90b", "falcon_mamba_7b",
]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"            # "attn" | "mamba"
    local_window: int = 0         # sliding-window size; 0 = global attention
    cross: bool = False           # cross-attention (kv from aux embeddings)
    moe: bool = False             # MoE FFN instead of dense MLP
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE


@dataclasses.dataclass(frozen=True)
class PIMSpec:
    """The paper's technique, as deploy-time layer protection."""
    enabled: bool = False
    code_name: str = "wl320_r08"
    mode: str = "correct"              # off | detect | correct
    n_iters: int = 4
    damping: float = 0.3
    targets: tuple[str, ...] = ("mlp_down", "attn_o")
    row_parallelism: int = 64
    adc_levels: int = 0
    use_kernels: bool = False          # dispatch FBP to the Pallas kernel
    precoded: bool = False             # deploy-time: store ternary+NB-LDPC
                                       # encoded int8 weights as params
                                       # (no per-step ternarize/encode)
    correct_budget: int = 16           # mode="correct_budget": max words
                                       # FBP-decoded per protected matmul


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    d_ff: int
    group_spec: tuple[LayerSpec, ...]
    n_groups: int
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "sorted_ep"   # sorted_ep | shard_ep | dense (oracle)
    # --- attention ---
    rope_theta: float = 10000.0
    softcap_attn: float = 0.0
    softcap_final: float = 0.0
    act: str = "silu"
    # --- mamba ---
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    mamba_chunk: int = 16         # inner time-scan chunking (training)
    # --- enc-dec / aux-modal inputs ---
    encoder_groups: int = 0       # whisper: #encoder layers (own scan)
    aux_kind: str = ""            # "" | "audio" | "image"
    n_aux_tokens: int = 0         # image tokens; audio uses seq_len frames
    # --- misc ---
    tie_embeddings: bool = False
    embed_scale: bool = False     # gemma: scale embeddings by sqrt(d_model)
    norm_eps: float = 1e-5
    sub_quadratic: bool = False   # eligible for long_500k decode
    unroll_groups: bool = False   # Python-loop over groups (cost lowerings:
                                  # static HLO analysis counts while bodies
                                  # once, so true costs need unrolled graphs)
    attn_impl: str = "naive"      # naive | flash (Pallas kernel) | standin
                                  # (cost lowerings: attention internals are
                                  # accounted analytically per the kernel's
                                  # true HBM traffic; see launch/costs.py)
    pim: PIMSpec = PIMSpec()
    remat: bool = True
    remat_policy: str = "full"    # full (save nothing) | dots (save matmul
                                  # outputs: no recompute, more live bytes)

    @property
    def n_layers(self) -> int:
        return self.n_groups * len(self.group_spec) + self.encoder_groups

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, (self.d_model + 15) // 16)

    def reduced(self, *, n_groups: int = 1, encoder_groups: int | None = None,
                d_model: int = 64, n_heads: int = 4, n_kv_heads: int | None = None,
                d_ff: int = 128, vocab: int = 512, n_experts: int | None = None,
                **kw) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        nkv = n_kv_heads or min(self.n_kv_heads, n_heads)
        nkv = max(1, min(nkv, n_heads))
        ne = self.n_experts and (n_experts if n_experts is not None
                                 else min(self.n_experts, 8))
        return dataclasses.replace(
            self, n_groups=n_groups,
            encoder_groups=(encoder_groups if encoder_groups is not None
                            else min(self.encoder_groups, n_groups)),
            d_model=d_model, n_heads=n_heads, n_kv_heads=nkv,
            head_dim=d_model // n_heads, d_ff=d_ff, vocab_size=vocab,
            n_experts=ne or 0, expert_d_ff=min(self.expert_d_ff, d_ff) if ne else 0,
            top_k=min(self.top_k, ne) if ne else 0,
            n_aux_tokens=min(self.n_aux_tokens, 16) or self.n_aux_tokens,
            **kw)


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in [a for a in ARCH_IDS] + ["paper_pim"]:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"{__package__}.{arch_id}")
    return mod.CONFIG


# ---------------------------------------------------------------------------
# assigned input shapes (arch-independent), see brief
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
