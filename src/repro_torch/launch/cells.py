"""Per-cell launch settings and sharding rules: the port's own copy of
`settings_for`, `CellSettings` and the training cells' `rules_for_cell`
of the JAX package's `launch/cells.py`, and `optimizer_for`, the same
optimizer choice keyed by a config's name.

`rules_for_cell` is what the data-parallel trainer places its parameters
and optimizer states by (`launch.train.main`, `launch.steps.build_train`
with a mesh): `fsdp` over `data`, and the vocabulary, the heads and the
KV projections over `model` only where they divide it (the
tensor-parallel step's split). Its serving cells place the parameters
and caches of `launch.steps.build_prefill` and `build_serve`: FSDP while
serving only the largest models (`fsdp_serve`, `_BIG`), and the decode
shapes' KV-sequence rules (the sequence over `model` where the KV heads
do not divide it; `long_500k` splits it over `data`, and `pod`, as
well, with the batch whole: context parallelism). On a mesh with a
`pod` axis the table starts from `RULES_MULTI_POD` (the batch over
`("pod", "data")`). The rest of the JAX module (`input_specs`,
`list_cells`, `skip_reason`) is the TPU dry runs' cell tooling and is
not ported.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.sharding import RULES_MULTI_POD, RULES_SINGLE_POD

# archs too large for replicated-over-data storage: shard params over `data`
# (FSDP) in addition to tensor parallelism over `model`
_BIG = {"mistral_large_123b", "arctic_480b", "llama32_vision_90b"}
# the same models by config name, so that reduced copies keep their
# model's serving placement
_BIG_NAMES = {"mistral-large-123b", "arctic-480b", "llama-3.2-vision-90b"}
# adafactor for the very large models (12B/param AdamW states do not fit)
_ADAFACTOR = {"mistral_large_123b", "arctic_480b", "llama32_vision_90b",
              "deepseek_coder_33b", "jamba_v01_52b"}
# the same models by config name, so that reduced copies keep their
# model's optimizer
_ADAFACTOR_NAMES = {"mistral-large-123b", "arctic-480b",
                    "llama-3.2-vision-90b", "deepseek-coder-33b",
                    "jamba-v0.1-52b"}


@dataclasses.dataclass(frozen=True)
class CellSettings:
    microbatches: int = 8          # grad-accumulation chunks per train step
    optimizer: str = "adamw"
    fsdp_train: bool = True        # shard params over `data` during training
    fsdp_serve: bool = False       # ... and during serving (huge models only)
    remat: bool = True
    notes: str = ""


def settings_for(arch_id: str, shape: ShapeSpec) -> CellSettings:
    """The JAX package's settings of an architecture id (`configs.ARCH_IDS`)
    under `shape`."""
    mb = 8 if shape.kind == "train" else 1
    return CellSettings(
        microbatches=mb,
        optimizer="adafactor" if arch_id in _ADAFACTOR else "adamw",
        fsdp_train=True, fsdp_serve=arch_id in _BIG)


def optimizer_for(cfg: ArchConfig) -> str:
    """"adafactor" for the very large models, else "adamw" (the optimizer
    `settings_for` gives the config's architecture)."""
    return "adafactor" if cfg.name in _ADAFACTOR_NAMES else "adamw"


def fsdp_serve_for(cfg: ArchConfig) -> bool:
    """Whether serving splits the parameters over `data` too (the
    `fsdp_serve` `settings_for` gives the config's architecture)."""
    return cfg.name in _BIG_NAMES


def rules_for_cell(mesh, cfg: ArchConfig, shape: ShapeSpec,
                   st: CellSettings) -> dict:
    """The logical-axis rules of one (config, shape) cell on `mesh`, the
    JAX package's: the multi-pod table where `mesh` has a `pod` axis."""
    multi = "pod" in mesh.axis_names
    rules = dict(RULES_MULTI_POD if multi else RULES_SINGLE_POD)
    msize = mesh.shape["model"]

    rules["heads_flat"] = "model"
    # uneven vocabs (granite 49155, whisper 51865) cannot shard as jit args;
    # replicate them
    rules["vocab"] = "model" if cfg.vocab_size % msize == 0 else None
    # kv projections/heads: shard only when the head count divides the axis
    kv_div = cfg.n_kv_heads % msize == 0
    rules["kv_flat"] = "model" if kv_div else None
    rules["kv_heads"] = "model" if kv_div else None
    rules["heads"] = "model" if cfg.n_heads % msize == 0 else None
    rules["fsdp"] = "data" if (st.fsdp_train if shape.kind == "train"
                               else st.fsdp_serve) else None

    if shape.kind == "decode":
        if shape.name == "long_500k":
            rules["batch"] = None          # batch=1
            # context parallelism: the KV sequence over every idle axis
            rules["kv_seq"] = ("pod", "data") if multi else ("data",)
            if not kv_div:
                rules["kv_seq"] = rules["kv_seq"] + ("model",)
                rules["kv_heads"] = None
        elif not kv_div:
            # 32k-deep caches: the KV sequence over `model` when the KV
            # heads do not divide it (sequence-parallel attention)
            rules["kv_seq"] = "model"
    return rules
