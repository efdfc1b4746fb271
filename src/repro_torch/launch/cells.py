"""Per-cell launch settings and sharding rules: the port's own copy of
`settings_for`, `CellSettings` and the training cells' `rules_for_cell`
of the JAX package's `launch/cells.py`, and `optimizer_for`, the same
optimizer choice keyed by a config's name.

`rules_for_cell` is what the data-parallel trainer places its parameters
and optimizer states by (`launch.train.main`, `launch.steps.build_train`
with a mesh): `fsdp` over `data`, and the vocabulary, the heads and the
KV projections over `model` only where they divide it (the
tensor-parallel step's split). Its serving cells (the decode shapes'
KV-sequence rules, FSDP while serving the largest models) have no reader
in the port yet and come with a tensor-parallel prefill and decode
(ROADMAP Queue 1, tensor-parallel serving); the rest of the JAX module
(`input_specs`, `list_cells`, `skip_reason`) is the TPU dry runs' cell
tooling and is not ported.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.sharding import RULES_SINGLE_POD

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
    remat: bool = True
    notes: str = ""


def settings_for(arch_id: str, shape: ShapeSpec) -> CellSettings:
    """The JAX package's settings of an architecture id (`configs.ARCH_IDS`)
    under `shape`."""
    mb = 8 if shape.kind == "train" else 1
    return CellSettings(
        microbatches=mb,
        optimizer="adafactor" if arch_id in _ADAFACTOR else "adamw",
        fsdp_train=True)


def optimizer_for(cfg: ArchConfig) -> str:
    """"adafactor" for the very large models, else "adamw" (the optimizer
    `settings_for` gives the config's architecture)."""
    return "adafactor" if cfg.name in _ADAFACTOR_NAMES else "adamw"


def rules_for_cell(mesh, cfg: ArchConfig, shape: ShapeSpec,
                   st: CellSettings) -> dict:
    """The logical-axis rules of one (config, training shape) cell on
    `mesh`; a serving shape raises (ROADMAP Queue 1, tensor-parallel
    serving)."""
    if shape.kind != "train":
        raise ValueError(
            f"rules_for_cell: {shape.name!r} is a {shape.kind} cell; the "
            "serving cells' rules come with a tensor-parallel prefill and "
            "decode (ROADMAP Queue 1, tensor-parallel serving)")
    rules = dict(RULES_SINGLE_POD)
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
    rules["fsdp"] = "data" if st.fsdp_train else None
    return rules
