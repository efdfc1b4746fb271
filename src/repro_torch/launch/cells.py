"""Per-architecture optimizer choice: the port's own copy of the rule in
`settings_for` of the JAX package's `launch/cells.py`.

The rest of that module (microbatch counts, FSDP and remat switches, input
ShapeDtypeStructs, `rules_for_cell`, the cell grid of the TPU dry runs) is
the TPU dry runs' cell tooling: the trainer takes its microbatch count
from its caller and remat from `cfg.remat`. The logical-axis rules and a
cell's sharding of the dense layers come with the tensor-parallel slice
(ROADMAP Queue 1).
"""
from __future__ import annotations

from ..configs.base import ArchConfig

# adafactor for the very large models (12B/param AdamW states do not fit),
# by config name so that reduced copies keep their model's optimizer
_ADAFACTOR = {"mistral-large-123b", "arctic-480b", "llama-3.2-vision-90b",
              "deepseek-coder-33b", "jamba-v0.1-52b"}


def optimizer_for(cfg: ArchConfig) -> str:
    """"adafactor" for the very large models, else "adamw"."""
    return "adafactor" if cfg.name in _ADAFACTOR else "adamw"
