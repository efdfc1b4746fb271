"""Architecture configs (own copies of the JAX package's, field for field)."""
from .base import (ArchConfig, LayerSpec, PIMSpec, ShapeSpec, SHAPES,
                   ARCH_IDS, get_config)
