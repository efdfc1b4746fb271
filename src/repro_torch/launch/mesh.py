"""Meshes over the visible cards: the port of the JAX package's
`repro.launch.mesh`.

Functions, never module-level constants: importing this module touches
no device. `make_production_mesh` (the JAX package's TPU v5e pod layouts,
16 x 16 and 2 x 16 x 16 chips) is a TPU pod layout and is not ported.
"""
from __future__ import annotations

import math

from ..distributed.sharding import Mesh, data_mesh

__all__ = ["compat_make_mesh", "make_host_mesh"]


def compat_make_mesh(shape, axes) -> Mesh:
    """A mesh of `shape` named `axes` over the first prod(shape) visible
    cards, in index order (as `jax.make_mesh` over `jax.devices()`)."""
    shape = tuple(int(s) for s in shape)
    cards = data_mesh().devices
    need = math.prod(shape)
    if need > cards.size:
        raise ValueError(f"mesh {shape} needs {need} devices, "
                         f"{cards.size} visible")
    return Mesh(cards[:need].reshape(shape), axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Tiny (data, model) mesh over however many cards exist (tests and
    examples): `data` and `model` are cut to what the cards hold."""
    n = data_mesh().size
    data = min(data, n)
    model = max(1, min(model, n // data))
    return compat_make_mesh((data, model), ("data", "model"))
