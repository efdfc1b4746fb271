"""Error-feedback int8 gradient compression: the port of the wire format
of the JAX package's `repro.distributed.compression`.

A tensor is sent as int8 and one float32 scale (absmax / 127); error
feedback adds the residual of each round back before the next
quantization, so the time average of the dequantized values converges to
the true ones. `compressed_psum`, the JAX package's all-reduce of
compressed gradients over a mesh axis, comes with data-parallel training
over a mesh (ROADMAP Queue 1); the port's meshes
(`distributed.sharding`) carry no training collective yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["EFState", "init_ef", "quantize_ef", "dequantize"]


class EFState(NamedTuple):
    residual: torch.Tensor       # the tensor's shape, float32


def init_ef(tree):
    """{name: tensor} (or one tensor) -> the matching zero EFStates."""
    if isinstance(tree, dict):
        return {k: init_ef(v) for k, v in tree.items()}
    return EFState(torch.zeros_like(tree, dtype=torch.float32))


def quantize_ef(x: torch.Tensor, ef: EFState):
    """float -> (int8 payload, float32 scale (0-d), new EFState): the
    value not represented this round is carried to the next."""
    xf = x.to(torch.float32) + ef.residual
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale, EFState(xf - q.to(torch.float32) * scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
