"""Byte/tensor <-> GF(p) symbol packing.

Bytes are symbolized as base-p digits — ceil(log_p 256) digits per byte,
little-endian — and the digit stream is chunked into (k,)-symbol info
words, exactly as the JAX package's `repro.memory.packing` does, so words
packed by either package decode in the other. Both functions work on the
tensor's own device (the card for `ProtectedMemoryArray`).
"""
from __future__ import annotations

import math

import torch

from ..core.gf import symbol_dtype

__all__ = ["digits_per_byte", "symbolize_u8", "desymbolize_u8"]


def digits_per_byte(p: int) -> int:
    """Base-p digits needed to hold one byte: ceil(log_p 256)."""
    return math.ceil(8.0 / math.log2(p))


def symbolize_u8(vals: torch.Tensor, p: int) -> torch.Tensor:
    """Byte values in [0, 256) of any shape -> (..., D) base-p digits,
    little-endian per byte, in `symbol_dtype(p)` (int8 while p <= 128)."""
    D = digits_per_byte(p)
    v = vals.to(torch.int32)
    return torch.stack([torch.div(v, p ** i, rounding_mode="floor") % p
                        for i in range(D)], dim=-1).to(symbol_dtype(p))


def desymbolize_u8(digits: torch.Tensor, p: int) -> torch.Tensor:
    """(..., D) base-p digits -> (...,) uint8 byte values. Digits are
    clipped into the field first, so uncorrected symbols degrade to wrong
    bytes instead of crashing."""
    D = digits_per_byte(p)
    d = digits.to(torch.int32).clamp(0, p - 1)
    val = d[..., 0]
    for i in range(1, D):
        val = val + d[..., i] * p ** i
    return (val % 256).to(torch.uint8)
