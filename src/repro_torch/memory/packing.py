"""Byte/tensor <-> GF(p) symbol packing.

Bytes are symbolized as base-p digits — ceil(log_p 256) digits per byte,
little-endian — and the digit stream is chunked into (k,)-symbol info
words, exactly as the JAX package's `repro.memory.packing` does, so words
packed by either package decode in the other. Both functions work on the
tensor's own device (the card for `ProtectedMemoryArray`).
`symbolize_bytes` / `desymbolize_bytes` are the same packing on the host,
from and to `bytes`, with numpy digits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.gf import symbol_dtype

__all__ = ["digits_per_byte", "symbolize_bytes", "desymbolize_bytes",
           "symbolize_u8", "desymbolize_u8"]


def digits_per_byte(p: int) -> int:
    """Base-p digits needed to hold one byte: ceil(log_p 256)."""
    return math.ceil(8.0 / math.log2(p))


def symbolize_bytes(raw: bytes | np.ndarray, p: int) -> np.ndarray:
    """bytes -> flat int64 array of base-p digits (little-endian per
    byte)."""
    b = np.frombuffer(raw, np.uint8).astype(np.int64) \
        if not isinstance(raw, np.ndarray) else raw.astype(np.int64)
    D = digits_per_byte(p)
    return np.stack([(b // p ** i) % p for i in range(D)], -1).reshape(-1)


def desymbolize_bytes(syms: np.ndarray, nbytes: int, p: int) -> bytes:
    """Inverse of `symbolize_bytes`. Digits are clipped into the field and
    the value into a byte, so corrupted-but-uncorrected symbols degrade to
    wrong bytes instead of crashing."""
    D = digits_per_byte(p)
    d = np.clip(syms[:nbytes * D].reshape(-1, D).astype(np.int64), 0, p - 1)
    vals = sum(d[:, i] * p ** i for i in range(D)) % 256
    return vals.astype(np.uint8).tobytes()


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
