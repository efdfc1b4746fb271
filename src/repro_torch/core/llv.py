"""Logarithmic Likelihood Value (LLV) initialization and arithmetic
re-interpretation (paper §3.2.1 and §3.2.3).

LLV convention: larger = more likely (log domain). Vectors are length-p along
the last axis, one entry per field element k ∈ GF(p).

Every `mod p` here is `torch.remainder`, which floors like jnp's `%`:
received levels may drift below 0, and a truncating `fmod` would put them
in the wrong residue class.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9


def normalize_llv(x: torch.Tensor) -> torch.Tensor:
    """Shift an LLV vector so its max entry is 0 (log-domain normalization).

    Message-passing only ever compares LLV entries, so subtracting the
    per-vector max changes nothing semantically while keeping magnitudes
    bounded across decoder iterations (float32-safe for any n_iters).
    """
    return x - x.amax(dim=-1, keepdim=True)


def circular_distance(y: torch.Tensor, p: int) -> torch.Tensor:
    """d[..., k] = min_{z ≡ k (mod p)} |y - z| — the 1-D Manhattan distance of a
    received (integer or analog) value to the nearest representative of each
    residue class (paper Fig. 3(b))."""
    dtype = y.dtype if y.is_floating_point() else torch.int32
    ks = torch.arange(p, dtype=dtype, device=y.device)
    t = torch.remainder(ks - y[..., None], p)          # in [0, p)
    return torch.minimum(t, p - t)


def init_llv(y: torch.Tensor, p: int, *, scale: float = 4.0,
             mode: str = "manhattan") -> torch.Tensor:
    """Prior LLVs for received values `y` (any shape) -> (*y.shape, p).

    mode="manhattan": paper's simplified 1-D Manhattan-distance LLV.
    mode="gaussian":  full-precision likelihood under additive Gaussian noise
                      (the baseline the paper's simplification trades against).
    """
    d = circular_distance(y.to(torch.float32), p)
    if mode == "manhattan":
        return -scale * d
    elif mode == "gaussian":
        return -0.5 * scale * d * d
    raise ValueError(f"unknown LLV mode {mode!r}")


def reinterpret(y: torch.Tensor, decided: torch.Tensor, p: int) -> torch.Tensor:
    """Paper §3.2.3: move the received integer y to the *nearest* value whose
    residue mod p equals the decoded symbol.  delta ∈ (-p/2, p/2]."""
    delta = torch.remainder(decided.to(torch.int32) - y.to(torch.int32), p)
    delta = torch.where(delta > p // 2, delta - p, delta)
    return y + delta.to(y.dtype)
