"""Encoding: systematic NB-LDPC encode of words and of weight matrices.

Memory mode  (paper §3.1): w' = w · H_G, i.e. checks r = w · P  (mod p).
PIM mode     (paper Eq. 4): every *row* of the stored weight matrix is a
codeword; the MAC output then satisfies Y' · H_Cᵀ ≡ 0 (mod p) by linearity.

`encode_words`, `syndrome` and `encode_weight_matrix` take their products
through `repro_torch.kernels.gf_matmul.gf_matmul_routed`: the CUDA kernel
on the card (its plain version on the CPU) for fields whose symbols fit
int8, the exact product for larger ones (GF(257) and up), so no symbol
wraps. Their outputs keep the input's dtype where it holds the field
(int8 stays int8: stored cells are int8 levels) and widen to
`symbol_dtype(p)` where it does not. `np_encode_words` is the host numpy
encode.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.gf_matmul import gf_matmul_routed
from .construction import LDPCCode
from .gf import centered_lift, symbol_dtype


def _out_dtype(t: torch.Tensor, p: int) -> torch.dtype:
    return torch.promote_types(t.dtype, symbol_dtype(p))


def encode_words(w: torch.Tensor, code: LDPCCode) -> torch.Tensor:
    """w: (B, k) field symbols -> (B, n) codewords [w | checks], in w's
    dtype where it holds GF(p) (int8 stays int8 for p <= 128)."""
    P = code.tensor("P", w.device, symbol_dtype(code.p))
    checks = gf_matmul_routed(w, P, code.p)
    dtype = _out_dtype(w, code.p)
    return torch.cat([w.to(dtype), checks.to(dtype)], dim=-1)


def syndrome(y_field: torch.Tensor, code: LDPCCode) -> torch.Tensor:
    """y_field: (B, n) field symbols -> (B, c) int32 syndromes (mod p)."""
    Ht = code.tensor("H.T", y_field.device, symbol_dtype(code.p))
    return gf_matmul_routed(y_field, Ht, code.p)


def encode_weight_matrix(W_int: torch.Tensor, code: LDPCCode) -> torch.Tensor:
    """Encode integer weights for PIM storage.

    W_int: (n_in, n_blocks * k) integers (e.g. differential ternary in
    {-1,0,1}).  Returns W_enc (n_in, n_blocks * n) in W_int's dtype, where
    each k-column block gains c check columns computed over GF(p), stored
    as *centered* integers so ternary hardware cells can hold them (for p=3
    checks land in {-1,0,1}); widened to `symbol_dtype(p)` where W_int's
    dtype cannot hold them.
    """
    n_in, n_out = W_int.shape
    if n_out % code.k:
        raise ValueError(f"out dim {n_out} not a multiple of k={code.k}")
    nb = n_out // code.k
    Wb = W_int.reshape(n_in * nb, code.k)
    checks = gf_matmul_routed(
        Wb, code.tensor("P", W_int.device, symbol_dtype(code.p)), code.p)
    # centered lift keeps check cells in the same dynamic range as data cells
    checks = centered_lift(checks, code.p)
    dtype = _out_dtype(W_int, code.p)
    W_enc = torch.cat([Wb.to(dtype), checks.to(dtype)], dim=-1)
    return W_enc.reshape(n_in, nb * code.n)


def np_encode_words(w: np.ndarray, code: LDPCCode) -> np.ndarray:
    """Host-side systematic encode. Symbols and P entries live in [0, p),
    so when every accumulated product is bounded by k*(p-1)^2 << 2^24 the
    matmul runs in float32 to hit BLAS — NumPy integer matmul is a slow C
    loop."""
    wmax = int(np.abs(w).max()) if w.size else 0
    if code.k * wmax * (code.p - 1) < 2 ** 24:
        prods = w.astype(np.float32) @ code.P.astype(np.float32)
        checks = prods.astype(np.int64) % code.p
    else:
        checks = (w.astype(np.int64) @ code.P) % code.p
    return np.concatenate([w.astype(np.int64), checks], axis=-1)
