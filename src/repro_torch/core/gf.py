"""GF(p) arithmetic and linear algebra over prime fields.

The paper's NB-LDPC code lives in GF(p) with p prime (prototype: GF(3)).
Construction-time linear algebra (systematic generator derivation, rank checks)
runs in numpy; `centered_lift` also takes torch tensors. Runtime arithmetic
on the card goes through `repro_torch.kernels`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "is_prime", "gf_inv", "mul_table", "inv_table",
    "gf_matmul_np", "gf_rref", "gf_mat_inv", "gf_rank", "centered_lift",
    "symbol_dtype",
]


def is_prime(p: int) -> bool:
    if p < 2:
        return False
    return all(p % d for d in range(2, int(p ** 0.5) + 1))


@functools.lru_cache(maxsize=None)
def _inv_list(p: int) -> tuple:
    """Multiplicative inverses; index 0 unused (set to 0)."""
    assert is_prime(p), f"GF(p) requires prime p, got {p}"
    return tuple([0] + [pow(a, p - 2, p) for a in range(1, p)])


def gf_inv(a: int, p: int) -> int:
    a = int(a) % p
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(p)")
    return _inv_list(p)[a]


@functools.lru_cache(maxsize=None)
def mul_table(p: int) -> np.ndarray:
    """(p, p) multiplication table."""
    k = np.arange(p)
    return (k[:, None] * k[None, :]) % p


@functools.lru_cache(maxsize=None)
def inv_table(p: int) -> np.ndarray:
    return np.asarray(_inv_list(p), dtype=np.int32)


# ---------------------------------------------------------------------------
# numpy linear algebra mod p (construction time)
# ---------------------------------------------------------------------------

def gf_matmul_np(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64)) % p


def gf_rref(mat: np.ndarray, p: int):
    """Reduced row-echelon form of `mat` over GF(p).

    Returns (rref, pivot_cols). Row operations only; column order preserved.
    """
    m = mat.astype(np.int64) % p
    rows, cols = m.shape
    pivots = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        nz = np.nonzero(m[r:, c])[0]
        if nz.size == 0:
            continue
        pr = r + nz[0]
        if pr != r:
            m[[r, pr]] = m[[pr, r]]
        m[r] = (m[r] * gf_inv(int(m[r, c]), p)) % p
        for rr in range(rows):
            if rr != r and m[rr, c] != 0:
                m[rr] = (m[rr] - m[rr, c] * m[r]) % p
        pivots.append(c)
        r += 1
    return m % p, pivots


def gf_rank(mat: np.ndarray, p: int) -> int:
    _, piv = gf_rref(mat, p)
    return len(piv)


def gf_mat_inv(mat: np.ndarray, p: int) -> np.ndarray:
    """Inverse of a square matrix over GF(p)."""
    n = mat.shape[0]
    aug = np.concatenate([mat % p, np.eye(n, dtype=np.int64)], axis=1)
    rref, piv = gf_rref(aug, p)
    if piv[:n] != list(range(n)):
        raise np.linalg.LinAlgError("matrix is singular over GF(p)")
    return rref[:, n:] % p


# ---------------------------------------------------------------------------
# integer <-> field helpers (the "arithmetic" part of the arithmetic code)
# ---------------------------------------------------------------------------

def symbol_dtype(p: int) -> torch.dtype:
    """The narrowest signed integer dtype that holds every symbol of GF(p),
    [0, p): int8, the cell level the int8 kernels take, while p <= 128;
    int16 or int32 for larger fields, which never pass through int8."""
    if p <= 2 ** 7:
        return torch.int8
    return torch.int16 if p <= 2 ** 15 else torch.int32


def centered_lift(k, p: int):
    """Lift field element k in [0, p) to the centered representative in
    (-p/2, p/2].  For p=3: {0:0, 1:1, 2:-1} — the differential ternary map."""
    if isinstance(k, torch.Tensor):
        k = torch.remainder(k, p)
        return torch.where(k > p // 2, k - p, k)
    k = k % p
    return np.where(k > p // 2, k - p, k)
