"""GF(p) matrix product and fused syndrome scan: CUDA kernels and their
plain versions.

Replaces the TPU kernels of `src/repro/kernels/gf_matmul.py`:
`gf_matmul_pallas` ((a @ b) mod p, the encode) and `scan_syndromes_pallas`
(any((y @ Ht) mod p != 0) per row, the detect step of every read, scrub
and PIM output). Both CUDA kernels (`csrc/gf_matmul.cu`) share one int8
dp4a tile skeleton with an int32 accumulator; the scan folds mod p and the
any-reduce into the tile epilogue, so it writes only the (M,) flags.

Bound on the card: bytes at the int8 tensor cores' rate; these dp4a
kernels run on the CUDA cores and are limited by their multiply-adds
instead, see the note in `csrc/gf_matmul.cu`.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. The plain versions are the reference the
kernels are held against, on the card by `chip_smoke.py` and against the
JAX package by the CPU tests.

The kernels hold a GF(p) product exactly only while its symbols fit int8
(p <= 128) and the int32 accumulator holds K (p - 1)^2. `field_route`
says, from the field and K alone, whether a product goes to the kernel or
to the exact product (`build.exact_matmul`: int64 on the CPU, float64 on
the card, then a floored mod p), as the JAX controller's `_scan_route`
sends such codes to its exact host scan; `gf_matmul_routed` and
`scan_syndromes_routed` are the callers' entry points. The route never
depends on a kernel failing.
"""
from __future__ import annotations

import torch

from . import build

# int8 operands: |a|, |b| <= 128, so the int32 accumulator is exact while
# K * 128 * 128 < 2^31
INT8_K_MAX = (2 ** 31 - 1) // (128 * 128)


def _reduce(x: torch.Tensor, p: int) -> torch.Tensor:
    """x mod p (floored), in a dtype that holds p - 1."""
    if torch.iinfo(x.dtype).max < p - 1:
        x = x.to(torch.int64)
    return torch.remainder(x, p)


def gf_matmul_plain(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(a @ b) mod p as int32. a: (M, K), b: (K, N), any integer dtype;
    exact for any field (the product runs through `build.exact_matmul`)."""
    a = _reduce(a, p)
    b = _reduce(b, p)
    prods = build.exact_matmul(a, b, a.shape[-1] * (p - 1) ** 2)
    return torch.remainder(prods, p).to(torch.int32)


def scan_syndromes_plain(y: torch.Tensor, ht: torch.Tensor,
                         p: int) -> torch.Tensor:
    """flags[i] = any((y[i] @ ht) mod p != 0) -> (M,) bool."""
    return (gf_matmul_plain(y, ht, p) != 0).any(dim=1)


def _check_shapes(name: str, a: torch.Tensor, b: torch.Tensor, p: int):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not chain")
    K = a.shape[1]
    # the reference's int32 guard (kernels/ops.py) for operands in [0, p),
    # and the int8 one for operands anywhere in int8
    if K * (p - 1) ** 2 >= 2 ** 31 or K > INT8_K_MAX:
        raise ValueError(f"{name}: int32 accumulator bound exceeded, K={K}")


def field_route(K: int, p: int) -> str:
    """"kernel" when the int8 kernels compute a GF(p) product over K terms
    exactly (p <= 128, K (p - 1)^2 < 2^31, K <= INT8_K_MAX), else "exact"."""
    fits = (p <= build.INT8_FIELD_MAX and K * (p - 1) ** 2 < 2 ** 31
            and K <= INT8_K_MAX)
    return "kernel" if fits else "exact"


def gf_matmul_routed(a: torch.Tensor, b: torch.Tensor,
                     p: int) -> torch.Tensor:
    """(a @ b) mod p -> (M, N) int32 through `field_route`'s choice: the
    kernel (its plain version on the CPU), or the exact product."""
    if field_route(a.shape[-1], p) == "kernel":
        return gf_matmul(a, b, p)
    return gf_matmul_plain(a, b, p)


def scan_syndromes_routed(y: torch.Tensor, ht: torch.Tensor,
                          p: int) -> torch.Tensor:
    """(M,) nonzero-syndrome flags through `field_route`'s choice."""
    if field_route(y.shape[-1], p) == "kernel":
        return scan_syndromes(y, ht, p)
    return scan_syndromes_plain(y, ht, p)


def gf_matmul(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(a @ b) mod p -> (M, N) int32 in [0, p). Operands that are not int8
    are reduced mod p into int8 first (the result is the same). On the card
    a field past int8 or a K past the int32 bound raises (see
    `field_route`)."""
    if build.route("gf_matmul", a, b) == "cpu":
        return gf_matmul_plain(a, b, p)
    _check_shapes("gf_matmul", a, b, p)
    a8, b8 = build.int8_operand(a, p), build.int8_operand(b, p)
    M, K = a8.shape
    N = b8.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    err = build.library().rt_gf_matmul(
        a8.data_ptr(), b8.data_ptr(), out.data_ptr(), M, N, K, p,
        build.stream_handle(a.device))
    build.check(err, "gf_matmul")
    build.LAUNCHES["gf_matmul"] += 1
    return out


def scan_syndromes(y: torch.Tensor, ht: torch.Tensor, p: int) -> torch.Tensor:
    """Fused syndrome scan: (M, n) words x (n, c) Hᵀ -> (M,) bool flags,
    flags[i] = any((y[i] @ ht) mod p != 0)."""
    if build.route("scan_syndromes", y, ht) == "cpu":
        return scan_syndromes_plain(y, ht, p)
    _check_shapes("scan_syndromes", y, ht, p)
    y8, h8 = build.int8_operand(y, p), build.int8_operand(ht, p)
    M, K = y8.shape
    C = h8.shape[1]
    flags = torch.empty(M, dtype=torch.bool, device=y.device)
    err = build.library().rt_scan_syndromes(
        y8.data_ptr(), h8.data_ptr(), flags.data_ptr(), M, C, K, p,
        build.stream_handle(y.device))
    build.check(err, "scan_syndromes")
    build.LAUNCHES["scan_syndromes"] += 1
    return flags
