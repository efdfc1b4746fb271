"""GF(p) matrix product and fused syndrome scan: CUDA kernels and their
plain versions.

Replaces the TPU kernels of `src/repro/kernels/gf_matmul.py`:
`gf_matmul_pallas` ((a @ b) mod p, the encode) and `scan_syndromes_pallas`
(any((y @ Ht) mod p != 0) per row, the detect step of every read, scrub,
PIM output and decoder iteration). Both run on the int8 tensor cores
(wgmma s32.s8.s8, persistent CTAs, one pipelined main loop;
`csrc/gf_matmul.cu`): they multiply the words by the right operand's
transpose, which 8-bit wgmma needs K-major. Callers pass Hᵀ (K, C) and
P (k, c), as the JAX kernels take them; the wrapper keeps one K-major
copy per such tensor (`kmajor_h`), so the codes' cached
`code.tensor("H.T", ...)` and `code.tensor("P", ...)` cost no copy
after their first product. The scan folds mod p and the any-reduce into
its epilogue and writes only the (M,) flags; the encode takes its words
at any alignment (its threads load the aligned words that cover them
and realign them in shared memory, so the wrapper pads and copies
nothing) and writes each residue as int32. `scan_plan` and
`gf_plan` pick each kernel's column tile and persistent grid;
`scan_launch` and `gf_launch` take them as given.

Bound on the card: bytes (each word read once, each output written
once); see the note in `csrc/gf_matmul.cu`.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Under `analysis.use_sanitizer` both
wrappers first check that their words hold symbols in [0, p), as the JAX
package's `kernels/ops.py` does. The plain versions are the reference the
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

import functools
import weakref

import torch
import torch.nn.functional as F

from ..analysis.sanitizer import check_gf_symbols, sanitizer_enabled
from . import build

# int8 operands: |a|, |b| <= 128, so the int32 accumulator is exact while
# K * 128 * 128 < 2^31
INT8_K_MAX = (2 ** 31 - 1) // (128 * 128)
# the kernels' column tiles (their wgmma widths) and words per tile
SCAN_TILES = GF_TILES = (32, 64, 128, 208, 256)
SCAN_ROWS = GF_ROWS = 128


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
    `field_route`). Under `use_sanitizer` both operands must hold symbols
    in [0, p)."""
    if sanitizer_enabled():
        check_gf_symbols(a, p, "gf_matmul lhs")
        check_gf_symbols(b, p, "gf_matmul rhs")
    if build.route("gf_matmul", a, b) == "cpu":
        return gf_matmul_plain(a, b, p)
    _check_shapes("gf_matmul", a, b, p)
    bk = kmajor_h(b, p)
    tile, grid = gf_plan(a.shape[0], bk.shape[0],
                         build.sm_count(a.get_device()))
    return gf_launch(build.int8_operand(a, p), bk, p, tile, grid)


def gf_launch(a8: torch.Tensor, bk: torch.Tensor, p: int, tile: int,
              grid: int) -> torch.Tensor:
    """The encode kernel on contiguous int8 words a8 (M, K) at any
    alignment and `kmajor_h`'s B (N, K16) with column tile `tile` (one of
    GF_TILES) over `grid` persistent CTAs; `gf_matmul` takes both from
    `gf_plan`."""
    M, K = a8.shape
    N, K16 = bk.shape
    out = a8.new_empty((M, N), dtype=torch.int32)
    if M == 0 or N == 0:
        return out
    build.launch("gf_matmul", "rt_gf_matmul", a8.get_device(),
                 a8.data_ptr(), bk.data_ptr(), out.data_ptr(), M, N, K, K16,
                 p, tile, grid)
    return out


@functools.lru_cache(maxsize=256)
def gf_plan(M: int, N: int, slots: int) -> tuple[int, int]:
    """(column tile, CTAs) of the encode kernel for M words and N columns
    on `slots` SMs: the narrowest tile that takes the fewest column chunks
    (N past 256 in two chunks of 208 rather than 256 and 87), and a
    persistent CTA per tile up to one an SM. With fewer tiles than SMs,
    the narrowest tile whose chunks still fit one CTA an SM: few words
    then spread over more CTAs (the chunks' residues are disjoint, so
    nothing is zeroed first; `chip_smoke.py` phase 2 logs each tile's
    device time at a 4096-word page)."""
    fewest = -(-N // GF_TILES[-1])
    tile = next(t for t in GF_TILES if -(-N // t) == fewest)
    rows = -(-M // GF_ROWS)
    tile = next((t for t in GF_TILES
                 if t < tile and rows * -(-N // t) <= slots), tile)
    return tile, min(rows * -(-N // tile), slots)


@functools.lru_cache(maxsize=256)
def scan_plan(M: int, C: int, slots: int) -> tuple[int, int]:
    """(check tile, CTAs) of the scan kernel for M words and C checks on
    `slots` SMs: the narrowest tile that covers every check (C past 256
    in chunks of 256), and a persistent CTA per tile up to one an SM.
    Narrower tiles spread a few words' checks over more CTAs and shorten
    the kernel, but need the flags zeroed first: another launch, which on
    an H100 costs about what it saves (`chip_smoke.py` phase 2 logs each
    tile's device time at the decoder's 256-word check)."""
    tile = next((t for t in SCAN_TILES if t >= C), SCAN_TILES[-1])
    return tile, min(-(-M // SCAN_ROWS) * -(-C // tile), slots)


_KMAJOR_H: dict[int, tuple[int, torch.Tensor]] = {}


def kmajor_h(ht: torch.Tensor, p: int) -> torch.Tensor:
    """B (C, K16) int8, K zero-padded to a multiple of 16 (at least 16),
    from a right operand (K, C): H from Hᵀ for the scan, Pᵀ from P for the
    encode, the kernels' K-major B operand. Kept per `ht` tensor while it
    lives and is not written in place, so a code's cached Hᵀ or P pays the
    transpose once."""
    hit = _KMAJOR_H.get(id(ht))
    if hit is not None and hit[0] == ht._version:
        return hit[1]
    h = build.int8_operand(ht, p).t()
    K = h.shape[1]
    h = F.pad(h, (0, max(16, -(-K // 16) * 16) - K)).contiguous()
    if hit is None:                    # forget it with the tensor
        weakref.finalize(ht, _KMAJOR_H.pop, id(ht), None)
    _KMAJOR_H[id(ht)] = (ht._version, h)
    return h


def scan_syndromes(y: torch.Tensor, ht: torch.Tensor, p: int) -> torch.Tensor:
    """Fused syndrome scan: (M, n) words x (n, c) Hᵀ -> (M,) bool flags,
    flags[i] = any((y[i] @ ht) mod p != 0). Under `use_sanitizer` the
    words must hold symbols in [0, p)."""
    if sanitizer_enabled():
        check_gf_symbols(y, p, "scan_syndromes words")
    if build.route("scan_syndromes", y, ht) == "cpu":
        return scan_syndromes_plain(y, ht, p)
    _check_shapes("scan_syndromes", y, ht, p)
    h8 = kmajor_h(ht, p)
    tile, grid = scan_plan(y.shape[0], h8.shape[0],
                           build.sm_count(y.get_device()))
    return scan_launch(build.int8_operand(y, p), h8, p, tile, grid)


def scan_launch(y8: torch.Tensor, h8: torch.Tensor, p: int, tile: int,
                grid: int) -> torch.Tensor:
    """The scan kernel on int8 words y8 (M, n) and `kmajor_h`'s H (C, K16)
    with check tile `tile` (one of SCAN_TILES) over `grid` persistent
    CTAs; `scan_syndromes` takes both from `scan_plan`."""
    M = y8.shape[0]
    C, K = h8.shape
    flags = y8.new_empty(M, dtype=torch.bool)
    if M == 0:
        return flags
    if y8.shape[1] != K:                   # zero columns add 0 to a sum
        y8 = F.pad(y8, (0, K - y8.shape[1]))
    if y8.data_ptr() % 16:
        y8 = y8.clone()
    build.launch("scan_syndromes", "rt_scan_syndromes", y8.get_device(),
                 y8.data_ptr(), h8.data_ptr(), flags.data_ptr(), M, C, K, p,
                 tile, grid)
    return flags
