"""Bit-line PIM MAC with a per-row-group ADC clip: CUDA kernel and its
plain version.

Replaces the TPU kernel `src/repro/kernels/pim_mac.py: pim_mac_pallas`:
Y = Σ_g clip(x_g · w_g, ±(adc_levels // 2)) over groups of R rows of K
(R = row_parallelism, all of K when 0); with adc_levels = 0 it is the exact
integer product. The CUDA kernel (`csrc/pim_mac.cu`) is an int8 dp4a tile
product that keeps each group's partial sums in registers and clips them
into the int32 accumulator where the next group starts.

Bound on the card: bytes at the int8 tensor cores' rate; this dp4a kernel
runs on the CUDA cores and is limited by their multiply-adds instead, see
the note in `csrc/pim_mac.cu`.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

INT8_K_MAX = (2 ** 31 - 1) // (128 * 128)


def _groups(K: int, row_parallelism: int) -> tuple[int, int]:
    R = row_parallelism if row_parallelism > 0 else K
    return R, -(-K // R) if K else 0


def pim_mac_plain(x: torch.Tensor, w: torch.Tensor, *, row_parallelism: int,
                  adc_levels: int) -> torch.Tensor:
    """Row-grouped ADC-clipped MAC. x: (B, K), w: (K, N) integers ->
    (B, N) int32. K is zero-padded to a multiple of R (a zero row adds 0
    to its group's partial)."""
    B, K = x.shape
    N = w.shape[1]
    R, g = _groups(K, row_parallelism)
    xg = F.pad(x.to(torch.int64), (0, g * R - K)).reshape(B, g, R)
    wg = F.pad(w.to(torch.int64), (0, 0, 0, g * R - K)).reshape(g, R, N)
    xm = int(xg.abs().max()) if xg.numel() else 0
    wm = int(wg.abs().max()) if wg.numel() else 0
    # (g, B, R) @ (g, R, N) -> (g, B, N) partial sums of each row group
    partial = build.exact_matmul(xg.transpose(0, 1), wg, R * xm * wm)
    if adc_levels > 0:
        half = adc_levels // 2
        partial = partial.clamp(-half, half)
    return partial.sum(dim=0).to(torch.int32)


def group_layout(x: torch.Tensor, w: torch.Tensor, R: int):
    """Zero-pad K to whole groups of R rows and every group to R4, the next
    multiple of 4, so no packed 4-byte dp4a word straddles two groups.
    Padded rows add 0 to their group's partial, so the clipped MAC is
    unchanged. Returns (x (B, g*R4), w (g*R4, N), R4)."""
    B, K = x.shape
    N = w.shape[1]
    g = -(-K // R)
    R4 = -(-R // 4) * 4
    if g * R == K and R4 == R:
        return x, w, R
    xp = F.pad(F.pad(x, (0, g * R - K)).reshape(B, g, R), (0, R4 - R))
    wp = F.pad(F.pad(w, (0, 0, 0, g * R - K)).reshape(g, R, N),
               (0, 0, 0, R4 - R))
    return xp.reshape(B, g * R4), wp.reshape(g * R4, N), R4


def pim_mac(x: torch.Tensor, w: torch.Tensor, *, row_parallelism: int = 0,
            adc_levels: int = 0) -> torch.Tensor:
    """(B, K) x (K, N) -> (B, N) int32 group-clipped MAC. On the card both
    operands must be int8 (activations and centered-lift cell values)."""
    if build.route("pim_mac", x, w) == "cpu":
        return pim_mac_plain(x, w, row_parallelism=row_parallelism,
                             adc_levels=adc_levels)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"pim_mac: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)} do not chain")
    x8, w8 = build.int8_operand(x), build.int8_operand(w)
    R = row_parallelism if row_parallelism > 0 else x8.shape[1]
    if adc_levels > 0 and x8.shape[1]:
        x8, w8, R = group_layout(x8, w8, R)
        x8, w8 = x8.contiguous(), w8.contiguous()
    B, K = x8.shape
    N = w8.shape[1]
    if K > INT8_K_MAX:
        raise ValueError(f"pim_mac: int32 accumulator bound exceeded, K={K}")
    out = torch.empty((B, N), dtype=torch.int32, device=x.device)
    err = build.library().rt_pim_mac(
        x8.data_ptr(), w8.data_ptr(), out.data_ptr(), B, N, K, R, adc_levels,
        build.stream_handle(x.device))
    build.check(err, "pim_mac")
    build.LAUNCHES["pim_mac"] += 1
    return out
