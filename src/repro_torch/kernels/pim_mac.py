"""Bit-line PIM MAC with a per-row-group ADC clip: CUDA kernel and its
plain version.

Replaces the TPU kernel `src/repro/kernels/pim_mac.py: pim_mac_pallas`:
Y = Σ_g clip(x_g · w_g, ±(adc_levels // 2)) over groups of R rows of K
(R = row_parallelism, all of K when 0); with adc_levels = 0 it is the exact
integer product. The CUDA kernel (`csrc/pim_mac.cu`) runs the group
products on the int8 tensor cores (wgmma s32.s8.s8) and clamps each
group's int32 accumulator into the total in registers.

8-bit wgmma reads both operands K-major; the kernel transposes each W
tile in shared memory, so `core/pim.py::pim_mac` passes the stored (K, N)
weights as they are and pays no copy per call (on an H100 a
`w.t().contiguous()` in the wrapper took six times the kernel's device
time). With few output
tiles the wrapper splits K over the grid (`k_split`); the kernel's CTAs
then add into the output, which its entry point zeroes first.

Bound on the card: bytes (X, W and Y once), see the note in
`csrc/pim_mac.cu`.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import build

INT8_K_MAX = (2 ** 31 - 1) // (128 * 128)
STEP = 32            # K bytes of one s8 wgmma step
STAGE = 128          # K bytes of one stage of the kernel's pipeline
TILE_M, TILE_N = 128, 128   # output tile of a CTA (csrc/pim_mac.cu)


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
    """Zero-pad K to whole groups of R rows and every group to R32, the
    next multiple of 32, so that each group is whole k32 steps of the
    kernel's s8 wgmma. Padded rows add 0 to their group's partial, so the
    clipped MAC is unchanged. Returns (x (B, g*R32), w (g*R32, N), R32)."""
    B, K = x.shape
    N = w.shape[1]
    g = -(-K // R)
    R32 = -(-R // STEP) * STEP
    if g * R == K and R32 == R:
        return x, w, R
    xp = F.pad(F.pad(x, (0, g * R - K)).reshape(B, g, R), (0, R32 - R))
    wp = F.pad(F.pad(w, (0, 0, 0, g * R - K)).reshape(g, R, N),
               (0, 0, 0, R32 - R))
    return xp.reshape(B, g * R32), wp.reshape(g * R32, N), R32


def _split_cost(tiles: int, units: int, split: int, slots: int) -> int:
    """Time of a grid of `tiles` x `split` CTAs over `slots` SMs, in
    stages: the waves times the stages a CTA walks, plus two for its
    prologue and epilogue."""
    return -(-tiles * split // slots) * (-(-units // split) + 2)


@functools.lru_cache(maxsize=256)
def k_split(B: int, N: int, K: int, unit: int, slots: int) -> int:
    """K bytes per CTA: whole `unit`s (a multiple of the stage and, with a
    clip, of the group), in as many ranges as give the least
    `_split_cost` of the output tiles on `slots` SMs, one CTA each (the
    fewest ranges among equals)."""
    tiles = -(-B // TILE_M) * -(-N // TILE_N)
    units = max(1, -(-K // unit))
    split = min(range(1, units + 1),
                key=lambda s: (_split_cost(tiles, units, s, slots), s))
    return -(-units // split) * unit


def tma_layout(x: torch.Tensor, w: torch.Tensor):
    """Operands the kernel's tensor copies take: contiguous, 16-byte
    aligned, K and w's row stride multiples of 16. K is zero-padded (zero
    rows add 0; the clipped layout is already whole 32-row groups) and w's
    columns are padded (the kernel masks columns past N); aligned operands
    pass as they are. Returns (x (B, K16), w (K16, N16))."""
    K, N = w.shape
    pk, pn = -K % 16, -N % 16
    if pk or pn:
        x = F.pad(x, (0, pk))
        w = F.pad(w, (0, pn, 0, pk))
    x, w = x.contiguous(), w.contiguous()
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))


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
    B, K = x8.shape
    N = w8.shape[1]
    if K > INT8_K_MAX:
        raise ValueError(f"pim_mac: int32 accumulator bound exceeded, K={K}")
    x8, w8 = tma_layout(x8, w8)
    K = x8.shape[1]
    clip = adc_levels > 0
    unit = math.lcm(R, STAGE) if clip and K else STAGE
    kper = k_split(B, N, K, unit, build.sm_count(x.device))
    out = torch.empty((B, N), dtype=torch.int32, device=x.device)
    build.launch("pim_mac", "rt_pim_mac", x.device, x8.data_ptr(),
                 w8.data_ptr(), out.data_ptr(), B, N, K, w8.shape[1], R,
                 adc_levels, kper)
    return out
