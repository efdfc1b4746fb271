"""PIM MAC simulation (paper §2.1, §5).

Models the analog compute path of a PIM macro:
  - weights stored as multi-level cells (GF(p) symbols / differential ternary),
  - bit-serial inputs driving wordlines,
  - bitline accumulation over `row_parallelism` rows at a time,
  - ADC quantization (few-level flash ADC) of each partial sum,
  - stochastic fault models: stored-cell symbol flips and per-sample additive
    integer errors on the accumulated output (the paper's Fig. 6(c) model).

Noise comes from an explicit `torch.Generator`, so every simulation is
deterministic; the MAC itself is `repro_torch.kernels.pim_mac` (the CUDA
kernel on the card) and the noise is applied outside it. A caller that
drew its noise elsewhere passes flipped weights and `out_noise` instead.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import pim_mac as _pim_mac


@dataclasses.dataclass(frozen=True)
class PIMConfig:
    row_parallelism: int = 0          # rows accumulated per analog step; 0 = all
    adc_levels: int = 0               # 0 = ideal ADC (no clipping/rounding)
    weight_flip_rate: float = 0.0     # P[a stored cell reads as a wrong symbol]
    output_error_rate: float = 0.0    # P[an accumulated output gains ±e]
    output_error_mag: int = 1         # e: magnitude of injected output errors
    p: int = 3                        # field order (cells hold GF(p) symbols)


def flip_weights(generator: torch.Generator, W: torch.Tensor,
                 cfg: PIMConfig) -> torch.Tensor:
    """Cell-read fault: each cell independently flips to a *different* symbol
    with prob weight_flip_rate (uniform over the p-1 wrong symbols), in the
    centered-lift representation."""
    return flip_rows(generator, W, cfg)


def flip_rows(generator: torch.Generator, W: torch.Tensor, cfg: PIMConfig,
              row0: int = 0, n_rows: int | None = None) -> torch.Tensor:
    """`flip_weights` of rows [row0, row0 + len(W)) of an (n_rows, N)
    weight: the draws of the whole shape, those rows kept, so a
    row-parallel MAC flips each position's rows as the unsharded call
    flips them."""
    if cfg.weight_flip_rate <= 0:
        return W
    shape = (W.shape[0] if n_rows is None else n_rows, W.shape[1])
    rows = slice(row0, row0 + W.shape[0])
    flip = torch.rand(shape, generator=generator,
                      device=W.device)[rows] < cfg.weight_flip_rate
    delta = torch.randint(1, cfg.p, shape, generator=generator,
                          device=W.device)[rows]              # 1..p-1
    Wf = torch.remainder(torch.remainder(W, cfg.p) + delta, cfg.p)
    Wf = torch.where(Wf > cfg.p // 2, Wf - cfg.p, Wf)        # centered lift
    return torch.where(flip, Wf.to(W.dtype), W)


def output_errors(generator: torch.Generator, shape, cfg: PIMConfig,
                  device) -> torch.Tensor:
    """The additive output errors of a MAC output of `shape` (int64):
    ±output_error_mag w.p. output_error_rate (sign uniform)."""
    hit = torch.rand(shape, generator=generator,
                     device=device) < cfg.output_error_rate
    sign = torch.randint(0, 2, shape, generator=generator,
                         device=device) * 2 - 1
    return torch.where(hit, sign * cfg.output_error_mag, 0)


def perturb_output(generator: torch.Generator, Y: torch.Tensor,
                   cfg: PIMConfig) -> torch.Tensor:
    """Additive integer error on MAC outputs: ±output_error_mag w.p.
    output_error_rate (sign uniform)."""
    if cfg.output_error_rate <= 0:
        return Y
    return Y + output_errors(generator, Y.shape, cfg, Y.device).to(Y.dtype)


def adc_quantize(partial: torch.Tensor, cfg: PIMConfig) -> torch.Tensor:
    """Flash-ADC model: clip each analog partial sum to the ADC range
    [-(L//2), L//2]. With ideal ADC (adc_levels=0) this is identity."""
    if cfg.adc_levels <= 0:
        return partial
    half = cfg.adc_levels // 2
    return partial.clamp(-half, half)


def _int8(t: torch.Tensor, name: str) -> torch.Tensor:
    """The card's MAC takes int8 operands: activations and centered cell
    values; anything outside int8 is refused, never wrapped."""
    if t.dtype == torch.int8:
        return t
    lo, hi = torch.aminmax(t)
    if int(lo) < -128 or int(hi) > 127:
        raise ValueError(f"pim_mac: {name} values [{int(lo)}, {int(hi)}] "
                         "do not fit the int8 MAC operands")
    return t.to(torch.int8)


def pim_mac(x: torch.Tensor, W: torch.Tensor, cfg: PIMConfig,
            generator: torch.Generator | None = None,
            out_noise: torch.Tensor | None = None) -> torch.Tensor:
    """Simulated PIM VMM:  Y = X · W  (paper Eq. 1 / Eq. 4) -> (B, n_out)
    int32.

    x: (B, n_in) integers (bit-serial input values), W: (n_in, n_out) integer
    cell values (data + check columns if encoded). Accumulation happens in
    row groups of cfg.row_parallelism with ADC clipping per group. With a
    `generator`, weight flips are drawn before the MAC and output errors
    after it; `out_noise` (B, n_out) is added to the output as drawn.
    """
    if generator is not None:
        W = flip_weights(generator, W, cfg)
    if x.device.type == "cuda":
        x, W = _int8(x, "x"), _int8(W, "W")
    Y = _pim_mac.pim_mac(x, W, row_parallelism=cfg.row_parallelism,
                         adc_levels=cfg.adc_levels)
    if generator is not None:
        Y = perturb_output(generator, Y, cfg)
    if out_noise is not None:
        Y = Y + out_noise.to(Y.dtype)
    return Y


def pim_mac_rows(x: torch.Tensor, W: torch.Tensor, cfg: PIMConfig,
                 row0: int, n_rows: int):
    """The MAC of rows [row0, row0 + K) of an (n_rows, N) weight (x: (B,
    K) their inputs), one position of a row-parallel MAC. Returns
    (clipped, partials): the (B, N) int32 sum of the clipped ADC groups
    that lie whole in these rows (None if none does), and {group index:
    its unclipped (B, N) int32 partial} for the groups these rows share
    with other positions' rows, which are clipped once summed. With an
    ideal ADC nothing is clipped and the whole product is `clipped`."""
    if x.device.type == "cuda":
        x, W = _int8(x, "x"), _int8(W, "W")
    K = x.shape[1]
    if cfg.adc_levels <= 0:
        return _pim_mac.pim_mac(x, W, row_parallelism=cfg.row_parallelism,
                                adc_levels=0), {}
    R = cfg.row_parallelism if cfg.row_parallelism > 0 else n_rows
    r1 = row0 + K
    a = -(-row0 // R) * R                 # the first group start in range
    b = r1 // R * R                       # the last group start in range

    def mac(lo, hi, adc):
        return _pim_mac.pim_mac(x[:, lo - row0:hi - row0],
                                W[lo - row0:hi - row0], row_parallelism=R,
                                adc_levels=adc)
    clipped = mac(a, b, cfg.adc_levels) if a < b else None
    partials = {}
    if row0 < min(a, r1):
        partials[row0 // R] = mac(row0, min(a, r1), 0)
    if a <= b < r1:
        partials[b // R] = mac(b, r1, 0)
    return clipped, partials
