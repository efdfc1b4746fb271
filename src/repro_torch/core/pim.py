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
    if cfg.weight_flip_rate <= 0:
        return W
    flip = torch.rand(W.shape, generator=generator,
                      device=W.device) < cfg.weight_flip_rate
    delta = torch.randint(1, cfg.p, W.shape, generator=generator,
                          device=W.device)                    # 1..p-1
    Wf = torch.remainder(torch.remainder(W, cfg.p) + delta, cfg.p)
    Wf = torch.where(Wf > cfg.p // 2, Wf - cfg.p, Wf)        # centered lift
    return torch.where(flip, Wf.to(W.dtype), W)


def perturb_output(generator: torch.Generator, Y: torch.Tensor,
                   cfg: PIMConfig) -> torch.Tensor:
    """Additive integer error on MAC outputs: ±output_error_mag w.p.
    output_error_rate (sign uniform)."""
    if cfg.output_error_rate <= 0:
        return Y
    hit = torch.rand(Y.shape, generator=generator,
                     device=Y.device) < cfg.output_error_rate
    sign = torch.randint(0, 2, Y.shape, generator=generator,
                         device=Y.device) * 2 - 1
    return Y + torch.where(hit, sign * cfg.output_error_mag, 0).to(Y.dtype)


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
