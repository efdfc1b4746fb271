"""Error-feedback int8 gradient compression: the port of the JAX
package's `repro.distributed.compression`.

A tensor is sent as int8 and one float32 scale (absmax / 127); error
feedback adds the residual of each round back before the next
quantization, so the time average of the dequantized values converges to
the true ones. `compressed_psum` is the all-reduce of compressed
tensors over one axis of a mesh (`distributed.sharding.Mesh`): each
participant quantizes its tensor with its own error-feedback state, and
only the int8 payloads and the float32 scales cross to the other
participants' devices, where they are widened. The JAX package has no
trainer flag for it, and neither has the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .sharding import axis_devices

__all__ = ["EFState", "init_ef", "quantize_ef", "dequantize",
           "compressed_psum"]


class EFState(NamedTuple):
    residual: torch.Tensor       # the tensor's shape, float32


def init_ef(tree):
    """{name: tensor} (or one tensor) -> the matching zero EFStates."""
    if isinstance(tree, dict):
        return {k: init_ef(v) for k, v in tree.items()}
    return EFState(torch.zeros_like(tree, dtype=torch.float32))


def quantize_ef(x: torch.Tensor, ef: EFState):
    """float -> (int8 payload, float32 scale (0-d), new EFState): the
    value not represented this round is carried to the next."""
    xf = x.to(torch.float32) + ef.residual
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale, EFState(xf - q.to(torch.float32) * scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _quantize_fused(x: torch.Tensor, ef: EFState):
    """`quantize_ef` with the residual rounded once: q·scale (8 by 24
    bits) and its difference from xf (within 26 bits) are exact in
    float64, so rounding that to float32 gives the fused multiply-add."""
    q, scale, _ = quantize_ef(x, ef)
    xf = x.to(torch.float32) + ef.residual
    resid = xf.double() - q.double() * scale.double()
    return q, scale, EFState(resid.to(torch.float32))


def compressed_psum(xs, efs, mesh, axis_name: str = "data"):
    """All-reduce over `axis_name` of `mesh` with the int8 wire format and
    error feedback, as the JAX package's `compressed_psum` inside its
    `shard_map`: `xs[i]` and `efs[i]` are participant i's tensor and
    `EFState`, on the i-th device along the axis. Returns (outs, new
    efs): `outs[i]` on participant i's device, each
    (Σ int32(q) · mean(scale) + Σ q · (scale - mean(scale))) / n, the JAX
    formula, with the sums taken in participant order. Each new residual
    is xf - q·scale rounded once, as the JAX collective (always jitted)
    computes it: XLA fuses the product and the difference."""
    devices = axis_devices(mesh, axis_name)
    if len(xs) != len(devices) or len(efs) != len(devices):
        raise ValueError(f"{len(xs)} tensors and {len(efs)} states for "
                         f"{len(devices)} participants along {axis_name!r}")
    sent = [_quantize_fused(x.to(dev), ef)
            for x, ef, dev in zip(xs, efs, devices, strict=True)]
    n = len(devices)
    outs = []
    for dev in devices:
        # what crosses: each participant's int8 payload and scale
        qs = [q.to(dev, non_blocking=True) for q, _s, _e in sent]
        scales = [s.to(dev, non_blocking=True) for _q, s, _e in sent]
        summed = qs[0].to(torch.int32)
        for q in qs[1:]:
            summed = summed + q.to(torch.int32)
        mean_scale = scales[0]
        for s in scales[1:]:
            mean_scale = mean_scale + s
        mean_scale = mean_scale / n
        corr = qs[0].to(torch.float32) * (scales[0] - mean_scale)
        for q, s in zip(qs[1:], scales[1:], strict=True):
            corr = corr + q.to(torch.float32) * (s - mean_scale)
        outs.append((summed.to(torch.float32) * mean_scale + corr) / n)
    return outs, [ef for _q, _s, ef in sent]
