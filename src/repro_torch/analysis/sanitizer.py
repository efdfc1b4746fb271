"""Runtime sanitizer: eager torch checks on the GF and attention entry
points, behind a `use_sanitizer` ambient, as the JAX package's
`repro.analysis.sanitizer` puts `checkify` assertions there.

The GF pipeline's failure mode is silent: an out-of-range symbol still
flows through `(y @ Ht) mod p`, a NaN query poisons the online softmax's
m / l / acc recurrence without raising, a negative quantization scale just
flips signs. This module turns those into hard errors:

    from repro_torch.analysis import use_sanitizer
    with use_sanitizer():
        scan_syndromes(y, ht, p)        # raises SanitizerError on y >= p
        attend_protected(...)           # raises on a non-finite output

The checks are wired into the kernel wrappers (`kernels.gf_matmul`:
`gf_matmul` (and so the encode) and `scan_syndromes`;
`kernels.paged_attention.attend_protected`) and into
`core.decode.decode_integers`, on its outputs: received words are raw
levels that legitimately drift outside [0, p), while the decoder's
symbols must be in the field and its LLV totals finite.

Each check is an eager reduction on the tensor's own device and one host
read of its result; a CUDA tensor is never copied to the CPU to be
checked. When the sanitizer is off, a check costs one module-level bool
read. Everything in the port runs eagerly, so there is no traced value to
step around (the JAX sanitizer skips `jax.jit` tracers). The messages are
the JAX package's, values filled in.
"""
from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["use_sanitizer", "sanitizer_enabled", "check_gf_symbols",
           "check_finite", "check_quant_scales", "SanitizerError"]


class SanitizerError(RuntimeError):
    """A sanitizer check failed: the message names the entry point and
    the offending values."""


# REPRO_SANITIZE=1 arms the ambient at import, so an existing run or test
# subset can be swept under the checks without touching its code
_enabled = os.environ.get("REPRO_SANITIZE", "") == "1"


def sanitizer_enabled() -> bool:
    """One cheap read per entry-point call."""
    return _enabled


@contextlib.contextmanager
def use_sanitizer(enabled: bool = True):
    """Install (or, with `enabled=False`, suspend) the runtime sanitizer
    for the block. Nests and restores."""
    global _enabled
    prev = _enabled
    _enabled = bool(enabled)
    try:
        yield
    finally:
        _enabled = prev


def check_gf_symbols(arr, p: int, what: str = "gf") -> None:
    """Raise `SanitizerError` unless every symbol sits in `[0, p)`."""
    if not _enabled:
        return
    arr = torch.as_tensor(arr)
    if arr.numel() == 0:
        return
    mn, mx = torch.stack([arr.min(), arr.max()]).tolist()
    if mn < 0 or mx >= p:
        raise SanitizerError(
            f"sanitizer[{what}]: GF symbol outside [0, {int(p)}): "
            f"min={mn}, max={mx}")


def check_finite(arr, what: str = "tensor") -> None:
    """Raise `SanitizerError` on any NaN/Inf in a float tensor (integer
    tensors pass unchecked)."""
    if not _enabled:
        return
    arr = torch.as_tensor(arr)
    if arr.numel() == 0 or not arr.is_floating_point():
        return
    nans, infs = torch.stack([torch.isnan(arr).sum(),
                              torch.isinf(arr).sum()]).tolist()
    if nans or infs:
        raise SanitizerError(
            f"sanitizer[{what}]: non-finite value "
            f"(nan_count={nans}, inf_count={infs})")


def check_quant_scales(arr, what: str = "scales") -> None:
    """Raise `SanitizerError` on non-finite or negative quantization
    scales (scale 0 is the legal padded/empty-page marker)."""
    if not _enabled:
        return
    arr = torch.as_tensor(arr)
    if arr.numel() == 0:
        return
    bad = ~(torch.isfinite(arr) & (arr >= 0))
    n_bad, mn = torch.stack([bad.sum().double(),
                             arr.min().double()]).tolist()
    if n_bad:
        raise SanitizerError(
            f"sanitizer[{what}]: quantization scale must be finite and "
            f">= 0 (zero marks an empty/padded page): min={mn}")
