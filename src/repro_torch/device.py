"""The port's device rule.

Every entry point runs on the card unless the caller asks for the CPU,
either with `device="cpu"` or by handing it CPU tensors. With no CUDA
device and no such request it raises: nothing falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card, and raises when
    there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the "
                "caller passes device='cpu' or CPU tensors")
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor stays on its own device unless `device` is given; anything
    else (numpy, lists) goes to `resolve_device(device)`."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            x = x.to(torch.device(device))
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def generator(key, fallback: torch.Generator, device) -> torch.Generator:
    """A fault-injection `key` as a generator: None draws on `fallback`
    (so repeated injections differ), a generator is used as it is, an int
    seeds a new one on `device`."""
    if key is None:
        return fallback
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))
