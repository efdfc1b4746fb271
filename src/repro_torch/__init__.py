"""repro_torch — the NB-LDPC arithmetic error-correction codec for
processing-in-memory, ported to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

It mirrors the module layout of the JAX package `repro` and imports none
of it (nor JAX). Entry points run on the GPU unless the caller passes
`device="cpu"` or CPU tensors (see `device.py`); the CUDA kernels are
built from `kernels/csrc/` at their first launch.

Memory mode:  `repro_torch.memory.ProtectedMemoryArray`
PIM mode:     `repro_torch.core.protected_pim_matmul`
"""
from . import convert, core, kernels, memory
from .device import resolve_device

__all__ = ["convert", "core", "kernels", "memory", "resolve_device"]
