"""repro_torch — the NB-LDPC arithmetic error-correction codec for
processing-in-memory, ported to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

It mirrors the module layout of the JAX package `repro` and imports none
of it (nor JAX). Entry points run on the GPU unless the caller passes
`device="cpu"` or CPU tensors (see `device.py`); the CUDA kernels are
built from `kernels/csrc/` at their first launch.

Memory mode:  `repro_torch.memory.ProtectedMemoryArray`
PIM mode:     `repro_torch.core.protected_pim_matmul`
Protected KV-cache serving: `repro_torch.models.prefill(...,
              protected_kv=ProtectedKVConfig(...))`, then `decode_step`
Multi-tenant serving: `repro_torch.serving.ServingEngine` over a shared
              `repro_torch.memory.ProtectedPagePool`
Training:     `repro_torch.launch.train.run(cfg, ...)` (flash attention
              forward and backward under `attn_impl="flash"`)
Telemetry:    `repro_torch.obs` (metrics, spans, the RAS estimator);
              runtime checks: `repro_torch.analysis.use_sanitizer`
"""
from . import (analysis, checkpoint, configs, convert, core, data,
               distributed, kernels, launch, memory, models, nn, obs, optim,
               serving)
from .device import resolve_device

__all__ = ["analysis", "checkpoint", "configs", "convert", "core", "data",
           "distributed", "kernels", "launch", "memory", "models", "nn",
           "obs", "optim", "serving", "resolve_device"]
