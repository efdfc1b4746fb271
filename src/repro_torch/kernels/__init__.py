"""Hand-written CUDA kernels for Hopper (sm_90a), each with its plain
PyTorch version beside it: `gf_matmul.gf_matmul` and
`gf_matmul.scan_syndromes`, `fbp.fbp_cn`, `pim_mac.pim_mac` and
`paged_attention.attend_protected`, and `flash_attention.flash_fwd`,
`flash_bwd_dq` and `flash_bwd_dkv` (with the `FlashAttention` autograd
function over them). The shared library is built from `csrc/` at the
first launch (build.py); importing this package builds
nothing."""
from . import (build, fbp, flash_attention, gf_matmul, paged_attention,
               pim_mac)
from .build import LAUNCHES, reset_launches

KERNELS = ("gf_matmul", "scan_syndromes", "fbp_cn", "pim_mac",
           "attend_protected", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

__all__ = ["build", "fbp", "flash_attention", "gf_matmul",
           "paged_attention", "pim_mac", "LAUNCHES", "reset_launches", "KERNELS"]
