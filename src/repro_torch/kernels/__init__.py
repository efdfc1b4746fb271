"""Hand-written CUDA kernels for Hopper (sm_90a), each with its plain
PyTorch version beside it: `gf_matmul.gf_matmul` and
`gf_matmul.scan_syndromes`, `fbp.fbp_cn`, `pim_mac.pim_mac` and
`paged_attention.attend_protected`. The shared library is built from
`csrc/` at the first launch (build.py); importing this package builds
nothing."""
from . import build, fbp, gf_matmul, paged_attention, pim_mac
from .build import LAUNCHES, reset_launches

KERNELS = ("gf_matmul", "scan_syndromes", "fbp_cn", "pim_mac",
           "attend_protected")

__all__ = ["build", "fbp", "gf_matmul", "paged_attention", "pim_mac",
           "LAUNCHES", "reset_launches", "KERNELS"]
