"""Quickstart on the PyTorch/CUDA port: the paper's NB-LDPC arithmetic
code in 60 lines (the port's counterpart of `examples/quickstart.py`).

1. build a GF(3) code, 2. encode a weight matrix (check columns ride along),
3. run the PIM MAC with injected analog faults (Eq. 4), 4. detect via the
syndrome (Eq. 5), 5. correct with the FBP decoder (§3.2), 6. compare.

Run:  PYTHONPATH=src python scripts/quickstart_torch.py [--cpu]
(on the card; `--cpu` runs the kernels' plain versions on the CPU)
"""
import sys

import numpy as np
import torch

from repro_torch.core import (PIMConfig, ProtectionConfig,
                              encode_weight_matrix, get_code, pim_mac,
                              protected_pim_matmul, syndrome)
from repro_torch.device import resolve_device

device = resolve_device("cpu" if "--cpu" in sys.argv[1:] else None)


def key(seed):
    """A fault draw's generator: one seed, the same faults."""
    return torch.Generator(device=device).manual_seed(seed)


rng = np.random.default_rng(0)
code = get_code("wl160_r08")          # 160 GF(3) symbols, rate 0.8
print(f"code: n={code.n} k={code.k} GF({code.p}) rate={code.rate:.2f} "
      f"(paper §3: H_G·H_Cᵀ=0)")

# --- ternary weights (differential mapping, §3.3) + encode -----------------
n_in, n_out = 96, 2 * code.k
W_np = rng.integers(-1, 2, (n_in, n_out))
W = torch.as_tensor(W_np, dtype=torch.int32, device=device)
W_enc = encode_weight_matrix(W, code)
print(f"stored array: {tuple(W.shape)} -> {tuple(W_enc.shape)} "
      f"(+{W_enc.shape[1] - n_out} check columns)")

# --- PIM MAC with faults (the analog path is noisy, Fig. 1a) ---------------
x_np = rng.integers(-1, 2, (8, n_in))
x = torch.as_tensor(x_np, dtype=torch.int32, device=device)
exact = x_np @ W_np
noisy_cfg = PIMConfig(output_error_rate=0.01, output_error_mag=1)
Y_noisy = pim_mac(x, W_enc, noisy_cfg, generator=key(7))

# --- detect (Eq. 5): syndrome of the *MAC output*, dataflow uninterrupted --
synd = syndrome(Y_noisy.reshape(-1, code.n) % code.p, code)
n_bad_words = int((synd != 0).any(-1).sum())
print(f"syndrome flags {n_bad_words}/{synd.shape[0]} MAC output words")

# --- correct (§3.2: LLV init -> FBP iterations -> reinterpret) -------------
res = protected_pim_matmul(x, W_enc, code,
                           ProtectionConfig(mode="correct", n_iters=10,
                                            damping=0.3),
                           noisy_cfg, generator=key(7))

raw = protected_pim_matmul(x, W_enc, code, ProtectionConfig(mode="off"),
                           noisy_cfg, generator=key(7))
err_before = float((raw.y.cpu().numpy() != exact).mean())
err_after = float((res.y.cpu().numpy() != exact).mean())
print(f"integer error rate: {err_before:.4f} -> {err_after:.4f} "
      f"({err_before / max(err_after, 1e-9):.1f}x improvement)")
assert err_after < err_before
print("OK: NB-LDPC corrected the PIM MAC without interrupting the dataflow.")
