"""Check-node Forward-Backward Propagation (paper §3.2.2): CUDA kernel and
its plain version.

Replaces the TPU kernel `src/repro/kernels/fbp.py: fbp_cn_pallas`. For each
check node (a row of (N, dc, p) float32 contribution-space messages) it
runs the forward and backward chains of cyclic max-plus convolutions over
the dc slots, and returns every slot's extrinsic conv(fm[t-1], bm[t+1])
reflected k -> -k. The CUDA kernel (`csrc/fbp.cu`) runs one row per
thread, in the plain version's order, so the two are bitwise equal: its
persistent CTAs (at most three an SM) take blocks of rows by 1-D bulk
copies, repack them to an odd row stride in shared memory, and keep the
backward chain in each row's output slots, so a thread's registers do not
grow with dc.

Bound on the card: bytes (a few operations per byte); see the note in
`csrc/fbp.cu`.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. In the port the kernel is the decoder's CN
step on the card (the JAX package leaves its kernel off the default path).
"""
from __future__ import annotations

import functools

import torch

from . import build
from ..core.llv import NEG_INF

PRIMES = (2, 3, 5, 7)
MAX_DC = 32


@functools.lru_cache(maxsize=32)
def _conv_index(p: int) -> tuple:
    """idx[k][j] = (k - j) % p — gather table for the cyclic conv."""
    return tuple(tuple((k - j) % p for j in range(p)) for k in range(p))


def maxplus_conv(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """Cyclic max-plus convolution along the last (GF) axis — paper Eq. 7:
    out[k] = max_j a[(k - j) % p] + b[j]."""
    idx = torch.tensor(_conv_index(p), device=a.device)      # (p, p)
    terms = a[..., idx] + b[..., None, :]                    # (..., p, p)
    return terms.amax(dim=-1)


def identity_msg(shape, p: int, dtype=torch.float32, device=None):
    """The max-plus identity message: 0 at k=0, NEG_INF elsewhere."""
    e = torch.full(tuple(shape) + (p,), NEG_INF, dtype=dtype, device=device)
    e[..., 0] = 0.0
    return e


def _reflect(ext: torch.Tensor, p: int) -> torch.Tensor:
    """out[..., k] = ext[..., (-k) % p]."""
    idx = torch.tensor([(-k) % p for k in range(p)], device=ext.device)
    return ext[..., idx]


def fbp_cn_plain(m_hat: torch.Tensor, p: int) -> torch.Tensor:
    """(..., dc, p) contribution-space messages (padded slots hold the
    identity) -> reflected extrinsic messages of the same shape."""
    dc = m_hat.shape[-2]
    if dc == 1:
        return _reflect(identity_msg(m_hat.shape[:-2], p, m_hat.dtype,
                                     m_hat.device)[..., None, :], p)
    fm = [m_hat[..., 0, :]]
    for t in range(1, dc):
        fm.append(maxplus_conv(fm[-1], m_hat[..., t, :], p))
    bm = [m_hat[..., dc - 1, :]]
    for t in range(dc - 2, -1, -1):
        bm.append(maxplus_conv(m_hat[..., t, :], bm[-1], p))
    bm = bm[::-1]                        # bm[t] = conv of slots t..dc-1
    parts = [bm[1][..., None, :]]
    if dc > 2:
        # interior slots t=1..dc-2 in one batched conv
        parts.append(maxplus_conv(torch.stack(fm[:dc - 2], dim=-2),
                                  torch.stack(bm[2:], dim=-2), p))
    parts.append(fm[dc - 2][..., None, :])
    return _reflect(torch.cat(parts, dim=-2), p)


def fbp_cn(m_hat: torch.Tensor, p: int) -> torch.Tensor:
    """(N, dc, p) float32 contribution-space messages -> reflected
    extrinsics (N, dc, p)."""
    if build.route("fbp_cn", m_hat) == "cpu":
        return fbp_cn_plain(m_hat, p)
    if m_hat.dim() != 3 or m_hat.shape[2] != p:
        raise ValueError(f"fbp_cn: expected (N, dc, {p}), got "
                         f"{tuple(m_hat.shape)}")
    if m_hat.dtype != torch.float32:
        raise TypeError(f"fbp_cn: expected float32, got {m_hat.dtype}")
    N, dc, _ = m_hat.shape
    if p not in PRIMES or not 1 <= dc <= MAX_DC:
        raise ValueError(f"fbp_cn kernel: p={p} dc={dc} outside p in "
                         f"{PRIMES}, dc <= {MAX_DC}")
    m = m_hat.contiguous()
    if m.data_ptr() % 16:              # the bulk copies' alignment
        m = m.clone()
    out = torch.empty_like(m)
    if N == 0:
        return out
    build.launch("fbp_cn", "rt_fbp_cn", m.device, m.data_ptr(),
                 out.data_ptr(), N, dc, p, build.sm_count(m.device))
    return out


def fbp_cn_batched(m_hat: torch.Tensor, p: int) -> torch.Tensor:
    """decode's CN step: (B, c, dc, p) -> (B, c, dc, p) through `fbp_cn`."""
    B, c, dc, pp = m_hat.shape
    return fbp_cn(m_hat.reshape(B * c, dc, pp), p).reshape(B, c, dc, pp)
