"""Mamba-1 block (selective SSM): the port of the JAX package's
`repro.nn.mamba`, for falcon-mamba-7b and jamba's mamba layers.

A full pass (training, prefill) runs a chunked selective scan: time is
cut into chunks of `cfg.mamba_chunk`, the (d_inner, d_state) state is
carried from chunk to chunk, and inside a chunk the affine recurrence
h_t = a_t·h_{t-1} + b_t is evaluated as a log-depth associative scan (the
same pairwise recursion as `jax.lax.associative_scan`). The JAX package
is jnp here, not a Pallas kernel, and so is the port: plain PyTorch.

Differences by design:
- no padding: the JAX package pads L to a whole number of chunks (zero
  delta leaves h unchanged); the port scans the ragged last chunk as it
  is, with the same final state.
- no TF32: `dt @ dt_proj_w` is a float32 product in the JAX package; the
  port computes it in float64 and rounds to float32, so the caller's
  TF32 flag (`torch.backends.cuda.matmul.allow_tf32`, which the port
  never sets) cannot lower it. The state contractions
  ("bcds,bcs->bcd", "bds,bs->bd") are multiplies and sums over d_state,
  never a matmul.

A decode step is one recurrence step on the carried state: the conv
tail (B, d_conv - 1, d_inner) bf16 and the SSM state (B, d_inner,
d_state) float32, as `init_mamba_state` makes them.

Under tensor parallelism (`distributed.sharding.Parts`: the training
pass, prefill and the decode step) `d_inner` splits over `model` (the
JAX `constrain` sites): each position runs the conv, the scan or the
decode step and the gate on its d_inner slice, carrying its slice of
the conv tail and the SSM state;
`x_proj` and `out_proj` are row-parallel (their partial sums added over
positions, the first so that every position reads the whole (dt, B,
C)). `in_proj` stays placed as the JAX package places it, one block of
its 2·d_inner columns a position (on two positions the first holds all
of u, the second all of z): each use gathers each position's own u and
z columns from the blocks that hold them (`_in_proj_local`), and
autograd sends their gradients back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..distributed.sharding import Parts, constrain
from .layers import CDT, _param, tp_matmul

__all__ = ["MambaState", "Mamba", "mamba_param_axes", "causal_conv",
           "ssm_chunked", "ssm_step", "mamba_apply", "init_mamba_state"]

F32 = torch.float32


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv - 1, d_inner) trailing conv inputs
    ssm: torch.Tensor     # (B, d_inner, d_state) recurrent state (fp32)


class Mamba(nn.Module):
    """The JAX leaves `in_proj` (d, 2·di), `conv_w` (d_conv, di), `conv_b`,
    `x_proj` (di, dt_rank + 2·ds), `dt_proj_w` (dt_rank, di), `dt_proj_b`,
    `A_log` (di, ds), `D` and `out_proj` (di, d). The projections are
    N(0, 0.02²) from `generator`; the rest take the JAX package's fixed
    init: conv_b 0, dt_proj_b -4.6 (softplus ~ 0.01), A_log = log(n) for
    n = 1..ds (S4D-real), D 1."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None):
        super().__init__()
        d, di, ds, dtr = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
        self.in_proj = _param((d, 2 * di), generator, device)
        self.conv_w = _param((cfg.d_conv, di), generator, device)
        self.conv_b = nn.Parameter(torch.zeros(di, device=device))
        self.x_proj = _param((di, dtr + 2 * ds), generator, device)
        self.dt_proj_w = _param((dtr, di), generator, device)
        self.dt_proj_b = nn.Parameter(torch.full((di,), -4.6, device=device))
        n = torch.arange(1, ds + 1, dtype=F32, device=device)
        self.A_log = nn.Parameter(torch.log(n).expand(di, ds).clone())
        self.D = nn.Parameter(torch.ones(di, device=device))
        self.out_proj = _param((di, d), generator, device)

    def forward(self, x, cfg: ArchConfig, state=None, *, decode=False):
        return mamba_apply(self, x, cfg, state, decode=decode)


def mamba_param_axes() -> dict:
    """Logical sharding axes of each `Mamba` leaf (d_inner over the
    tensor-parallel axis), as the JAX package's."""
    return {
        "in_proj": ("d_model", "d_inner"),
        "conv_w": (None, "d_inner"),
        "conv_b": ("d_inner",),
        "x_proj": ("d_inner", None),
        "dt_proj_w": (None, "d_inner"),
        "dt_proj_b": ("d_inner",),
        "A_log": ("d_inner", None),
        "D": ("d_inner",),
        "out_proj": ("d_inner", "d_model"),
    }


def causal_conv(x, w, b, tail=None):
    """Depthwise causal conv over time. x: (B, L, di), w: (K, di) fp32.
    `tail`: (B, K-1, di) inputs carried from the previous segment, or
    zeros at the start. Returns (the conv output in x's dtype, the new
    tail)."""
    K = w.shape[0]
    B, L, di = x.shape
    if tail is None:
        tail = x.new_zeros((B, K - 1, di))
    xc = torch.cat([tail, x], dim=1)                    # (B, L+K-1, di)
    out = torch.zeros((B, L, di), dtype=F32, device=x.device)
    for k in range(K):                                  # K taps
        out = out + xc[:, k:k + L].to(F32) * w[k]
    new_tail = xc[:, L:] if K > 1 else x.new_zeros((B, 0, di))
    return (out + b).to(x.dtype), new_tail


def _combine(a1, b1, a2, b2):
    """(a2, b2) ∘ (a1, b1) = (a1·a2, a2·b1 + b2): a1, b1 the earlier."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """Along dim 1: even[0], odd[0], even[1], ... (len(even) - len(odd)
    is 0 or 1)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2)
    both = both.reshape(even.shape[0], 2 * n, *even.shape[2:])
    return torch.cat([both, even[:, n:]], dim=1)


def _assoc_scan(a, b):
    """Inclusive scan of the affine maps (a_t, b_t) along dim 1, by the
    pairwise recursion of `jax.lax.associative_scan`."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def ssm_chunked(u, delta, A, Bm, Cm, D, h0, chunk: int):
    """Selective scan in chunks of `chunk` (the last may be shorter).
    u/delta: (B, L, di); Bm/Cm: (B, L, ds); A: (di, ds) negative reals; D:
    (di,); h0: (B, di, ds) fp32. Returns (y (B, L, di) fp32, h_L)."""
    L = u.shape[1]
    u, delta, Bm, Cm = (t.to(F32) for t in (u, delta, Bm, Cm))
    h, ys = h0, []
    for s in range(0, L, chunk):
        uc, dc = u[:, s:s + chunk], delta[:, s:s + chunk]
        Bc, Cc = Bm[:, s:s + chunk], Cm[:, s:s + chunk]
        dA = torch.exp(dc[..., None] * A)               # (B, c, di, ds)
        dBu = (dc * uc)[..., None] * Bc[:, :, None, :]  # (B, c, di, ds)
        a_cum, b_cum = _assoc_scan(dA, dBu)
        hs = a_cum * h[:, None] + b_cum
        ys.append((hs * Cc[:, :, None, :]).sum(dim=-1))  # (B, c, di)
        h = hs[:, -1]
    return torch.cat(ys, dim=1) + u * D, h


def ssm_step(u, delta, A, Bm, Cm, D, h):
    """One decode step. u/delta: (B, di); Bm/Cm: (B, ds); h: (B, di,
    ds)."""
    dA = torch.exp(delta[..., None] * A)
    dBu = (delta * u)[..., None] * Bm[:, None, :]
    h = dA * h + dBu
    y = (h * Cm[:, None, :]).sum(dim=-1) + u * D
    return y, h


def _fp32_matmul(a, b):
    """a @ b of float32 operands, in float64 rounded to float32: at least
    a float32 product's accuracy whatever the TF32 flag says ((B·L,
    dt_rank) x (dt_rank, d_inner), cheap in float64)."""
    return (a.double() @ b.double()).float()


def mamba_apply(m: Mamba, x, cfg: ArchConfig, state: MambaState | None = None,
                *, decode: bool = False):
    """x: (B, L, d_model) bf16 -> (y, new MambaState).

    Full sequence (training, prefill): decode=False; `state` is the
    initial state (None: zeros). Decode: L == 1 and `state` given.
    `state` is a `MambaState` or any (conv, ssm) pair.
    """
    if isinstance(x, Parts):
        return _mamba_tp(m, x, cfg, state, decode)
    B, L, _ = x.shape
    di, ds, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank
    xz = x @ m.in_proj.to(CDT)                          # (B, L, 2di)
    u, z = xz.split(di, dim=-1)
    tail = state[0] if state is not None else None
    u_conv, new_tail = causal_conv(u, m.conv_w.to(F32), m.conv_b, tail)
    u_conv = F.silu(u_conv.to(F32)).to(CDT)
    proj = u_conv @ m.x_proj.to(CDT)                    # (B, L, dtr+2ds)
    dt, Bm, Cm = proj.to(F32).split([dtr, ds, ds], dim=-1)
    delta = F.softplus(_fp32_matmul(dt, m.dt_proj_w) + m.dt_proj_b)
    A = -torch.exp(m.A_log)                             # (di, ds)
    h0 = (state[1] if state is not None
          else torch.zeros((B, di, ds), dtype=F32, device=x.device))
    if decode:
        y, h = ssm_step(u_conv[:, 0].to(F32), delta[:, 0], A, Bm[:, 0],
                        Cm[:, 0], m.D, h0)
        y = y[:, None]
    else:
        y, h = ssm_chunked(u_conv, delta, A, Bm, Cm, m.D, h0,
                           min(cfg.mamba_chunk, L))
    y = y.to(CDT) * F.silu(z.to(F32)).to(CDT)
    return y @ m.out_proj.to(CDT), MambaState(new_tail, h)


def _in_proj_local(w: Parts, di: int) -> Parts:
    """`in_proj` (d, 2·di), placed one block of columns a position, as
    each position's own (u, z) columns: its d_inner slice of u, then of
    z, gathered onto its device from the blocks that hold them."""
    if w.layout != 1:
        return w
    M, blk = len(w), w[0].shape[1]
    dl = di // M

    def cols(lo, hi, dev):
        pieces = [w[s][:, max(lo, s * blk) - s * blk:
                       min(hi, (s + 1) * blk) - s * blk].to(dev)
                  for s in range(M) if max(lo, s * blk) < min(hi, (s + 1)
                                                              * blk)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
    return w.like([torch.cat([cols(j * dl, (j + 1) * dl, d),
                              cols(di + j * dl, di + (j + 1) * dl, d)], dim=1)
                   for j, d in enumerate(w.devices)])


def _mamba_tp(m: Mamba, x: Parts, cfg: ArchConfig, state=None,
              decode: bool = False) -> tuple[Parts, MambaState]:
    """The full-sequence pass or a decode step over `Parts`, d_inner
    split over `model` where the rules split it (else every position
    runs it whole); `state` and the returned state are `Parts` of each
    position's d_inner slice of the conv tail (B, d_conv - 1, di) and the
    SSM state (B, di, ds)."""
    B, L, _ = x[0].shape
    ds, dtr = cfg.d_state, cfg.dt_rank
    # each position's (u, z) columns: what the JAX constrain of xz over
    # d_inner and the split into u and z mean
    xz = tp_matmul(x, _in_proj_local(m.in_proj, cfg.d_inner))
    dl = xz[0].shape[-1] // 2
    u = xz.map(lambda t: t[..., :dl])
    z = xz.map(lambda t: t[..., dl:])
    tails = list(state[0]) if state is not None else [None] * len(u)
    conv = [causal_conv(t, w.to(F32), b, tail)
            for t, w, b, tail in zip(u, m.conv_w, m.conv_b, tails)]
    u_conv = u.like([c[0] for c in conv])
    u_conv = u_conv.map(lambda t: F.silu(t.to(F32)).to(CDT))
    u_conv = constrain(u_conv, "batch", None, "d_inner")
    proj = constrain(tp_matmul(u_conv, m.x_proj), "batch", None, None)
    h0s = list(state[1]) if state is not None else [None] * len(u)

    def scan(uc, pr, w_dt, b_dt, a_log, D, h0):
        dt, Bm, Cm = pr.to(F32).split([dtr, ds, ds], dim=-1)
        delta = F.softplus(_fp32_matmul(dt, w_dt) + b_dt)
        A = -torch.exp(a_log)
        if h0 is None:
            h0 = torch.zeros((B, uc.shape[-1], ds), dtype=F32,
                             device=uc.device)
        if decode:
            y, h = ssm_step(uc[:, 0].to(F32), delta[:, 0], A, Bm[:, 0],
                            Cm[:, 0], D, h0)
            return y[:, None], h
        return ssm_chunked(uc, delta, A, Bm, Cm, D, h0,
                           min(cfg.mamba_chunk, L))
    ys = [scan(*args) for args in zip(u_conv, proj, m.dt_proj_w,
                                      m.dt_proj_b, m.A_log, m.D, h0s)]
    y = u_conv.like([t[0] for t in ys]).map(
        lambda a, zz: a.to(CDT) * F.silu(zz.to(F32)).to(CDT), z, dtype=CDT)
    y = constrain(y, "batch", None, "d_inner")
    split = u.layout == 2
    new = MambaState(u.like([c[1] for c in conv], 2 if split else "whole"),
                     u.like([t[1] for t in ys], 1 if split else "whole",
                            F32))
    return constrain(tp_matmul(y, m.out_proj), "batch", None, None), new


def init_mamba_state(cfg: ArchConfig, batch: int, device=None) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=CDT,
                         device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=F32,
                        device=device))
