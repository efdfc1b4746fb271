"""Flash attention, forward and backward: three CUDA kernels, their plain
versions, and the `torch.autograd.Function` that joins them.

Replaces the TPU kernels `src/repro/kernels/flash_attention.py`:
`flash_fwd` (body `_fwd_kernel`) and `flash_bwd` (bodies `_bwd_dq_kernel`
and `_bwd_dkv_kernel`), and the JAX package's `ops.flash_attention`
custom_vjp (`_flash_fwd_rule`, `_flash_bwd_rule`).

Layout, as in the JAX package: heads folded into the leading axis. q is
(BH, Sq, D), k/v are (BHkv, Skv, D), g = Hq // Hkv, and q row b reads kv
row b // g. What is computed, exactly as the TPU kernels do:

- scores in fp32 from inputs cast to fp32, `* scale`, then the softcap
  `cap·tanh(s/cap)`;
- the mask from global positions: causal `kpos <= qpos` (no diagonal
  offset when Sq != Skv) and the window `kpos > qpos - window`; masked
  scores are `NEG_INF = -1e30`;
- forward: online softmax with an `alive` guard for rows that see no key,
  `o = acc / max(l, 1e-30)` in q's dtype, `lse = m + log(max(l, 1e-30))`
  in fp32 (a fully masked row gives o = 0);
- backward: `delta = sum(do·o)` in fp32 from the rounded `o` (computed
  outside the kernels, `flash_delta`), `p = exp(s - lse)` masked,
  `ds = p·(dp - delta)`, times `1 - (s/cap)²` under a softcap, times
  `scale`; dq = ds·k, dk = dsᵀ·q, dv = pᵀ·do.

The plain versions compute over the whole KV axis at once (online softmax
is exact), in chunks of rows so that no score tensor passes 64 M elements.
The kernels (`csrc/flash_attention.cu`) walk 64-row tiles and sum in fp32
in their own order. `flash_bwd_dkv` sums dk/dv over each GQA group in
fp32 and writes (BHkv, Skv, D) in k's dtype; the JAX wrapper rounds each
q head's dk/dv to k's dtype before it sums the group, so the two differ by
that rounding only. `flash_bwd_plain` keeps the JAX kernel's per-q-head
outputs for the parity tests.

The JAX wrapper pads the sequence axes to 512-row blocks (`_pad_seq`), a
TPU layout artifact, and masks the padded keys with its `kv_len` tail;
the port pads nothing, so it has no `kv_len`: the kernels mask the ragged
edges (Sq, Skv) themselves. `FlashAttention` folds (B, S, H, D) into
(BH, S, D) with one copy per operand. The kernels take bf16, the model's
compute type; the plain versions take any float type.

On CPU tensors a wrapper runs the plain version; on CUDA tensors it
launches its kernel or raises.
"""
from __future__ import annotations

import torch

from . import build

NEG_INF = -1e30
_CHUNK_ELEMS = 1 << 26          # score elements per chunk of a plain version
MAX_HEAD_DIM = 128


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, scale, softcap):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    return s


def flash_mask(Sq, Skv, causal, window, device):
    """(Sq, Skv) bool: which keys each query sees."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


def _chunks(n_rows: int, per_row: int):
    """[lo, hi) ranges over n_rows rows, at most _CHUNK_ELEMS // per_row
    rows each (one at least)."""
    step = max(1, _CHUNK_ELEMS // max(per_row, 1))
    for lo in range(0, n_rows, step):
        yield lo, min(n_rows, lo + step)


def flash_delta(o, do):
    """delta = sum(do · o) over D, in fp32: (BH, Sq)."""
    return (do.float() * o.float()).sum(-1)


def flash_fwd_plain(q, k, v, *, g: int, scale: float, causal: bool,
                    window: int = 0, softcap: float = 0.0):
    """-> (o (BH, Sq, D) in q's dtype, lse (BH, Sq) fp32)."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    ok = flash_mask(Sq, Skv, causal, window, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    for lo, hi in _chunks(BH, Sq * Skv):
        rows = torch.arange(lo, hi, device=q.device) // g
        kk, vv = k[rows], v[rows]
        s = torch.where(ok, _scores(q[lo:hi], kk, scale, softcap), neg)
        m = torch.maximum(s.amax(-1), neg) if Skv else \
            neg.expand(hi - lo, Sq)
        alive = m > NEG_INF / 2
        p = torch.where(alive[..., None], torch.exp(s - m[..., None]), 0.0)
        safe_l = torch.clamp_min(p.sum(-1), 1e-30)
        acc = torch.matmul(p, vv.float())
        o[lo:hi] = (acc / safe_l[..., None]).to(q.dtype)
        lse[lo:hi] = m + torch.log(safe_l)
    return o, lse


def _bwd_terms(q, kk, vv, do, lse, delta, ok, scale, softcap):
    """p and ds (fp32) of one chunk of q rows against their kv rows."""
    s = _scores(q, kk, scale, softcap)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), vv.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - (s / softcap) ** 2)
    return p, ds * scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, g: int, scale: float,
                       causal: bool, window: int = 0,
                       softcap: float = 0.0):
    """-> dq (BH, Sq, D) in q's dtype."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    ok = flash_mask(Sq, Skv, causal, window, q.device)
    dq = torch.empty_like(q)
    for lo, hi in _chunks(BH, Sq * Skv):
        rows = torch.arange(lo, hi, device=q.device) // g
        kk = k[rows]
        _p, ds = _bwd_terms(q[lo:hi], kk, v[rows], do[lo:hi], lse[lo:hi],
                            delta[lo:hi], ok, scale, softcap)
        dq[lo:hi] = torch.matmul(ds, kk.float()).to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, g: int, scale: float,
                        causal: bool, window: int = 0,
                        softcap: float = 0.0):
    """-> (dk, dv), each (BHkv, Skv, D) in k's dtype: the per-q-head
    gradients summed over each GQA group in fp32."""
    BH, Sq, D = q.shape
    BHkv, Skv, _ = k.shape
    ok = flash_mask(Sq, Skv, causal, window, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for lo, hi in _chunks(BHkv, g * Sq * Skv):
        qs = slice(lo * g, hi * g)
        rows = torch.arange(lo * g, hi * g, device=q.device) // g
        p, ds = _bwd_terms(q[qs], k[rows], v[rows], do[qs], lse[qs],
                           delta[qs], ok, scale, softcap)
        dk_h = torch.matmul(ds.transpose(-1, -2), q[qs].float())
        dv_h = torch.matmul(p.transpose(-1, -2), do[qs].float())
        dk[lo:hi] = dk_h.reshape(hi - lo, g, Skv, D).sum(1).to(k.dtype)
        dv[lo:hi] = dv_h.reshape(hi - lo, g, Skv, D).sum(1).to(v.dtype)
    return dk, dv


def flash_bwd_plain(q, k, v, o, lse, do, *, g: int, scale: float,
                    causal: bool, window: int = 0, softcap: float = 0.0):
    """The JAX package's `flash_bwd` in full: -> (dq (BH, Sq, D),
    dk_h (BH, Skv, D), dv_h (BH, Skv, D)), dk/dv per q head in k's dtype
    (the caller sums each group)."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    delta = flash_delta(o, do)
    ok = flash_mask(Sq, Skv, causal, window, q.device)
    dq = torch.empty_like(q)
    dk = torch.empty((BH, Skv, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((BH, Skv, D), dtype=v.dtype, device=v.device)
    for lo, hi in _chunks(BH, Sq * Skv):
        rows = torch.arange(lo, hi, device=q.device) // g
        kk = k[rows]
        p, ds = _bwd_terms(q[lo:hi], kk, v[rows], do[lo:hi], lse[lo:hi],
                           delta[lo:hi], ok, scale, softcap)
        dq[lo:hi] = torch.matmul(ds, kk.float()).to(q.dtype)
        dk[lo:hi] = torch.matmul(ds.transpose(-1, -2),
                                 q[lo:hi].float()).to(k.dtype)
        dv[lo:hi] = torch.matmul(p.transpose(-1, -2),
                                 do[lo:hi].float()).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check(name, q, k, v, do, lse, delta, g):
    """The shapes, dtypes and contiguity the kernels take (do, lse and
    delta None for the forward); raises on anything else."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be (BH, Sq, D) and k/v (BHkv, "
                         f"Skv, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, Sq, D = q.shape
    if k.shape[2] != D or g < 1 or k.shape[0] * g != BH:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not fit g={g}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} outside 1..{MAX_HEAD_DIM}")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    for t in (q, k, v, do):
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: q, k, v and do must be bfloat16, got "
                            f"{t.dtype}")
    for t in (lse, delta):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (BH, Sq)):
            raise ValueError(f"{name}: lse and delta must be float32 "
                             f"{(BH, Sq)}, got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v, do, lse, delta)
               if t is not None):
        raise ValueError(f"{name}: operands must be contiguous")


def _scalars(g, scale, causal, window, softcap):
    return (g, int(bool(causal)), int(window or 0), float(scale),
            float(softcap or 0.0))


def flash_fwd(q, k, v, *, g: int, scale: float, causal: bool,
              window: int = 0, softcap: float = 0.0):
    """GQA flash attention forward -> (o (BH, Sq, D) in q's dtype,
    lse (BH, Sq) fp32). Operands as in `flash_fwd_plain`; on the card
    q/k/v are contiguous bf16 and D <= 128."""
    kw = dict(g=g, scale=scale, causal=causal, window=window,
              softcap=softcap)
    if build.route("flash_fwd", q, k, v) == "cpu":
        return flash_fwd_plain(q, k, v, **kw)
    _check("flash_fwd", q, k, v, None, None, None, g)
    BH, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    g, causal, window, scale, softcap = _scalars(**kw)
    build.launch(
        "flash_fwd", "rt_flash_fwd", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, Sq, k.shape[1], D,
        g, causal, window, scale, softcap)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, g: int, scale: float,
                 causal: bool, window: int = 0, softcap: float = 0.0):
    """dq (BH, Sq, D) in q's dtype. do is (BH, Sq, D) in q's dtype; lse
    and delta are (BH, Sq) float32."""
    kw = dict(g=g, scale=scale, causal=causal, window=window,
              softcap=softcap)
    if build.route("flash_bwd_dq", q, k, v, do, lse, delta) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    _check("flash_bwd_dq", q, k, v, do, lse, delta, g)
    BH, Sq, D = q.shape
    dq = torch.empty_like(q)
    g, causal, window, scale, softcap = _scalars(**kw)
    build.launch(
        "flash_bwd_dq", "rt_flash_bwd_dq", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), BH, Sq, k.shape[1], D, g, causal,
        window, scale, softcap)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, g: int, scale: float,
                  causal: bool, window: int = 0, softcap: float = 0.0):
    """(dk, dv), each (BHkv, Skv, D) in k's dtype, summed over each GQA
    group in fp32. Operands as in `flash_bwd_dq`."""
    kw = dict(g=g, scale=scale, causal=causal, window=window,
              softcap=softcap)
    if build.route("flash_bwd_dkv", q, k, v, do, lse, delta) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    _check("flash_bwd_dkv", q, k, v, do, lse, delta, g)
    BH, Sq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    g, causal, window, scale, softcap = _scalars(**kw)
    build.launch(
        "flash_bwd_dkv", "rt_flash_bwd_dkv", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Sq, k.shape[1],
        D, g, causal, window, scale, softcap)
    return dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _fold(x):
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


def _unfold(x, B: int, H: int):
    BH, S, D = x.shape
    return x.reshape(B, H, S, D).transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """GQA flash attention on (B, S, H, D) operands: forward through
    `flash_fwd`, backward through `flash_bwd_dq` and `flash_bwd_dkv`.
    Saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        B, Sq, Hq, D = q.shape
        Hkv = k.shape[2]
        if Hq % Hkv:
            raise ValueError(f"flash attention: {Hq} query heads do not "
                             f"group over {Hkv} KV heads")
        kw = dict(g=Hq // Hkv,
                  scale=1.0 / (D ** 0.5) if scale is None else scale,
                  causal=causal, window=window, softcap=softcap)
        o2, lse = flash_fwd(_fold(q), _fold(k), _fold(v), **kw)
        o = _unfold(o2, B, Hq)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        B, _Sq, Hq, _D = q.shape
        Hkv = k.shape[2]
        qf, kf, vf, of = _fold(q), _fold(k), _fold(v), _fold(o)
        dof = _fold(do.to(q.dtype))
        delta = flash_delta(of, dof)
        dq = flash_bwd_dq(qf, kf, vf, dof, lse, delta, **ctx.kw)
        dk, dv = flash_bwd_dkv(qf, kf, vf, dof, lse, delta, **ctx.kw)
        return (_unfold(dq, B, Hq), _unfold(dk, B, Hkv),
                _unfold(dv, B, Hkv), None, None, None, None)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    """Flash attention with GQA. q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D).
    Returns (B, Sq, Hq, D) in q's dtype; differentiable in q, k and v.
    `scale` defaults to 1/sqrt(D). The port's `ops.flash_attention`."""
    return FlashAttention.apply(q, k, v, bool(causal), int(window or 0),
                                float(softcap or 0.0), scale)
