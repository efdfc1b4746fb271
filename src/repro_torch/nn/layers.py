"""Layers of the model stacks: RMS norm, rotary embeddings, the gated MLP,
GQA attention (global or sliding-window self-attention over a dense decode
cache or a `KVSource`, cross-attention over auxiliary K/V, the encoder's
bidirectional attention), the streaming paged attention, and `Block`, one
layer of any kind the configs use: attention, mamba (`nn.mamba`) or
encoder-decoder, with a gated MLP, an MoE FFN (`nn.moe`), both (arctic's
dense residual) or none.

The modules hold float32 parameters in the JAX package's layout (a
projection is `x @ w`, w of shape (in, out)) and compute in bf16 (`CDT`),
casting each weight at use and keeping the softmax and norm sums in fp32,
as `repro.nn.layers` does.

Under `attn_impl="flash"` a full pass (prefill, training, the encoder)
with more than one query goes through
`kernels.flash_attention.flash_attention` (the flash kernels, forward and
backward), causal for self-attention and bidirectional for the encoder
and cross-attention, as `repro.nn.layers._attend` routes it; decode
steps read their caches with the naive attention.

With a `core.context.PIMContext` (`pim_ctx`) whose targets name them, the
MLP's down projection (`mlp_down`) and attention's output projection
(`attn_o`) run on the protected PIM path, from the precoded int8 weights
(`w_down_enc` / `wo_enc` and their `*_alpha` scales, buffers that
`models.lm.encode_params_for_pim` fills) where present, else from the fp
weights ternarized and encoded per call.

Not ported, by design: `attn_impl="standin"`, the JAX package's
cost-lowering tooling (it raises `NotImplementedError`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig, LayerSpec
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import (NEG_INF, paged_softmax_finalize,
                                       paged_softmax_init,
                                       paged_softmax_update)
from .kv_source import KVSource

CDT = torch.bfloat16      # compute dtype
ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu}


def project(x, w, pim_ctx, target: str, enc, alpha):
    """x @ w in bf16, or through `pim_ctx`'s protected PIM path when its
    targets hold `target` (precoded from `enc`/`alpha` when given)."""
    if pim_ctx is not None and target in pim_ctx.targets:
        return pim_ctx.matmul(x, w, target, enc=enc, alpha=alpha)
    return x @ w.to(CDT)


def _pim_buffers(module: nn.Module, weight: str) -> None:
    """Empty slots for a projection's precoded PIM weights: `{weight}_enc`
    (int8) and `{weight}_alpha` (fp32). Buffers, not parameters, so the
    optimizer, `LM.leaves` and checkpoints never see them."""
    module.register_buffer(f"{weight}_enc", None, persistent=False)
    module.register_buffer(f"{weight}_alpha", None, persistent=False)


def _param(shape, generator, device) -> nn.Parameter:
    """N(0, 0.02²) float32 weights from `generator`, or uninitialised ones
    (to be loaded, e.g. by `convert.params_from_arrays`) without it."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, device=device))
    return nn.Parameter(0.02 * torch.randn(shape, generator=generator,
                                           device=device))


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x):
        xf = x.to(torch.float32)
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(CDT)


def rope(x, positions, theta):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs      # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """The gated (SwiGLU family) MLP: act(x·W_gate) ⊙ (x·W_up) · W_down."""

    def __init__(self, d_model: int, d_ff: int, act: str = "silu", *,
                 generator=None, device=None):
        super().__init__()
        self.act = ACTS[act]
        self.w_gate = _param((d_model, d_ff), generator, device)
        self.w_up = _param((d_model, d_ff), generator, device)
        self.w_down = _param((d_ff, d_model), generator, device)
        _pim_buffers(self, "w_down")

    def forward(self, x, pim_ctx=None):
        h = self.act(x @ self.w_gate.to(CDT)) * (x @ self.w_up.to(CDT))
        return project(h, self.w_down, pim_ctx, "mlp_down",
                       self.w_down_enc, self.w_down_alpha)


def _softcap(logits, cap):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def _attend(q, k, v, mask, softcap, *, impl="naive", causal=True,
            window=0):
    """GQA attention. q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D), mask:
    broadcastable to (B,1,Sq,Skv) or None. impl="flash" with Sq > 1 runs
    the flash kernels, the mask given as `causal`/`window`; otherwise the
    naive softmax over the masked logits."""
    B, Sq, Hq, D = q.shape
    if impl == "standin" and Sq > 1:
        raise NotImplementedError(
            "attn_impl='standin' is the JAX package's cost-lowering "
            "tooling, not ported by design")
    if impl == "flash" and Sq > 1:
        return flash_attention(q, k, v, causal, window,
                               float(softcap or 0.0), None)
    G = Hq // k.shape[2]
    qg = q.reshape(B, Sq, k.shape[2], G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    logits = _softcap(logits / torch.tensor(float(D)).sqrt(), softcap)
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(CDT)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, Hq, D)


def attend_paged(q, pages, softcap):
    """Streaming attention over an iterator of decoded KV pages, each
    (k_page (B,T,Hkv,D), v_page, valid_tokens): one online-softmax update
    per page (`kernels.paged_attention.paged_softmax_update`), equal to
    `_attend` over the concatenated pages. The protected layer's
    reference read path: the plain version of `attend_protected`, so it
    takes CPU tensors only (on the card the kernel reads the pages)."""
    if q.is_cuda:
        raise ValueError("attend_paged is the plain streaming read of CPU "
                         "tensors; on the card paged K/V is read through "
                         "the attend_protected kernel (fused=True)")
    B, Sq, Hq, D = q.shape
    m = l = acc = None
    for kpg, vpg, valid in pages:
        if m is None:
            Hkv = kpg.shape[2]
            m, l, acc = paged_softmax_init(B, Hkv, Hq // Hkv, Sq, D,
                                           q.device)
        m, l, acc = paged_softmax_update(q, kpg, vpg, valid, m, l, acc,
                                         softcap=float(softcap or 0.0))
    if m is None:
        raise ValueError("paged attention needs at least one KV page")
    return paged_softmax_finalize(q, m, l, acc)


class Attention(nn.Module):
    """GQA attention: wq (d, Hq·D), wk/wv (d, Hkv·D), wo (Hq·D, d)."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        self.wq = _param((d, hq * dh), generator, device)
        self.wk = _param((d, hkv * dh), generator, device)
        self.wv = _param((d, hkv * dh), generator, device)
        self.wo = _param((hq * dh, d), generator, device)
        _pim_buffers(self, "wo")

    def out_proj(self, out, pim_ctx):
        return project(out, self.wo, pim_ctx, "attn_o", self.wo_enc,
                       self.wo_alpha)

    def project_kv(self, x, cfg: ArchConfig, positions):
        """(B, S, d) -> RoPE'd K and V, each (B, S, Hkv, D) in bf16."""
        B, S, _ = x.shape
        shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
        k = (x @ self.wk.to(CDT)).reshape(shape)
        v = (x @ self.wv.to(CDT)).reshape(shape)
        return rope(k, positions, cfg.rope_theta), v

    def cross_kv(self, aux, cfg: ArchConfig):
        """Cross-attention K/V of auxiliary embeddings (B, Na, d): each
        (B, Na, Hkv, D) bf16, without RoPE (the JAX package's
        `_cross_kv`)."""
        B, Na, _ = aux.shape
        aux = aux.to(CDT)
        shape = (B, Na, cfg.n_kv_heads, cfg.head_dim)
        return ((aux @ self.wk.to(CDT)).reshape(shape),
                (aux @ self.wv.to(CDT)).reshape(shape))

    def encode(self, x, cfg: ArchConfig, positions):
        """Bidirectional self-attention (the whisper encoder's
        `encoder_attention_apply`): (B, S, d) -> (B, S, d), RoPE'd q and
        k, no mask, no PIM path."""
        B, S, _ = x.shape
        hq, dh = cfg.n_heads, cfg.head_dim
        q = rope((x @ self.wq.to(CDT)).reshape(B, S, hq, dh), positions,
                 cfg.rope_theta)
        k, v = self.project_kv(x, cfg, positions)
        out = _attend(q, k, v, None, cfg.softcap_attn, impl=cfg.attn_impl,
                      causal=False)
        return out.reshape(B, S, hq * dh) @ self.wo.to(CDT)

    def forward(self, x, spec: LayerSpec, cfg: ArchConfig, *, positions,
                kv_cache=None, cache_pos=None, aux_kv=None, pim_ctx=None):
        """Cross-attention (`spec.cross`): q (no RoPE) against the given
        `aux_kv` = (k, v), every key visible; returns (y, None).
        Self-attention prefill (kv_cache None): causal full pass, returns
        (y, None). Decode: a dense {"k", "v"} (B, Smax, Hkv, D) cache is
        written at `cache_pos` in place (a ring of size `local_window` for
        sliding layers) and returned; a `KVSource` appends the token's K/V
        and serves the read through its `attend`. `wo` runs on `pim_ctx`'s
        protected path where it targets "attn_o"."""
        B, S, _ = x.shape
        hq, dh = cfg.n_heads, cfg.head_dim
        q = (x @ self.wq.to(CDT)).reshape(B, S, hq, dh)
        if spec.cross:
            k, v = aux_kv
            out = _attend(q, k, v, None, cfg.softcap_attn,
                          impl=cfg.attn_impl, causal=False,
                          window=spec.local_window)
            return self.out_proj(out.reshape(B, S, hq * dh), pim_ctx), None
        q = rope(q, positions, cfg.rope_theta)
        k, v = self.project_kv(x, cfg, positions)
        if isinstance(kv_cache, KVSource):
            kv_cache.append(k, v)
            out = kv_cache.attend(q, cfg.softcap_attn)
            return self.out_proj(out.reshape(B, S, hq * dh), pim_ctx), None

        new_cache = None
        if kv_cache is not None:
            W = kv_cache["k"].shape[1]
            slot = int(cache_pos) % W
            kv_cache["k"][:, slot:slot + S] = k
            kv_cache["v"][:, slot:slot + S] = v
            new_cache = kv_cache
            k, v = kv_cache["k"], kv_cache["v"]
            kv_pos = torch.arange(W, device=x.device)
            ok = kv_pos <= cache_pos                   # ring full: all True
            if spec.local_window and spec.local_window < W:
                ok &= kv_pos > cache_pos - spec.local_window
            mask = ok[None, None, None, :]             # (1, 1, 1, W)
        elif cfg.attn_impl == "flash" and S > 1:
            mask = None                    # the kernels mask by position
        else:
            pos = torch.arange(S, device=x.device)
            ok = pos[None, :] <= pos[:, None]
            if spec.local_window:
                ok &= pos[None, :] > pos[:, None] - spec.local_window
            mask = ok[None, None]
        impl = cfg.attn_impl if kv_cache is None else "naive"
        out = _attend(q, k, v, mask, cfg.softcap_attn, impl=impl,
                      causal=True, window=spec.local_window)
        return self.out_proj(out.reshape(B, S, hq * dh), pim_ctx), new_cache


_SELF = LayerSpec(kind="attn")
_CROSS = LayerSpec(kind="attn", cross=True)


class Block(nn.Module):
    """One pre-norm layer, by `spec.kind` (the JAX package's
    `_init_block` / `_apply_block`, with its subtree names):

    - "attn": `norm1`, `attn` (self-attention, or cross-attention over
      `aux` where `spec.cross`);
    - "mamba": `norm1`, `mamba`;
    - "encdec" (the whisper decoder): `norm1`, `attn` (self), `norm_x`,
      `xattn` (cross over the encoder's output);

    then the FFN where the layer has one: `norm2` and `mlp` (a gated
    MLP), `moe` (an MoE FFN), or both (`dense_residual`, arctic; only
    the MLP takes `pim_ctx`). A mamba layer of a config without `d_ff`
    and without MoE has none."""

    def __init__(self, spec: LayerSpec, cfg: ArchConfig, *, generator=None,
                 device=None):
        super().__init__()
        from .mamba import Mamba
        from .moe import MoE
        kw = dict(generator=generator, device=device)
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if spec.kind == "mamba":
            self.mamba = Mamba(cfg, **kw)
        else:
            self.attn = Attention(cfg, **kw)
        if spec.kind == "encdec":
            self.norm_x = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
            self.xattn = Attention(cfg, **kw)
        if spec.moe or cfg.d_ff > 0 or spec.kind == "encdec":
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
            if spec.moe:
                self.moe = MoE(cfg, cfg.expert_d_ff or cfg.d_ff, **kw)
            if not spec.moe or spec.dense_residual:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)

    def ffn(self, h, spec: LayerSpec, cfg: ArchConfig, pim_ctx=None):
        if spec.moe:
            y = self.moe(h, cfg)
            if spec.dense_residual:
                y = y + self.mlp(h, pim_ctx)
            return y
        return self.mlp(h, pim_ctx)

    def _aux_kv(self, attn: Attention, aux, cache, cfg: ArchConfig):
        """The cached cross K/V where the cache holds them, else `aux`'s."""
        if cache is not None and "ck" in cache:
            return cache["ck"], cache["cv"]
        if aux is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             "`aux` (or caches holding its K/V)")
        return attn.cross_kv(aux, cfg)

    def forward(self, x, spec: LayerSpec, cfg: ArchConfig, *, positions,
                aux=None, cache=None, cache_pos=None, pim_ctx=None):
        """Returns (x, new_cache). new_cache: a mamba layer's state (its
        full pass's final state, or the decode step's); a self-attention
        layer's dense cache written in place; cross K/V (`ck`, `cv`) when
        decoding; None for prefill attention and `KVSource` caches."""
        new_cache: dict | None = None
        if spec.kind == "mamba":
            state = ((cache["conv"], cache["ssm"]) if cache is not None
                     else None)
            y, st = self.mamba(self.norm1(x), cfg, state,
                               decode=cache is not None)
            x = x + y
            new_cache = {"conv": st.conv, "ssm": st.ssm}
        elif spec.kind == "encdec":
            kv = ({"k": cache["k"], "v": cache["v"]} if cache is not None
                  else None)
            y, new_cache = self.attn(self.norm1(x), _SELF, cfg,
                                     positions=positions, kv_cache=kv,
                                     cache_pos=cache_pos, pim_ctx=pim_ctx)
            x = x + y
            aux_kv = self._aux_kv(self.xattn, aux, cache, cfg)
            yx, _ = self.xattn(self.norm_x(x), _CROSS, cfg,
                               positions=positions, aux_kv=aux_kv,
                               pim_ctx=pim_ctx)
            x = x + yx
            if cache is not None:
                new_cache = dict(new_cache or {}, ck=aux_kv[0],
                                 cv=aux_kv[1])
        elif spec.cross:
            aux_kv = self._aux_kv(self.attn, aux, cache, cfg)
            y, _ = self.attn(self.norm1(x), spec, cfg, positions=positions,
                             aux_kv=aux_kv, pim_ctx=pim_ctx)
            x = x + y
            if cache is not None:
                new_cache = {"ck": aux_kv[0], "cv": aux_kv[1]}
        else:
            y, new_cache = self.attn(self.norm1(x), spec, cfg,
                                     positions=positions, kv_cache=cache,
                                     cache_pos=cache_pos, pim_ctx=pim_ctx)
            x = x + y
        if hasattr(self, "norm2"):
            x = x + self.ffn(self.norm2(x), spec, cfg, pim_ctx)
        return x, new_cache
