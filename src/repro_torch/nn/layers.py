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

Under tensor parallelism (`models.lm.ShardWeights` over a mesh whose
`model` axis is larger than 1) the activations and weights are
`distributed.sharding.Parts`, one tensor a model position, and the
layers run at each position with its slices, changing layouts where the
JAX layers call `constrain`:

- `MLP`: `w_gate` and `w_up` split by columns over `d_ff`, `w_down` by
  rows; the down projection's partial sums are added over positions.
- `Attention`: `wq` split by columns (`heads_flat`), `wk`/`wv` likewise
  where the KV heads divide `model` (`kv_flat`), else whole; `wo` by
  rows. Head counts come from the local widths. Where the query heads
  divide `model` each position attends over its own heads, reading
  from replicated K/V projections only the KV heads its query heads
  use (repeated where a group straddles positions); where they do not,
  q is all-gathered and every position attends over all heads, and
  `wo`'s rows take their slice of the output.
- A row-parallel product (`tp_matmul` with a row-split weight) is a
  float32 partial sum at each position (`matmul_f32`: the bf16
  products added in float32, the backward the bf16 product's), added
  over positions in float32 and rounded to bf16 once by `constrain`'s
  all-reduce: it differs from the unsharded bf16 product only in the
  order of the float32 adds.
- Serving: a dense decode cache is `Parts` too (`_write_cache`). Split
  over `kv_heads`, each position writes and reads its heads; split over
  `kv_seq` on `model` (the KV heads do not divide it), q is all-gathered
  and each position's partial softmax over its rows, for every head, is
  merged (`ShardLayout.merge`) into its heads; whole, each position
  holds all of it. With a `pim_ctx`, `wo` and `w_down` split by
  rows run `PIMContext.matmul`'s row-parallel protected path (`project`),
  equal to the unsharded call bit for bit on the same input.

Context parallelism (`long_500k`: the `kv_seq` rule names `data`, or
`pod`, and the batch is whole): each data shard holds its block of
every cache's rows, whether or not `model` splits them too, and a
decode step's attention runs as that split says (`_decode_split`): only
the position that holds slot `pos % W` writes the token (rings too),
each position takes its partial softmax over its rows, and the partials
of every block are merged by log-sum-exp in the `kv_seq` order
(`ShardLayout.merge`, across the data shards), so each shard holds the
same output. The step's `ShardLayout` says which block a position holds
(`distributed.sharding.data_shard`); a plain tensor is one position.

Not ported, by design: `attn_impl="standin"`, the JAX package's
cost-lowering tooling (it raises `NotImplementedError`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig, LayerSpec
from ..distributed.sharding import (Parts, _spec_axes, constrain,
                                    data_shard, relayout, resolve_spec)
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
    targets hold `target` (precoded from `enc`/`alpha` when given). Over
    `Parts` with w split by rows: `tp_matmul`'s float32 partial sums, or
    the row-parallel protected matmul (whole at every position)."""
    if pim_ctx is not None and target in pim_ctx.targets:
        return pim_ctx.matmul(x, w, target, enc=enc, alpha=alpha)
    if isinstance(x, Parts):
        return tp_matmul(x, w)
    return x @ w.to(CDT)


class _MatmulF32(torch.autograd.Function):
    """a @ b of bf16 operands as float32: the products exact, added in
    float32 and not rounded (a row-parallel partial sum). The backward
    is the bf16 product's: the gradient rounded to bf16, bf16 products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        a2 = a.reshape(-1, a.shape[-1])
        if a.is_cuda:          # cuBLAS's bf16 product with a float32 result
            out = torch.mm(a2, b, out_dtype=torch.float32)
        else:
            out = a2.to(torch.float32) @ b.to(torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.T if ctx.needs_input_grad[0] else None
        gb = (a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return ga, gb


def matmul_f32(a, b):
    """a (..., K) @ b (K, N), both bf16, as float32 (`_MatmulF32`)."""
    return _MatmulF32.apply(a, b)


def tp_matmul(x: Parts, w: Parts) -> Parts:
    """x @ w (w cast to bf16) at each model position, `w` a weight's
    `Parts`: whole, split by rows (0) or by columns (1). A row split
    contracts each position's slice of x (sliced here if x is whole) into
    a float32 partial sum (layout "sum"); otherwise x is made whole and
    the product is whole or split by columns like w."""
    last = x[0].ndim - 1
    if w.layout == 0:
        x = relayout(x, last)
        return x.map(lambda t, wt: matmul_f32(t, wt.to(CDT)), w,
                     layout="sum", dtype=CDT)
    x = relayout(x, "whole")
    return x.map(lambda t, wt: t @ wt.to(CDT), w,
                 layout=last if w.layout == 1 else "whole")


def splits(rules: dict, axis: str) -> bool:
    """Whether logical `axis` is split over `model` under `rules`."""
    return "model" in _spec_axes(resolve_spec((axis,), rules)[0])


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
        if isinstance(x, Parts):
            return x.map(lambda t, s: rmsnorm(t, s, self.eps), self.scale,
                         dtype=CDT)
        return rmsnorm(x, self.scale, self.eps)


def rmsnorm(x, scale, eps: float):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(CDT)


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
        if isinstance(x, Parts):
            h = tp_matmul(x, self.w_gate).map(self.act)
            h = h.map(torch.mul, tp_matmul(x, self.w_up))
            h = constrain(h, "batch", None, "d_ff")
            return constrain(project(h, self.w_down, pim_ctx, "mlp_down",
                                     self.w_down_enc, self.w_down_alpha),
                             "batch", None, None)
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
        """(B, S, d) -> RoPE'd K and V, each (B, S, Hkv, D) in bf16. Over
        `Parts`, each position's KV heads where the KV heads split, else
        all of them at every position (what a cache holds)."""
        if isinstance(x, Parts):
            return self._kv_tp(x, cfg, positions, q_split=False)
        B, S, _ = x.shape
        shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
        k = (x @ self.wk.to(CDT)).reshape(shape)
        v = (x @ self.wv.to(CDT)).reshape(shape)
        return rope(k, positions, cfg.rope_theta), v

    def cross_kv(self, aux, cfg: ArchConfig, *, cached: bool = False):
        """Cross-attention K/V of auxiliary embeddings (B, Na, d): each
        (B, Na, Hkv, D) bf16, without RoPE (the JAX package's
        `_cross_kv`). Over `Parts`, each position's KV heads (`cached`:
        those a cache holds, as `project_kv`)."""
        if isinstance(aux, Parts):
            return self._kv_tp(aux.to(CDT), cfg,
                               q_split=False if cached else None)
        B, Na, _ = aux.shape
        aux = aux.to(CDT)
        shape = (B, Na, cfg.n_kv_heads, cfg.head_dim)
        return ((aux @ self.wk.to(CDT)).reshape(shape),
                (aux @ self.wv.to(CDT)).reshape(shape))

    def encode(self, x, cfg: ArchConfig, positions):
        """Bidirectional self-attention (the whisper encoder's
        `encoder_attention_apply`): (B, S, d) -> (B, S, d), RoPE'd q and
        k, no mask, no PIM path."""
        if isinstance(x, Parts):
            return self._tp(x, cfg, positions=positions, causal=False)[0]
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
        protected path where it targets "attn_o". Over `Parts` (tensor
        parallelism) `_tp`, with a dense cache of `Parts` too."""
        if isinstance(x, Parts):
            return self._tp(x, cfg, positions=positions, aux_kv=aux_kv,
                            causal=not spec.cross, window=spec.local_window,
                            kv_cache=kv_cache, cache_pos=cache_pos,
                            pim_ctx=pim_ctx)
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
        if kv_cache is not None and _kv_split() is not None:
            out = _decode_split([q], [kv_cache["k"]], [kv_cache["v"]], [k],
                                [v], cache_pos, spec.local_window,
                                cfg.softcap_attn, False)[0].to(CDT)
            return (self.out_proj(out.reshape(B, S, hq * dh), pim_ctx),
                    kv_cache)
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
            mask = causal_mask(S, spec.local_window, x.device)[None, None]
        impl = cfg.attn_impl if kv_cache is None else "naive"
        out = _attend(q, k, v, mask, cfg.softcap_attn, impl=impl,
                      causal=True, window=spec.local_window)
        return self.out_proj(out.reshape(B, S, hq * dh), pim_ctx), new_cache


    # -- tensor parallelism ------------------------------------------------

    def _tp(self, x: Parts, cfg: ArchConfig, *, positions, aux_kv=None,
            causal: bool = True, window: int = 0, kv_cache=None,
            cache_pos=None, pim_ctx=None) -> tuple[Parts, dict | None]:
        """Attention over `Parts` (the JAX `attention_apply`'s constrain
        sites): self-attention (RoPE'd, causal or not) of x, or cross
        attention over `aux_kv` (each position's K/V heads); -> (y whole,
        the cache). A dense decode cache of `Parts` (`_write_cache`) is
        split over `kv_heads` (each position attends over its heads) or
        whole at every position; where its rows split over positions (of
        this shard or of others), `_decode_split`: q all-gathered where
        `model` splits the rows (each position's partial softmax over
        its rows for every head), else each position's heads. `wo` runs
        on `pim_ctx`'s row-parallel protected path where it targets
        "attn_o"."""
        B, S = x[0].shape[:2]
        q = _heads(tp_matmul(x, self.wq), cfg.head_dim, "heads")
        q = constrain(q, "batch", None, "heads", None)
        ok = None
        if aux_kv is None:
            k, v = self._kv_tp(x, cfg, positions, q_split=q.layout == 2
                               and kv_cache is None)
            q = q.map(lambda t, p: rope(t, p, cfg.rope_theta), positions)
            if kv_cache is not None and _kv_split() is not None:
                ck, cv = kv_cache["k"], kv_cache["v"]
                heads = splits(q.rules, "heads")
                if ck.layout == 1:     # rows over `model`: every head
                    q = relayout(q, "whole")
                else:                  # each position its KV heads
                    k, v = _own_heads(k, q, cfg), _own_heads(v, q, cfg)
                    heads = False
                outs = _decode_split(list(q), list(ck), list(cv), list(k),
                                     list(v), cache_pos, window,
                                     cfg.softcap_attn, heads)
                out = q.like([o.to(CDT) for o in outs],
                             2 if heads else q.layout, CDT)
                return self._tp_out(out, B, S, pim_ctx), kv_cache
            if kv_cache is not None:
                k, v, ok = _write_cache(kv_cache, k, v, cache_pos, window)
        else:
            k, v = aux_kv
        k, v = _own_heads(k, q, cfg), _own_heads(v, q, cfg)
        flash = cfg.attn_impl == "flash" and S > 1 and ok is None

        def attend(qj, kj, vj, okj=None):
            mask = None
            if okj is not None:
                mask = okj[None, None, None, :]
            elif causal and not flash:
                mask = causal_mask(S, window, qj.device)[None, None]
            return _attend(qj, kj, vj, mask, cfg.softcap_attn,
                           impl=cfg.attn_impl if ok is None else "naive",
                           causal=causal, window=window)
        out = q.map(attend, k, v, *(() if ok is None else (ok,)))
        return self._tp_out(out, B, S, pim_ctx), kv_cache

    def _tp_out(self, out: Parts, B: int, S: int, pim_ctx) -> Parts:
        """The attention output (B, S, H, D) at each position -> y whole."""
        out = constrain(out, "batch", None, "heads", None)
        out = out.map(lambda t: t.reshape(B, S, -1),
                      layout=out.layout if out.layout == "whole" else 2)
        return constrain(self.out_proj(out, pim_ctx), "batch", None, None)

    def _kv_tp(self, src: Parts, cfg: ArchConfig, positions=None, *,
               q_split: bool | None = None) -> tuple[Parts, Parts]:
        """Each position's K and V heads of `src` (RoPE'd at `positions`
        where given): its slice where `kv_flat` splits the projections;
        where they are whole and the query heads split, the KV heads its
        query heads use (layout "own"); else all of them."""
        dh = cfg.head_dim
        if q_split is None:
            q_split = splits(src.rules, "heads")
        if self.wk.layout == 1 or not q_split:
            k, v = (_heads(tp_matmul(src, w), dh, "kv_heads")
                    for w in (self.wk, self.wv))
        else:
            B, S = src[0].shape[:2]
            M = len(src)
            sel = [kv_heads_of(j, M, cfg.n_heads, cfg.n_kv_heads)
                   for j in range(M)]

            def proj(w: Parts):
                return src.like([(t @ _head_cols(wj, sel[j], dh).to(CDT))
                                 .reshape(B, S, -1, dh)
                                 for j, (t, wj) in enumerate(zip(src, w))],
                                "own")
            k, v = proj(self.wk), proj(self.wv)
        if positions is not None:
            k = k.map(lambda t, p: rope(t, p, cfg.rope_theta), positions)
        return k, v


def _kv_split():
    """(the step's `ShardLayout`, this shard's index) where the step's KV
    caches split their rows over positions (its `kv_count` > 1), else
    None."""
    shard = data_shard()
    if shard is None or shard[0].layout.kv_count == 1:
        return None
    return shard[0].layout, shard[1]


def _write_rows(cks, cvs, ks, vs, cache_pos, window: int, blocks,
                count: int) -> list:
    """The token's K/V (`ks[j]`, `vs[j]`: (B, S, H, D)) written into each
    position's cache rows (`cks[j]`, `cvs[j]`: (B, Wl, H, D), block
    `blocks[j]` of `count` of the W = Wl·count rows: a ring of W = the
    window for sliding layers) at slot `cache_pos % W`, by the position
    that holds it. Returns each position's visible rows, (Wl,) bool."""
    Wl, S = cks[0].shape[1], ks[0].shape[1]
    W = Wl * count
    slot = int(cache_pos) % W
    oks = []
    for ck, cv, k, v, b in zip(cks, cvs, ks, vs, blocks, strict=True):
        lo = b * Wl
        a, e = max(slot, lo), min(slot + S, lo + Wl)
        if a < e:
            ck[:, a - lo:e - lo] = k[:, a - slot:e - slot]
            cv[:, a - lo:e - lo] = v[:, a - slot:e - slot]
        kv_pos = torch.arange(lo, lo + Wl, device=ck.device)
        ok = kv_pos <= cache_pos                       # ring full: all True
        if window and window < W:
            ok &= kv_pos > cache_pos - window
        oks.append(ok)
    return oks


def _write_cache(cache: dict, k: Parts, v: Parts, cache_pos, window: int):
    """The token's K/V written into a dense cache of `Parts` whose rows do
    not split (`_write_rows`): each position its heads (k and v laid out
    as the cache). Returns (cache k, cache v, each position's visible
    rows)."""
    ck, cv = cache["k"], cache["v"]
    if ck.layout == 1:
        raise ValueError("a KV cache split over its rows needs its step's "
                         "ShardLayout (launch.steps)")
    oks = _write_rows(list(ck), list(cv), list(k), list(v), cache_pos,
                      window, [0] * len(ck), 1)
    return ck, cv, ck.like(oks, "own")


def _partial_softmax(q, k, v, ok, softcap) -> tuple:
    """One position's partial softmax over its cache rows: q (B, Sq, Hq,
    D), k/v (B, Wl, Hkv, D), ok (Wl,) its visible rows -> (m, l, acc) as
    `distributed.sharding.lse_merge` takes them, float32. With no
    visible row m is NEG_INF."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    logits = _softcap(logits / torch.tensor(float(D)).sqrt(), softcap)
    logits = torch.where(ok[None, None, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))

    def heads(t):                       # (B, Hkv, G, Sq, .) -> (B, Sq, Hq, .)
        return t.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, -1)
    return heads(m), heads(p.sum(dim=-1, keepdim=True)), heads(acc)


def _decode_split(qs, cks, cvs, ks, vs, cache_pos, window: int, softcap,
                  heads: bool) -> list:
    """A decode step's attention over caches whose rows split over
    positions (the module docstring): this shard's positions' q, cache
    K/V rows and token K/V, one of each a position. The token is written
    by the position that holds its slot (`_write_rows`), each position
    takes its partial softmax over its rows and `ShardLayout.merge`
    merges every block's in the `kv_seq` order -> each position's output
    (float32): its 1/M block of the heads where `heads` (q holds every
    head), else the heads of its q."""
    layout, k = _kv_split()
    oks = _write_rows(cks, cvs, ks, vs, cache_pos, window,
                      layout.kv_block[k], layout.kv_count)
    stats = [_partial_softmax(q, ck, cv, ok, softcap)
             for q, ck, cv, ok in zip(qs, cks, cvs, oks, strict=True)]
    return layout.merge(stats, heads)


def _own_heads(k: Parts, q: Parts, cfg: ArchConfig) -> Parts:
    """K or V whole at every position, read by query heads split over
    `model`: each position's KV heads (`kv_heads_of`), layout "own"."""
    if k.layout != "whole" or q.layout != 2:
        return k
    M = len(k)
    return k.like([t[:, :, kv_heads_of(j, M, cfg.n_heads, cfg.n_kv_heads)]
                   for j, t in enumerate(k)], "own")


def _heads(t: Parts, dh: int, axis: str) -> Parts:
    """(B, S, H·dh) at each position -> (B, S, H', dh): its own heads
    where the rules split `axis` (heads, kv_heads) over `model` (layout
    2), else all of them (q all-gathered where its columns split)."""
    B, S = t[0].shape[:2]
    if splits(t.rules, axis):
        t = relayout(t, 2)
        return t.map(lambda a: a.reshape(B, S, -1, dh), layout=2)
    t = relayout(t, "whole")
    return t.map(lambda a: a.reshape(B, S, -1, dh), layout="whole")


def kv_heads_of(j: int, M: int, n_heads: int, n_kv: int) -> list[int]:
    """The KV heads that model position j's query heads read (heads
    split evenly over M positions): each once where its query heads form
    whole groups of one size, else one a query head."""
    G = n_heads // n_kv
    lo, hi = j * n_heads // M, (j + 1) * n_heads // M
    need = [h // G for h in range(lo, hi)]
    uniq = sorted(set(need))
    if all(need.count(u) == len(need) // len(uniq) for u in uniq) and \
            len(need) % len(uniq) == 0:
        return uniq
    return need


def _head_cols(w, heads: list[int], dh: int):
    """The columns of heads `heads` of a (d, H·dh) projection."""
    if heads == list(range(heads[0], heads[-1] + 1)):
        return w[:, heads[0] * dh:(heads[-1] + 1) * dh]
    return torch.cat([w[:, h * dh:(h + 1) * dh] for h in heads], dim=1)


def causal_mask(S: int, window: int, device):
    """(S, S) bool: key <= query, within `window` where nonzero."""
    pos = torch.arange(S, device=device)
    ok = pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    return ok


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

    def ffn(self, h, spec: LayerSpec, cfg: ArchConfig, pim_ctx=None,
            split=None):
        if spec.moe:
            y = self.moe(h, cfg, split)
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
                aux=None, cache=None, cache_pos=None, pim_ctx=None,
                split=None):
        """Returns (x, new_cache). new_cache: a mamba layer's state (its
        full pass's final state, or the decode step's); a self-attention
        layer's dense cache written in place; cross K/V (`ck`, `cv`) when
        decoding; None for prefill attention and `KVSource` caches.
        `split` (an `nn.moe.DataSplit`) gives an MoE FFN the dispatch of
        the whole batch that x is one data shard of."""
        new_cache: dict | None = None
        if spec.kind == "mamba":
            state = ((cache["conv"], cache["ssm"]) if cache is not None
                     else None)
            y, st = self.mamba(self.norm1(x), cfg, state,
                               decode=cache is not None)
            x = x + y
            if st is not None:
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
            x = x + self.ffn(self.norm2(x), spec, cfg, pim_ctx, split)
        return x, new_cache
