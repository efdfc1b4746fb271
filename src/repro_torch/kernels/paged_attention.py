"""Protected paged attention: the fused read of the protected KV cache, a
CUDA kernel and its plain version.

Replaces the TPU kernel `src/repro/kernels/paged_attention.py:
attend_protected_pallas` (body `_kernel`, `_dequant_block`, `_update`).
From corrected GF(p) codeword pages and their absmax scales it computes
the attention of a query block over the pages, with the dense hot page
(tokens not yet frozen) last:

  1. slice the `k_info` info symbols of each page and clip the digits
     into the field (uncorrectable words degrade, never index out of
     range);
  2. base-p desymbolize each byte (little-endian digits, mod 256);
  3. recentre the int8 code and multiply by the page's absmax scale;
  4. online softmax over the pages (QKᵀ/√D, optional softcap, per-row
     valid counts, GQA), accumulating ·V;
  5. write acc / l.

Page step j holds S sub-pages of `page_shape` = (Bsub, T, Hkv, D) stacked
along the batch (S·Bsub = B): S = 1 for one request batch's layer, S = B
for per-slot pages.

The plain functions here mirror the JAX package's oracle
(`kernels/ref.py`: `paged_softmax_init/update/finalize`, `dequant_gf_page`,
`attend_protected_ref`): dequantized pages are rounded to the hot page's
dtype (bf16) and the QKᵀ product on bf16 operands rounds to bf16, as the
unfused streaming read does. The CUDA kernel (`csrc/paged_attention.cu`)
rounds at the same places and sums in fp32 in its own order, so it agrees
with the plain version to a few bf16 ulps (the card tests hold it to
rtol 2^-7, atol 2^-10), not bitwise. The TPU kernel keeps K/V and the
logits in fp32 instead.

The CUDA kernel splits the page walk over the grid (flash-decoding): a
CTA per (batch row, KV head, range of pages) runs the online softmax over
its range and writes the partial (m, l, acc); a second small kernel
merges the ranges in order, applies the hot page last and finalizes. The
pages a range and a softmax step take come from `attend_plan`: ranges are
sized so that max(NP, ref_pages) pages fill one wave of CTAs. A caller
whose rows hold different page counts (per-slot pages) passes a bound on
NP that does not change between calls, such as its max_seq in pages: a
row's ranges are then the same whatever the other rows hold, and a row's
pages past its own (valid 0) only add ranges that the merge weighs by
exactly 0. So a serving slot's output does not depend on the
other slots' page counts, to the bit. The ranges never outnumber the
CTAs of one wave, so the merge's shared memory does not grow with NP and
the kernel takes any NP. No atomics: a call is bitwise repeatable. Each
CTA copies the info columns of the words its (row, head) slice covers
into shared memory (16-byte copies, the next page's in flight) and
assembles each element's digits from there.

Bound on the card: bytes (the info digits of K and V once); see the note
in `csrc/paged_attention.cu`.

The JAX wrapper pads the page axis to a power of two (`ops.np_bucket`) to
bound retraces; the port passes the page count as a runtime argument and
pads nothing (zero pages are exact no-ops, so results are unchanged).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Under `analysis.use_sanitizer` it checks
its operands and its output first and last (`attend_protected`).
"""
from __future__ import annotations

import functools
import math

import torch

from ..analysis.sanitizer import (check_finite, check_gf_symbols,
                                  check_quant_scales, sanitizer_enabled)
from . import build

NEG_INF = -1e30
# (row, head, page range) CTAs the split kernel aims at per SM (each is
# 256 threads and about 75 KB of shared memory at the serving shape, so
# three fit), and tokens a softmax step aims at (a lane each)
CTAS_PER_SM = 3
STEP_TOKENS = 32


def _packing():
    """`memory.packing`, imported at call time: the memory package imports
    the kernels package, so a module-level import here would be circular."""
    from ..memory import packing
    return packing


# ---------------------------------------------------------------------------
# plain versions (the JAX package's `kernels/ref.py` functions)
# ---------------------------------------------------------------------------


def paged_softmax_init(B: int, Hkv: int, G: int, Sq: int, D: int, device):
    """Fresh (m, l, acc) carries: (B,Hkv,G,Sq,1) -inf, zeros, and
    (B,Hkv,G,Sq,D) zeros, all fp32."""
    f32 = torch.float32
    return (torch.full((B, Hkv, G, Sq, 1), -math.inf, dtype=f32,
                       device=device),
            torch.zeros((B, Hkv, G, Sq, 1), dtype=f32, device=device),
            torch.zeros((B, Hkv, G, Sq, D), dtype=f32, device=device))


def paged_softmax_update(q, kpg, vpg, valid, m, l, acc, softcap=0.0):
    """One online-softmax step over a decoded KV page. q: (B,Sq,Hq,D);
    kpg/vpg: (B,T,Hkv,D) in q's dtype; valid: () or (B,) int tokens of the
    page that are real per row. Returns the new (m, l, acc)."""
    B, Sq, Hq, D = q.shape
    T, Hkv = kpg.shape[1], kpg.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kpg).float()
    logits = logits / torch.tensor(float(D), dtype=torch.float32).sqrt()
    if softcap and softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    valid = torch.as_tensor(valid, device=q.device)
    ok = (torch.arange(T, device=q.device)[None, None, None, None, :]
          < valid.reshape(-1, 1, 1, 1, 1))
    logits = torch.where(ok, logits, NEG_INF)
    pm = logits.amax(dim=-1, keepdim=True)
    new_m = torch.maximum(m, pm)
    w = torch.exp(logits - new_m)
    corr = torch.exp(m - new_m)
    new_l = corr * l + w.sum(dim=-1, keepdim=True)
    new_acc = corr * acc + torch.einsum("bhgqk,bkhd->bhgqd", w, vpg.float())
    return new_m, new_l, new_acc


def paged_softmax_finalize(q, m, l, acc):
    """(m, l, acc) -> (B, Sq, Hq, D) output in q's dtype."""
    B, Sq, Hq, D = q.shape
    out = acc / torch.clamp_min(l, 1e-30)
    out = out.permute(0, 3, 1, 2, 4)                 # (B,Sq,Hkv,G,D)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def dequant_gf_page(words, scale, *, p: int, k_info: int, page_shape,
                    dtype=torch.bfloat16):
    """GF page(s) -> dequantized tensor, exactly as
    `memory.paged.dequantize_tensor`: slice the info symbols, desymbolize,
    absmax-int8 dequantize, cast. words: (..., W, n) codeword page(s);
    scale: (...) absmax scales, one per leading element. Returns
    (...) + page_shape in `dtype`."""
    packing = _packing()
    lead = tuple(words.shape[:-2])
    numel = math.prod(page_shape)
    D = packing.digits_per_byte(p)
    info = words[..., :k_info]
    digits = info.reshape(lead + (-1,))[..., :numel * D]
    digits = digits.reshape(lead + (numel, D))
    qv = packing.desymbolize_u8(digits, p).to(torch.float32) - 128.0
    scale = torch.as_tensor(scale, dtype=torch.float32, device=words.device)
    out = (qv * scale.reshape(lead + (1,))).to(dtype)
    return out.reshape(lead + tuple(page_shape))


def attend_protected_plain(q, kpages, vpages, kscales, vscales, valid,
                           hot_k, hot_v, hot_valid, *, p: int, k_info: int,
                           page_shape, softcap: float = 0.0,
                           with_hot: bool = True, ref_pages: int = 0):
    """The fused read's plain version (the JAX oracle
    `ref.attend_protected_ref`): per page, `dequant_gf_page` then
    `paged_softmax_update`, the hot page last when `with_hot`. Operands as
    in `attend_protected`; `ref_pages` sizes the kernel's page ranges and
    has no effect here (the walk is one range)."""
    _check_pages(kpages, vpages, with_hot)
    B, Sq, Hq, D = q.shape
    _Bsub, T, Hkv, Dh = page_shape
    G = Hq // Hkv
    m, l, acc = paged_softmax_init(B, Hkv, G, Sq, D, q.device)
    for j in range(kpages.shape[0]):
        kpg = dequant_gf_page(kpages[j], kscales[j], p=p, k_info=k_info,
                              page_shape=page_shape, dtype=hot_k.dtype)
        vpg = dequant_gf_page(vpages[j], vscales[j], p=p, k_info=k_info,
                              page_shape=page_shape, dtype=hot_v.dtype)
        m, l, acc = paged_softmax_update(
            q, kpg.reshape(B, T, Hkv, Dh), vpg.reshape(B, T, Hkv, Dh),
            valid[j], m, l, acc, softcap=softcap)
    if with_hot:
        m, l, acc = paged_softmax_update(q, hot_k, hot_v, hot_valid, m, l,
                                         acc, softcap=softcap)
    return paged_softmax_finalize(q, m, l, acc)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def attend_plan(NP: int, BH: int, T: int, slots: int, ref_pages: int = 0
                ) -> tuple[int, int, int]:
    """(pages a softmax step, pages a range, ranges) of the split kernel
    for NP pages of T tokens and BH (row, KV head) pairs on `slots` SMs.
    Steps take about STEP_TOKENS tokens (at most 8 pages; the kernel takes
    fewer where shared memory is short). A range holds whole steps, as few
    as let max(NP, ref_pages) pages fill one wave of CTAS_PER_SM CTAs an
    SM, so there are never more ranges than that wave holds. With NP <=
    ref_pages the range's page count depends on ref_pages alone, not on
    NP; the last range holds the rest, and there are none without pages."""
    pg = max(1, min(8, STEP_TOKENS // T))
    steps = max(1, -(-max(NP, ref_pages) // pg))
    want = max(1, CTAS_PER_SM * slots // max(BH, 1))   # ranges in a wave
    rp = pg * -(-steps // want)
    return pg, rp, -(-NP // rp)


def _check_pages(kpages, vpages, with_hot):
    if kpages.dim() != 4 or kpages.shape != vpages.shape:
        raise ValueError(f"attend_protected: K/V pages must both be "
                         f"(NP, S, W, n), got {tuple(kpages.shape)} and "
                         f"{tuple(vpages.shape)}")
    if kpages.shape[0] == 0 and not with_hot:
        raise ValueError("paged attention needs at least one KV page")


def _expect(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"attend_protected: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"attend_protected: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"attend_protected: {name} must be contiguous")


def attend_protected(q, kpages, vpages, kscales, vscales, valid, hot_k,
                     hot_v, hot_valid, *, p: int, k_info: int, page_shape,
                     softcap: float = 0.0, with_hot: bool = True,
                     ref_pages: int = 0):
    """Fused protected paged attention -> (B, Sq, Hq, D) in q's dtype.

    q: (B, Sq, Hq, D) bf16. kpages/vpages: (NP, S, W, n) int8 corrected GF
    pages, page step j = S sub-pages of `page_shape` = (Bsub, T, Hkv, D)
    with S·Bsub = B; NP may be 0 when `with_hot`. kscales/vscales: (NP, S)
    float32 absmax scales. valid: (NP, B) int32 valid tokens per step and
    row. hot_k/hot_v: (B, T, Hkv, D) bf16 hot page, applied last with
    hot_valid (B,) int32 fill levels when `with_hot`. ref_pages: the page
    count the kernel's page ranges are sized for (`attend_plan`); a bound
    on NP that stays fixed across calls keeps each row's result
    independent of NP. It does not change the plain version's result.

    On the card every operand must already have exactly these dtypes and
    be contiguous; anything else raises (nothing is cast for the caller).

    Under `use_sanitizer` the pages must hold symbols in [0, p), the
    scales be finite and >= 0 and the query finite, and the output is
    checked finite after the call (a NaN in the hot page reaches it
    silently otherwise), as the JAX package's `ops.attend_protected`.
    """
    sanitize = sanitizer_enabled()
    if sanitize:
        check_gf_symbols(kpages, p, "attend_protected K pages")
        check_gf_symbols(vpages, p, "attend_protected V pages")
        check_quant_scales(kscales, "attend_protected K scales")
        check_quant_scales(vscales, "attend_protected V scales")
        check_finite(q, "attend_protected query")
    out = _attend_protected(q, kpages, vpages, kscales, vscales, valid,
                            hot_k, hot_v, hot_valid, p=p, k_info=k_info,
                            page_shape=page_shape, softcap=softcap,
                            with_hot=with_hot, ref_pages=ref_pages)
    if sanitize:
        check_finite(out, "attend_protected output")
    return out


def _attend_protected(q, kpages, vpages, kscales, vscales, valid, hot_k,
                      hot_v, hot_valid, *, p, k_info, page_shape, softcap,
                      with_hot, ref_pages):
    tensors = (q, kpages, vpages, kscales, vscales, valid, hot_k, hot_v,
               hot_valid)
    if build.route("attend_protected", *tensors) == "cpu":
        return attend_protected_plain(
            q, kpages, vpages, kscales, vscales, valid, hot_k, hot_v,
            hot_valid, p=p, k_info=k_info, page_shape=page_shape,
            softcap=softcap, with_hot=with_hot)
    _check_pages(kpages, vpages, with_hot)
    B, Sq, Hq, D = q.shape
    Bsub, T, Hkv, Dh = (int(x) for x in page_shape)
    NP, S, W, n = kpages.shape
    if Dh != D or Hq % Hkv or S * Bsub != B:
        raise ValueError(f"attend_protected: page_shape {tuple(page_shape)}"
                         f" does not fit q {tuple(q.shape)} with {S} "
                         f"sub-pages")
    Dg = _packing().digits_per_byte(p)
    if not 0 < k_info <= n or Bsub * T * Hkv * D * Dg > W * k_info:
        raise ValueError(f"attend_protected: a ({W}, {n}) page with "
                         f"k_info={k_info} cannot hold page_shape "
                         f"{tuple(page_shape)}")
    if W * n >= 2 ** 31:
        raise ValueError(f"attend_protected: a ({W}, {n}) page exceeds the "
                         "kernel's 32-bit in-page offsets")
    if not 2 <= p <= 127:
        raise ValueError(f"attend_protected: p={p} outside int8 cells")
    _expect("q", q, (B, Sq, Hq, D), torch.bfloat16)
    _expect("kpages", kpages, (NP, S, W, n), torch.int8)
    _expect("vpages", vpages, (NP, S, W, n), torch.int8)
    _expect("kscales", kscales, (NP, S), torch.float32)
    _expect("vscales", vscales, (NP, S), torch.float32)
    _expect("valid", valid, (NP, B), torch.int32)
    _expect("hot_k", hot_k, (B, T, Hkv, D), torch.bfloat16)
    _expect("hot_v", hot_v, (B, T, Hkv, D), torch.bfloat16)
    _expect("hot_valid", hot_valid, (B,), torch.int32)
    out = torch.empty_like(q)
    pg, rp, nsplit = attend_plan(NP, B * Hkv, T, build.sm_count(q.device),
                                 ref_pages)
    # each range's partial acc (R x D), m and l (R each), R = G·Sq
    part = torch.empty((B * Hkv, nsplit, (Hq // Hkv) * Sq, D + 2),
                       dtype=torch.float32, device=q.device)
    build.launch(
        "attend_protected", "rt_attend_protected", q.device,
        q.data_ptr(), kpages.data_ptr(), vpages.data_ptr(),
        kscales.data_ptr(), vscales.data_ptr(), valid.data_ptr(),
        hot_k.data_ptr(), hot_v.data_ptr(), hot_valid.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, Sq, Hq, Hkv, D, T, Bsub, S, NP,
        W, n, k_info, p, int(bool(with_hot)), nsplit, rp, pg,
        float(softcap or 0.0))
    return out
