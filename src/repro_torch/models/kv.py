"""Protected KV-cache serving: NB-LDPC memory-mode protection under live
inference.

Self-attention K/V pages live in device-resident
`memory.paged.PagedProtectedStore`s instead of dense buffers:

- **append** — tokens accumulate in a small dense *hot page*
  (`page_tokens` slots); when it fills, the page is absmax-int8
  quantized, symbolized to GF(p) levels and encoded on the device into the
  stores (write-time encode, the paper's no-interruption property);
- **read** — `attend` hands the GF pages, their scales and the hot page
  to the fused `attend_protected` kernel (desymbolize, dequantize and
  online softmax in one launch). Corrected pages come from the stores'
  scan-gated `read_page_corrected` (clean pages skip the decoder); with
  `corrected=False` the raw (possibly corrupted) cells go to the same
  kernel undecoded, the unprotected quality ablation. The operands are
  memoized until storage is corrupted (`inject`); a freeze writes its
  just-encoded page through to the memo;
- **streaming reference read** — `fused=False` streams dequantized pages
  through `nn.layers.attend_paged`, the page-by-page plain read the JAX
  package's parity tests hold the fused read against; `overlap=False`
  makes its refill block on every page. It runs on CPU tensors only: on
  the card every read goes through the kernel.

Global self-attention layers are protected; sliding-window layers keep
dense ring caches. `models.lm.prefill(..., protected_kv=...)` builds the
manager and ingests the prompt K/V, `decode_step` serves through it.

With `pool` (a `memory.pool.ProtectedPagePool`) every layer's stores are
`PooledStore`s: block tables into the shared pool instead of private
pages, returned to its free list by `free()`. With `mesh` (a
`distributed.sharding.Mesh` with a "data" axis) the private stores, and
the serving engine's default pool, keep every page as row shards over
the mesh's devices (`memory.paged`); the fused read gathers the pages
onto the layer's device.

Under `repro_torch.obs`, each freeze is a `kv.freeze` span and bumps
`kv_pages_frozen`, and each injection records a `kv.inject` instant and
adds its changed cells to `kv_cells_injected`, per owner, as the JAX
layer does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core.codes import get_code
from ..device import generator, resolve_device
from ..kernels.paged_attention import attend_protected
from ..memory.packing import digits_per_byte
from ..memory.paged import (PagedProtectedStore, dequantize_tensor,
                            quantize_tensor, words_for_tensor)
from ..memory.pool import PooledStore
from ..nn.kv_source import KVSource
from ..nn.layers import CDT
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

__all__ = ["ProtectedKVConfig", "ProtectedKVLayer", "ProtectedKVCaches",
           "protected_overhead"]


@dataclasses.dataclass(frozen=True)
class ProtectedKVConfig:
    """Knobs for the protected KV serving path."""

    code_name: str = "wl160_r08"
    page_tokens: int = 16          # tokens per frozen (encoded) page
    n_iters: int = 8               # FBP iterations on flagged pages
    damping: float = 0.3
    corrected: bool = True         # False: raw-level reads (the unprotected
                                   # quality ablation: same quantization,
                                   # no correction)
    fused: bool = True             # reads through the fused
                                   # attend_protected kernel; False streams
                                   # pages through attend_paged (CPU only)
    overlap: bool = True           # False: block on every page decode of
                                   # the streaming refill (CPU only)
    pool: Any = None               # ProtectedPagePool: every layer's
                                   # stores take their pages from this
                                   # shared pool (block tables) instead of
                                   # private grow-only storage
    mesh: Any = None               # shard pages across a device mesh


def _block_until_done(t: torch.Tensor) -> torch.Tensor:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


class ProtectedKVLayer(KVSource):
    """One self-attention layer's protected K/V: two paged stores (K and
    V), a dense hot page, and memoized corrected views."""

    kind = "protected"

    def __init__(self, pkv: ProtectedKVConfig, batch: int, hkv: int,
                 dh: int, dtype=CDT, owner: Any = None, device=None):
        self.pkv = pkv
        self.batch, self.hkv, self.dh = batch, hkv, dh
        self.dtype = dtype
        self.owner = owner
        self.device = resolve_device(device)
        self.page_shape = (batch, pkv.page_tokens, hkv, dh)
        code = get_code(pkv.code_name)
        # one frozen KV page == exactly one store page
        wpu = words_for_tensor(self.page_shape, code.p, code.k)
        if pkv.pool is not None:
            pool = pkv.pool
            if pool.page_words != wpu:
                raise ValueError(
                    f"pool page_words={pool.page_words} != {wpu} words per "
                    f"KV page for page_shape {self.page_shape}; size the "
                    "pool with words_for_tensor(page_shape, p, k)")
            if (pool.code.n, pool.code.k, pool.code.p) != (code.n, code.k,
                                                           code.p):
                raise ValueError(
                    f"pool code ({pool.code.n},{pool.code.k},p{pool.code.p})"
                    f" != KV code ({code.n},{code.k},p{code.p})")
            if pool.device.type != self.device.type:
                raise ValueError(f"pool on {pool.device}, layer on "
                                 f"{self.device}")
            self.k_store = PooledStore(pool, owner=owner)
            self.v_store = PooledStore(pool, owner=owner)
        else:
            self.k_store, self.v_store = (
                PagedProtectedStore(code, page_words=wpu, mesh=pkv.mesh,
                                    n_iters=pkv.n_iters, damping=pkv.damping,
                                    device=self.device)
                for _ in range(2))
            self.k_store.owner = self.v_store.owner = owner
        self.words_per_page = wpu
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.hot_k = torch.zeros(self.page_shape, dtype=dtype,
                                 device=self.device)
        self.hot_v = torch.zeros_like(self.hot_k)
        self.hot_len = 0
        self.n_frozen = 0              # frozen tokens (pages * page_tokens)
        self._metas: list = []         # per frozen page: (k_meta, v_meta)
        self._decoded: list | None = None   # memoized [(k_pg, v_pg)]
        self._gf_pages: list | None = None  # memoized [(k_words, v_words)]
        self._gf_stack = None          # stacked kernel operands

    # -- write path ---------------------------------------------------------

    @property
    def n_tokens(self) -> int:
        return self.n_frozen + self.hot_len

    def append(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append (B, t, Hkv, D) new-token K/V (RoPE already applied).
        Fills the hot page in place; each time it holds `page_tokens`
        tokens it is frozen into the stores."""
        t = k.shape[1]
        done = 0
        while done < t:
            take = min(t - done, self.pkv.page_tokens - self.hot_len)
            sl = slice(self.hot_len, self.hot_len + take)
            self.hot_k[:, sl] = k[:, done:done + take]
            self.hot_v[:, sl] = v[:, done:done + take]
            self.hot_len += take
            done += take
            if self.hot_len == self.pkv.page_tokens:
                self._freeze()

    def _freeze(self) -> None:
        code = self.k_store.code
        with obs_trace.span("kv.freeze", owner=str(self.owner)):
            kw, kmeta = quantize_tensor(self.hot_k, code.p, code.k)
            vw, vmeta = quantize_tensor(self.hot_v, code.p, code.k)
            self.k_store.append_words(kw)
            self.v_store.append_words(vw)
        reg = obs_metrics.current()
        if reg.enabled:
            reg.counter("kv_pages_frozen", layer="kv",
                        tenant=str(self.owner) if self.owner is not None
                        else "").inc()
        self._metas.append((kmeta, vmeta))
        if self._decoded is not None:
            # storage was just written clean: the decoded view of this page
            # is the dequantized pre-encode words
            self._decoded.append((dequantize_tensor(kw, kmeta, code.p),
                                  dequantize_tensor(vw, vmeta, code.p)))
        if self._gf_pages is not None:
            # the store page just written IS the corrected codeword page
            j = self.k_store.n_pages - 1
            self._gf_pages.append((self.k_store.page(j),
                                   self.v_store.page(j)))
            self._gf_stack = None
        self.n_frozen += self.pkv.page_tokens
        self.hot_len = 0

    # -- maintenance ----------------------------------------------------------

    def invalidate(self) -> None:
        """Drop the memoized views (storage changed under them)."""
        self._decoded = None
        self._gf_pages = None
        self._gf_stack = None

    def inject(self, channel, key=None, **kw) -> int:
        """Corrupt both stores through a channel model and drop the
        memoized views, so the next read goes through the decoder. `key`
        is a seed or a generator; without one the layer's own generator is
        drawn on. K and V take successive draws, so they never see the
        same error pattern."""
        gen = generator(key, self._gen, self.device)
        changed = self.k_store.inject(channel, gen, **kw)
        changed += self.v_store.inject(channel, gen, **kw)
        self.invalidate()
        tr = obs_trace.current()
        if tr.enabled:
            tr.instant("kv.inject", owner=str(self.owner), cells=changed)
        reg = obs_metrics.current()
        if reg.enabled:
            reg.counter("kv_cells_injected", layer="kv",
                        tenant=str(self.owner) if self.owner is not None
                        else "").inc(changed)
        return changed

    def free(self) -> None:
        """Release the stores (pool-backed stores return every block to
        the shared free list) and reset the hot page."""
        self.k_store.free()
        self.v_store.free()
        self.hot_k.zero_()
        self.hot_v.zero_()
        self.hot_len = 0
        self.n_frozen = 0
        self._metas = []
        self.invalidate()

    # -- streaming read path ------------------------------------------------

    def _refill_iter(self):
        """Decode and dequantize the frozen pages one at a time: raw levels
        when `corrected` is off, else the stores' pipelined
        `iter_corrected` (overlap) or a decode of every page that blocks
        on each (sync ablation)."""
        p = self.k_store.code.p
        kcode = self.k_store.code.k
        if not self.pkv.corrected:
            pages = zip(self.k_store._iter_pages(),
                        self.v_store._iter_pages(), strict=True)
        elif self.pkv.overlap:
            pages = zip(self.k_store.iter_corrected(depth=1),
                        self.v_store.iter_corrected(depth=1), strict=True)
        else:
            def sync_pages():
                for i in range(self.k_store.n_pages):
                    kp = self.k_store._decode(self.k_store.page(i))[1]
                    vp = self.v_store._decode(self.v_store.page(i))[1]
                    yield (_block_until_done(kp.symbols),
                           _block_until_done(vp.symbols))
            pages = sync_pages()
        for (kpg, vpg), (kmeta, vmeta) in zip(pages, self._metas,
                                              strict=True):
            kd = dequantize_tensor(kpg[:, :kcode], kmeta, p)
            vd = dequantize_tensor(vpg[:, :kcode], vmeta, p)
            if not self.pkv.overlap:
                _block_until_done(kd)
            yield kd, vd

    def pages(self):
        """Yield (k_page (B, T, Hkv, D), v_page, valid_tokens) in order:
        frozen pages from the memoized view, or streamed through the
        refill (and memoized when fully consumed); the hot page last."""
        T = self.pkv.page_tokens
        if self._decoded is not None:
            yield from ((kd, vd, T) for kd, vd in self._decoded)
        else:
            acc = []
            for kd, vd in self._refill_iter():
                acc.append((kd, vd))
                yield kd, vd, T
            self._decoded = acc
        if self.hot_len:
            yield self.hot_k, self.hot_v, self.hot_len

    # -- fused read path ----------------------------------------------------

    def _refill_gf(self) -> list:
        """GF codeword pages for the kernel: corrected page by page through
        the scan-gated `read_page_corrected` (corrections land in the
        stores' stats), or the raw stored cells when `corrected` is off.
        Memoized until storage is corrupted."""
        if self._gf_pages is None:
            if self.pkv.corrected:
                read = [s.read_page_corrected for s in (self.k_store,
                                                         self.v_store)]
            else:
                read = [self.k_store.page, self.v_store.page]
            self._gf_pages = [(read[0](i), read[1](i))
                              for i in range(self.k_store.n_pages)]
            self._gf_stack = None
        return self._gf_pages

    def _fused_inputs(self):
        """Stacked kernel operands: kpages/vpages (NP, 1, W, n) int8,
        kscales/vscales (NP, 1) float32, valid (NP, B) int32 (frozen pages
        are full). Rebuilt at the first read after a freeze; the page axis
        is not padded."""
        gf = self._refill_gf()
        if self._gf_stack is None:
            code = self.k_store.code
            NP, dev = len(gf), self.device
            if NP:
                kp = torch.stack([k for k, _ in gf])[:, None]
                vp = torch.stack([v for _, v in gf])[:, None]
                ks = torch.stack([km.scale for km, _ in self._metas])
                vs = torch.stack([vm.scale for _, vm in self._metas])
                ks, vs = ks.reshape(NP, 1), vs.reshape(NP, 1)
            else:
                kp = torch.zeros((0, 1, self.words_per_page, code.n),
                                 dtype=self.k_store.dtype, device=dev)
                vp = kp
                ks = vs = torch.zeros((0, 1), dtype=torch.float32,
                                      device=dev)
            valid = torch.full((NP, self.batch), self.pkv.page_tokens,
                               dtype=torch.int32, device=dev)
            self._gf_stack = (kp, vp, ks, vs, valid)
        return self._gf_stack

    def attend(self, q, softcap=0.0):
        """The fused one-kernel read: GF pages (corrected, or raw with
        `corrected` off) + scales + query -> attention output through
        `attend_protected`. With `fused` off, the streaming `pages()` read
        instead, on CPU tensors only."""
        if not self.pkv.fused:
            return super().attend(q, softcap)
        if self.n_tokens == 0:
            raise ValueError("paged attention needs at least one KV page")
        kp, vp, ks, vs, valid = self._fused_inputs()
        code = self.k_store.code
        hot_valid = torch.full((self.batch,), self.hot_len,
                               dtype=torch.int32, device=self.device)
        return attend_protected(
            q, kp, vp, ks, vs, valid, self.hot_k, self.hot_v, hot_valid,
            p=code.p, k_info=code.k, page_shape=self.page_shape,
            softcap=float(softcap or 0.0), with_hot=self.hot_len > 0)

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        ks, vs = self.k_store.stats, self.v_store.stats
        return {"tokens": self.n_tokens, "frozen_pages": len(self._metas),
                "stored_words": self.k_store.n_words + self.v_store.n_words,
                "stored_cells": self.k_store.n_cells + self.v_store.n_cells,
                "flagged_words": int(self.k_store.scan_flags().sum()
                                     + self.v_store.scan_flags().sum()),
                "detected": ks.detected + vs.detected,
                "corrected": ks.corrected + vs.corrected,
                "uncorrectable": ks.uncorrectable + vs.uncorrectable}


class ProtectedKVCaches:
    """Whole-model protected decode caches: a `ProtectedKVLayer` per global
    self-attention layer, dense entries for everything else (mamba
    layers' conv tail and SSM state, cross K/V, sliding-window rings, an
    encoder-decoder layer's self-attention K/V beside its cross K/V), as
    the JAX package's `ProtectedKVCaches`. `view`/`update` are the surface
    `models.lm` decodes through."""

    def __init__(self, cfg: ArchConfig, pkv: ProtectedKVConfig, batch: int,
                 max_seq: int, owner: Any = None, device=None):
        from .lm import _block_cache                     # lm imports kv
        self.cfg, self.pkv = cfg, pkv
        self.batch, self.max_seq = batch, max_seq
        self.owner = owner
        self.device = resolve_device(device)
        self.layers: dict[tuple[int, int], ProtectedKVLayer] = {}
        self.dense: dict[tuple[int, int], dict] = {}
        for g in range(cfg.n_groups):
            for i, spec in enumerate(cfg.group_spec):
                if self._protectable(spec):
                    self.layers[(g, i)] = ProtectedKVLayer(
                        pkv, batch, cfg.n_kv_heads, cfg.head_dim,
                        owner=owner, device=self.device)
                else:
                    self.dense[(g, i)] = _block_cache(
                        spec, cfg, batch, max_seq, cfg.n_aux_tokens or 1,
                        self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(0)

    @staticmethod
    def _protectable(spec) -> bool:
        return (spec.kind == "attn" and not spec.cross
                and not spec.local_window)

    # -- the decode surface -------------------------------------------------

    def view(self, g: int, i: int):
        if (g, i) in self.layers:
            return self.layers[(g, i)]           # a KVSource
        return self.dense[(g, i)]

    def update(self, g: int, i: int, new_cache: dict | None) -> None:
        if not new_cache or (g, i) in self.layers:
            return
        self.dense[(g, i)].update(new_cache)

    # -- prefill ingest -----------------------------------------------------

    def ingest_prefill(self, caches, S: int) -> None:
        """Adopt the stacked caches a `prefill` pass produced: protected
        layers append the prompt K/V (quantize and encode, page by page);
        dense entries (K/V rings, cross K/V, mamba states) are copied into
        their buffers, along the first axis past the batch where the
        prompt's entry is shorter (the JAX package pads it)."""
        for i in range(len(self.cfg.group_spec)):
            entry = caches[f"pos{i}"]
            for g in range(self.cfg.n_groups):
                if (g, i) in self.layers:
                    self.layers[(g, i)].append(entry["k"][g][:, :S],
                                               entry["v"][g][:, :S])
                else:
                    for name, buf in self.dense[(g, i)].items():
                        val = entry[name][g]
                        buf[:, :val.shape[1]] = val

    # -- maintenance / stats ------------------------------------------------

    def inject(self, channel, key=None, **kw) -> int:
        """Corrupt every protected layer's stores and drop their memoized
        views. `key` is a seed or a generator (the caches' own without
        one); the layers take successive draws from it, so no two layers,
        and no two stores, see the same error pattern."""
        gen = generator(key, self._gen, self.device)
        return sum(self.layers[ij].inject(channel, gen, **kw)
                   for ij in sorted(self.layers))

    def free(self) -> None:
        for layer in self.layers.values():
            layer.free()

    def invalidate(self) -> None:
        for layer in self.layers.values():
            layer.invalidate()

    def scrub(self) -> dict:
        rep = {"flagged_words": 0, "repaired_words": 0}
        for layer in self.layers.values():
            for store in (layer.k_store, layer.v_store):
                r = store.scrub()
                rep["flagged_words"] += r["flagged_words"]
                rep["repaired_words"] += r["repaired_words"]
            layer.invalidate()
        return rep

    def stats(self) -> dict:
        per = [ly.stats() for ly in self.layers.values()]
        return {"protected_layers": len(self.layers),
                "dense_layers": len(self.dense),
                "tokens": per[0]["tokens"] if per else 0,
                "stored_words": sum(s["stored_words"] for s in per),
                "stored_cells": sum(s["stored_cells"] for s in per),
                "flagged_words": sum(s["flagged_words"] for s in per)}


def protected_overhead(cfg: ArchConfig, pkv: ProtectedKVConfig) -> dict:
    """Static storage accounting: cells per token of the protected cache
    against the raw int8 K + V bytes (rate loss = check overhead x
    symbolization density)."""
    code = get_code(pkv.code_name)
    bytes_per_tok = 2 * cfg.n_kv_heads * cfg.head_dim          # int8 K + V
    digits = bytes_per_tok * digits_per_byte(code.p)
    return {"code": pkv.code_name, "rate": code.k / code.n,
            "cells_per_token": digits / code.rate,
            "int8_bytes_per_token": bytes_per_tok}
