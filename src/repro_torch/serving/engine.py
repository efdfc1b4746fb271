"""Multi-tenant protected serving engine: continuous batching over a shared
NB-LDPC-protected page pool, as the JAX package's `repro.serving.engine`.

- **slots** — the engine owns `max_active` batch slots and runs every
  step at batch `max_active` whatever the occupancy, so a sequence's rows
  are computed the same way whichever other slots are occupied: a tenant
  gets the same tokens served alone or among others.
- **block tables** — each slot's K/V pages live in a shared
  `memory.pool.ProtectedPagePool` through per-tenant `PooledStore`s (one
  per slot, layer and K/V). Admission preflights pool capacity; a step
  whose freezes would not fit preempts the youngest sequence (LIFO) and
  returns its blocks to the free list.
- **preemption and resume** — a preempted sequence keeps its tokens only.
  Readmission re-prefills its prompt and replays its generated tokens
  teacher-forced through the batched decode, which rebuilds the same page
  contents: a resumed sequence continues bit for bit.
- **background scrub** — every `scrub_every` steps a bounded
  `pool.scrub(max_pages=...)` sweeps allocated pages between decode steps,
  repairs attributed to the owning tenant. With a RAS estimator installed
  the period is `adaptive_interval(scrub_every)` and the sweep takes the
  pages that flag most first (`prioritize=True`).
- **per-tenant accounting** — each slot store's `stats` counts the
  detected, corrected and uncorrectable words of that tenant's reads;
  `tenant_stats` adds them up with the pool's per-owner scrub report, and
  `publish_metrics` exports them as gauges.
- **observability** — under `repro_torch.obs` each step is an
  `engine.step` span with `engine.admit`, `engine.prefill`,
  `engine.decode`, `engine.scrub` and `engine.sample_sync` children and an
  `engine.preempt` instant, and feeds the step counters, the step-time
  histogram and the active-slot gauge. Each pillar costs one attribute
  read a step when it is not installed; spans never synchronize the card.

The engine drives the model stack unchanged: `models.lm.decode_step`
routes `EngineCaches` (`is_protected_manager = True`, a (B,) position per
slot) through the blocks' `KVSource` read, which for `BatchedPagedKV` is
the `attend_protected` kernel over per-slot GF pages (S = B sub-pages a
page step) and the per-slot hot rows.

Differences from the JAX engine, by design: the page axis of the kernel's
operands is not padded to a power of two (`np_bucket`), since zero pages
are exact no-ops and the port passes the page count at run time; the
streaming `pages()` read takes CPU tensors only (on the card every read
is the kernel's, `corrected=False` handing it the raw cells).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.codes import get_code
from ..kernels.paged_attention import (attend_protected,
                                       paged_softmax_finalize,
                                       paged_softmax_init,
                                       paged_softmax_update)
from ..memory.controller import ControllerStats
from ..memory.paged import (dequantize_tensor, quantize_tensor,
                            words_for_tensor)
from ..memory.pool import PooledStore, PoolExhausted, ProtectedPagePool
from ..models.kv import ProtectedKVConfig
from ..nn.kv_source import KVSource
from ..nn.layers import CDT
from ..obs import metrics as obs_metrics
from ..obs import ras as obs_ras
from ..obs import trace as obs_trace
from ..obs.trace import span

__all__ = ["BatchedPagedKV", "BatchedDenseKV", "EngineCaches",
           "SequenceState", "ServingEngine"]


def _scatter_rows(buf: torch.Tensor, rows: torch.Tensor,
                  pos: torch.Tensor) -> None:
    """Per-slot scatter in place: buf (B, T, H, D), rows (B, 1, H, D), pos
    (B,) -> buf[b, pos[b]] = rows[b, 0]."""
    idx = torch.arange(buf.shape[0], device=buf.device)
    buf[idx, pos] = rows[:, 0].to(buf.dtype)


def _device_lengths(lengths: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(lengths, dtype=torch.int32, device=device)


class BatchedPagedKV(KVSource):
    """One attention layer's K/V for `max_active` slots: a shared dense hot
    block with per-slot fill levels, and per-slot pool-backed frozen pages.

    Slots freeze independently: when slot b's hot row reaches
    `page_tokens` tokens it alone is quantized and encoded into b's
    stores. The fused `attend` hands `attend_protected` the per-slot
    corrected GF pages stacked to (NP, B, W, n), NP the most pages any
    slot holds; a slot with fewer pages has zero pages with scale 0 and
    valid 0 there, which the kernel's online softmax passes over exactly.
    The stack is kept in place and only the pages that change are
    written: a freeze writes its just-encoded page, and after `invalidate`
    the next read re-reads every page through the slot's stores. The
    streaming `pages()` read (CPU only) stacks dequantized pages instead,
    the JAX package's reference read."""

    kind = "protected"

    def __init__(self, pkv: ProtectedKVConfig, pool: ProtectedPagePool,
                 max_active: int, hkv: int, dh: int, dtype=CDT,
                 max_seq: int = 0):
        self.pkv, self.pool = pkv, pool
        self.max_active = max_active
        self.T = pkv.page_tokens
        # the kernel's page ranges are sized for max_seq's pages, so that a
        # slot's bits do not depend on how many pages the other slots hold
        self.ref_pages = -(-max_seq // self.T)
        self.code = pool.code
        self.dtype = dtype
        self.device = pool.device
        self.page_shape = (1, self.T, hkv, dh)
        wpu = words_for_tensor(self.page_shape, self.code.p, self.code.k)
        if wpu != pool.page_words:
            raise ValueError(
                f"pool page_words={pool.page_words} != {wpu} words per "
                f"per-slot KV page {self.page_shape}; size the pool with "
                "words_for_tensor((1, page_tokens, n_kv_heads, head_dim))")
        self.words_per_page = wpu
        B = max_active
        self.hot_k = torch.zeros((B, self.T, hkv, dh), dtype=dtype,
                                 device=self.device)
        self.hot_v = torch.zeros_like(self.hot_k)
        self.hot_len = np.zeros(B, np.int32)
        self._hot_len_dev = _device_lengths(self.hot_len, self.device)
        self.k_stores: list[PooledStore | None] = [None] * B
        self.v_stores: list[PooledStore | None] = [None] * B
        self.metas: list[list] = [[] for _ in range(B)]
        # streaming-read memo: per slot, dequantized (K, V) pages or None
        self._decoded: list[list] = [[] for _ in range(B)]
        self._stack_cache: list | None = None
        # fused read: the kernel's operands with room for `cap` page steps,
        # and per slot which pages must be (re)read into them
        self._ops: tuple | None = None
        self._stale: list[list[bool]] = [[] for _ in range(B)]
        self._any_stale = False
        # which slots advance on append; the engine sets this each step
        self.active = np.zeros(B, bool)

    # -- slot lifecycle -----------------------------------------------------

    def _reset_slot(self, b: int) -> None:
        """Slot b holds no page: zero fill level, no pages in the operands
        (a closed slot's hot rows stay, masked, as in the JAX engine)."""
        self.hot_len[b] = 0
        self._hot_len_dev = _device_lengths(self.hot_len, self.device)
        self.metas[b] = []
        self._decoded[b] = []
        self._stale[b] = []
        self._stack_cache = None
        if self._ops is not None:
            for t in self._ops:
                t[:, b] = 0

    def open_slot(self, b: int, owner=None) -> None:
        self.k_stores[b] = PooledStore(self.pool, owner=owner)
        self.v_stores[b] = PooledStore(self.pool, owner=owner)
        self.hot_k[b].zero_()
        self.hot_v[b].zero_()
        self._reset_slot(b)

    def close_slot(self, b: int) -> dict:
        """Free the slot's pool blocks. Returns the slot's correction
        counters, for the engine to bank on the tenant."""
        out: dict[str, int] = {}
        for store in (self.k_stores[b], self.v_stores[b]):
            if store is not None:
                ControllerStats.add_counts(out, store.stats)
                store.free()
        for k in ControllerStats.CORRECTION_KEYS:
            out.setdefault(k, 0)
        self.k_stores[b] = self.v_stores[b] = None
        self._reset_slot(b)
        return out

    # -- write path ---------------------------------------------------------

    def _operands(self, pages: int) -> tuple:
        """The stacked operands (kpages, vpages (cap, B, W, n); kscales,
        vscales (cap, B) float32; valid (cap, B) int32), grown to hold at
        least `pages` page steps."""
        cap = 0 if self._ops is None else self._ops[0].shape[0]
        if self._ops is None or pages > cap:
            new = max(pages, 2 * cap)
            B, W, n, dev = (self.max_active, self.words_per_page,
                            self.code.n, self.device)
            ops = (torch.zeros((new, B, W, n), dtype=self.pool.dtype,
                               device=dev),
                   torch.zeros((new, B, W, n), dtype=self.pool.dtype,
                               device=dev),
                   torch.zeros((new, B), dtype=torch.float32, device=dev),
                   torch.zeros((new, B), dtype=torch.float32, device=dev),
                   torch.zeros((new, B), dtype=torch.int32, device=dev))
            if cap:
                for t, old in zip(ops, self._ops, strict=True):
                    t[:cap] = old
            self._ops = ops
        return self._ops

    def _put_page(self, b: int, j: int, kpg: torch.Tensor,
                  vpg: torch.Tensor) -> None:
        kp, vp, ks, vs, valid = self._operands(j + 1)
        kmeta, vmeta = self.metas[b][j]
        kp[j, b] = kpg
        vp[j, b] = vpg
        ks[j, b] = kmeta.scale
        vs[j, b] = vmeta.scale
        valid[j, b] = self.T

    def _freeze_rows(self, b: int, kpage: torch.Tensor,
                     vpage: torch.Tensor) -> None:
        """Quantize and encode one (1, T, Hkv, D) page into slot b's
        stores; the page just written is clean, so it goes straight into
        the kernel's operands."""
        p, kk = self.code.p, self.code.k
        kw, kmeta = quantize_tensor(kpage, p, kk)
        vw, vmeta = quantize_tensor(vpage, p, kk)
        self.k_stores[b].append_words(kw)
        self.v_stores[b].append_words(vw)
        self.metas[b].append((kmeta, vmeta))
        self._decoded[b].append(
            None if self.pkv.fused else (dequantize_tensor(kw, kmeta, p),
                                         dequantize_tensor(vw, vmeta, p)))
        j = self.k_stores[b].n_pages - 1
        self._stale[b].append(False)
        self._put_page(b, j, self.k_stores[b].page(j),
                       self.v_stores[b].page(j))
        self._stack_cache = None

    def _freeze_slot(self, b: int) -> None:
        self._freeze_rows(b, self.hot_k[b:b + 1], self.hot_v[b:b + 1])
        self.hot_len[b] = 0   # stale hot rows are masked by the fill level
                              # and overwritten by the next scatters

    def ingest_slot(self, b: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Adopt a prompt's (1, S, Hkv, D) K/V into slot b: full pages
        freeze (quantize and encode), the rest seeds the hot row."""
        S, T = k.shape[1], self.T
        for j in range(S // T):
            self._freeze_rows(b, k[:, j * T:(j + 1) * T],
                              v[:, j * T:(j + 1) * T])
        rem = S % T
        self.hot_k[b].zero_()
        self.hot_v[b].zero_()
        if rem:
            self.hot_k[b, :rem] = k[0, S - rem:].to(self.dtype)
            self.hot_v[b, :rem] = v[0, S - rem:].to(self.dtype)
        self.hot_len[b] = rem
        self._hot_len_dev = _device_lengths(self.hot_len, self.device)

    def append(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """One decode step's (B, 1, Hkv, D) K/V: every row goes to its
        slot's hot position, active slots advance, and a slot whose hot
        row filled freezes. Inactive slots' rows land on masked positions
        and are overwritten by their next real token."""
        pos = self._hot_len_dev.to(torch.int64)
        _scatter_rows(self.hot_k, k, pos)
        _scatter_rows(self.hot_v, v, pos)
        self.hot_len = self.hot_len + self.active.astype(np.int32)
        for b in np.nonzero(self.hot_len >= self.T)[0]:
            self._freeze_slot(int(b))
        self._hot_len_dev = _device_lengths(self.hot_len, self.device)

    # -- read path ----------------------------------------------------------

    def invalidate(self) -> None:
        """Storage changed under the memoized views: the next read goes
        through each slot's stores again."""
        for b in range(self.max_active):
            self._decoded[b] = [None] * len(self.metas[b])
            self._stale[b] = [True] * len(self.metas[b])
        self._any_stale = any(self.metas)
        self._stack_cache = None

    def _read_page(self, b: int, j: int) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
        """Slot b's page j: corrected through the scan-gated read (the
        corrections land on the tenant's stores), or the raw cells when
        `corrected` is off."""
        ks, vs = self.k_stores[b], self.v_stores[b]
        if self.pkv.corrected:
            return ks.read_page_corrected(j), vs.read_page_corrected(j)
        return ks.page(j), vs.page(j)

    def _decoded_page(self, b: int, j: int):
        ent = self._decoded[b][j]
        if ent is None:
            kmeta, vmeta = self.metas[b][j]
            p, kk = self.code.p, self.code.k
            kpg, vpg = self._read_page(b, j)
            ent = (dequantize_tensor(kpg[:, :kk], kmeta, p),
                   dequantize_tensor(vpg[:, :kk], vmeta, p))
            self._decoded[b][j] = ent
        return ent

    def _stacked_page(self, j: int):
        zero = torch.zeros(self.page_shape, dtype=self.dtype,
                           device=self.device)
        ks, vs, valid = [], [], []
        for b in range(self.max_active):
            if j < len(self.metas[b]):
                kd, vd = self._decoded_page(b, j)
                ks.append(kd.to(self.dtype))
                vs.append(vd.to(self.dtype))
                valid.append(self.T)
            else:
                ks.append(zero)
                vs.append(zero)
                valid.append(0)
        return (torch.cat(ks), torch.cat(vs),
                torch.tensor(valid, dtype=torch.int32, device=self.device))

    def pages(self):
        """Yield (k (B, T, Hkv, D), v, valid (B,)) page steps for the
        streaming online softmax: frozen page j stacks slot b's decoded
        page j (or a masked zero page), the shared hot block rides last
        with per-slot fill. Stacked pages are memoized between freezes."""
        max_pg = max((len(m) for m in self.metas), default=0)
        if self._stack_cache is None or len(self._stack_cache) != max_pg:
            self._stack_cache = [self._stacked_page(j)
                                 for j in range(max_pg)]
        yield from self._stack_cache
        yield self.hot_k, self.hot_v, self._hot_len_dev

    def fused_inputs(self) -> tuple:
        """The kernel's page operands: kpages/vpages (NP, B, W, n),
        kscales/vscales (NP, B) float32, valid (NP, B) int32, page step j
        holding slot b's page j. Pages invalidated since the last read are
        read (corrected) first, step by step and slot by slot."""
        max_pg = max((len(m) for m in self.metas), default=0)
        if self._any_stale:
            for j in range(max_pg):
                for b in range(self.max_active):
                    if j < len(self._stale[b]) and self._stale[b][j]:
                        self._put_page(b, j, *self._read_page(b, j))
                        self._stale[b][j] = False
            self._any_stale = False
        return tuple(t[:max_pg] for t in self._operands(max_pg))

    def attend(self, q, softcap=0.0):
        """The fused read: `attend_protected` over the per-slot GF pages
        and the hot block with per-slot fill levels. With `fused` off, the
        streaming `pages()` read instead, on CPU tensors only."""
        if not self.pkv.fused:
            return super().attend(q, softcap)
        kp, vp, ks, vs, valid = self.fused_inputs()
        return attend_protected(
            q, kp, vp, ks, vs, valid, self.hot_k, self.hot_v,
            self._hot_len_dev, p=self.code.p, k_info=self.code.k,
            page_shape=self.page_shape, softcap=float(softcap or 0.0),
            with_hot=True, ref_pages=self.ref_pages)

    # -- capacity -----------------------------------------------------------

    def freeze_candidates(self, active: np.ndarray) -> int:
        """Pool pages the NEXT step's appends allocate: 2 per active slot
        about to fill its hot row (the engine's preflight input)."""
        about = active & (self.hot_len == self.T - 1)
        return 2 * int(about.sum())

    def slot_pages(self, b: int) -> list[int]:
        out: list[int] = []
        for store in (self.k_stores[b], self.v_stores[b]):
            if store is not None:
                out.extend(store.block_table)
        return out


class BatchedDenseKV(KVSource):
    """The unprotected baseline: per-slot dense K/V rows in one
    (max_active, max_seq, Hkv, D) buffer, read as one page with per-slot
    valid lengths through the page online softmax (plain PyTorch on any
    device, as the JAX engine reads it through `_attend_paged`)."""

    kind = "dense"

    def __init__(self, max_active: int, max_seq: int, hkv: int, dh: int,
                 dtype=CDT, device=None):
        self.max_active, self.max_seq = max_active, max_seq
        self.device = device
        self.k = torch.zeros((max_active, max_seq, hkv, dh), dtype=dtype,
                             device=device)
        self.v = torch.zeros_like(self.k)
        self.len = np.zeros(max_active, np.int32)
        self._len_dev = _device_lengths(self.len, device)
        self.dtype = dtype
        self.active = np.zeros(max_active, bool)

    def open_slot(self, b: int, owner=None) -> None:
        self.k[b].zero_()
        self.v[b].zero_()
        self.len[b] = 0
        self._len_dev = _device_lengths(self.len, self.device)

    def close_slot(self, b: int) -> dict:
        self.len[b] = 0
        self._len_dev = _device_lengths(self.len, self.device)
        return dict.fromkeys(ControllerStats.CORRECTION_KEYS, 0)

    def ingest_slot(self, b: int, k: torch.Tensor, v: torch.Tensor) -> None:
        S = k.shape[1]
        self.k[b].zero_()
        self.v[b].zero_()
        self.k[b, :S] = k[0].to(self.dtype)
        self.v[b, :S] = v[0].to(self.dtype)
        self.len[b] = S
        self._len_dev = _device_lengths(self.len, self.device)

    def append(self, k: torch.Tensor, v: torch.Tensor) -> None:
        pos = self._len_dev.to(torch.int64)
        _scatter_rows(self.k, k, pos)
        _scatter_rows(self.v, v, pos)
        self.len = self.len + self.active.astype(np.int32)
        self._len_dev = _device_lengths(self.len, self.device)

    def invalidate(self) -> None:
        pass

    def pages(self):
        yield self.k, self.v, self._len_dev

    def attend(self, q, softcap=0.0):
        B, Sq, Hq, D = q.shape
        Hkv = self.k.shape[2]
        m, l, acc = paged_softmax_init(B, Hkv, Hq // Hkv, Sq, D, q.device)
        m, l, acc = paged_softmax_update(q, self.k, self.v, self._len_dev,
                                         m, l, acc,
                                         softcap=float(softcap or 0.0))
        return paged_softmax_finalize(q, m, l, acc)

    def freeze_candidates(self, active: np.ndarray) -> int:
        return 0

    def slot_pages(self, b: int) -> list[int]:
        return []


class EngineCaches:
    """The engine's cache manager: the `view`/`update` surface
    `models.lm._decode_step_protected` drives, one batched KV layer per
    attention layer."""

    is_protected_manager = True

    def __init__(self, cfg: ArchConfig, layers: dict[tuple[int, int], Any]):
        self.cfg = cfg
        self.layers = layers

    def view(self, g: int, i: int):
        return self.layers[(g, i)]               # a KVSource

    def update(self, g: int, i: int, new_cache) -> None:
        return None

    def set_active(self, active: np.ndarray) -> None:
        for layer in self.layers.values():
            layer.active = active


@dataclasses.dataclass
class SequenceState:
    """One tenant's request through the engine."""

    tenant: Any
    prompt: np.ndarray                  # (S,) int token ids
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)
    status: str = "waiting"             # waiting | active | done
    slot: int | None = None
    replay_idx: int = 0                 # next generated token to feed
    admit_step: int = -1
    preemptions: int = 0
    stats: dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(
            ControllerStats.CORRECTION_KEYS, 0))

    @property
    def done(self) -> bool:
        return self.status == "done"


class ServingEngine:
    """Continuous-batching scheduler over `max_active` slots.

    `submit()` queues sequences; each `step()` admits what fits (pool
    capacity preflighted), runs one batched greedy decode step for every
    active slot, retires finished sequences and, every `scrub_every`
    steps, runs a bounded scrub of the pool. When a step's freezes would
    not fit, the youngest sequence is preempted (LIFO); it readmits by
    re-prefilling its prompt and replaying its tokens teacher-forced,
    bit-exact with never having been evicted. The engine runs on the
    parameters' device; `pool` must be on it too."""

    def __init__(self, params, cfg: ArchConfig, *,
                 pkv: ProtectedKVConfig | None = None,
                 pool: ProtectedPagePool | None = None,
                 max_active: int = 16, max_seq: int = 512,
                 protected: bool = True, scrub_every: int = 0,
                 scrub_max_pages: int = 4, scrub_min_age: int = 0):
        self.params, self.cfg = params, cfg
        self.device = params.device
        self.max_active, self.max_seq = max_active, max_seq
        self.protected = protected
        self.scrub_every = scrub_every
        self.scrub_max_pages = scrub_max_pages
        self.scrub_min_age = scrub_min_age
        hkv, dh = cfg.n_kv_heads, cfg.head_dim
        for spec in cfg.group_spec:
            if not (spec.kind == "attn" and not spec.cross
                    and not spec.local_window):
                raise ValueError(
                    "ServingEngine serves global self-attention stacks; "
                    f"layer kind {spec.kind!r} (cross={spec.cross}, "
                    f"window={spec.local_window}) is not batchable here")
        layers: dict[tuple[int, int], Any] = {}
        if protected:
            self.pkv = pkv or ProtectedKVConfig()
            code = get_code(self.pkv.code_name)
            wpu = words_for_tensor((1, self.pkv.page_tokens, hkv, dh),
                                   code.p, code.k)
            if pool is None:
                pool = ProtectedPagePool(
                    code, page_words=wpu,
                    capacity_pages=self._default_capacity(cfg, max_active),
                    mesh=self.pkv.mesh, n_iters=self.pkv.n_iters,
                    damping=self.pkv.damping, device=self.device)
            if pool.device.type != self.device.type:
                raise ValueError(f"pool on {pool.device}, parameters on "
                                 f"{self.device}")
            self.pool = pool
            for g in range(cfg.n_groups):
                for i in range(len(cfg.group_spec)):
                    layers[(g, i)] = BatchedPagedKV(
                        self.pkv, pool, max_active, hkv, dh, max_seq=max_seq)
        else:
            self.pkv = pkv
            self.pool = None
            for g in range(cfg.n_groups):
                for i in range(len(cfg.group_spec)):
                    layers[(g, i)] = BatchedDenseKV(
                        max_active, max_seq, hkv, dh, device=self.device)
        self.caches = EngineCaches(cfg, layers)
        self.n_stores = 2 * len(layers)      # pool pages per frozen KV page
        self.waiting: deque = deque()
        self.slots: list[SequenceState | None] = [None] * max_active
        self.sequences: list[SequenceState] = []
        self._step_no = 0
        self.scrub_reports: list[dict] = []

    def _default_capacity(self, cfg: ArchConfig, max_active: int) -> int:
        pages_per_seq = -(-self.max_seq // self.pkv.page_tokens)
        n_layers = cfg.n_groups * len(cfg.group_spec)
        return max_active * pages_per_seq * 2 * n_layers

    # -- submission ---------------------------------------------------------

    def submit(self, tenant, prompt, max_new: int) -> SequenceState:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) + max_new > self.max_seq:
            raise ValueError(f"prompt {len(prompt)} + max_new {max_new} "
                             f"exceeds max_seq {self.max_seq}")
        seq = SequenceState(tenant=tenant, prompt=prompt, max_new=max_new)
        self.waiting.append(seq)
        self.sequences.append(seq)
        return seq

    # -- scheduling ---------------------------------------------------------

    def _admission_pages(self, seq: SequenceState) -> int:
        if not self.protected:
            return 0
        return (len(seq.prompt) // self.pkv.page_tokens) * self.n_stores

    def _admit(self) -> list[SequenceState]:
        assigns: list[tuple[SequenceState, int]] = []
        reserved: set = set()
        pending_pages = 0
        while self.waiting:
            free = [b for b in range(self.max_active)
                    if self.slots[b] is None and b not in reserved]
            if not free:
                break
            seq = self.waiting[0]
            need = self._admission_pages(seq)
            if (self.protected
                    and pending_pages + need > self.pool.available):
                break
            self.waiting.popleft()
            assigns.append((seq, free[0]))
            reserved.add(free[0])
            pending_pages += need
        # one (max_active, S) prefill per distinct prompt length: rows are
        # computed independently, so a prompt's row is the same whether it
        # shares the batch with other admits or with pad rows
        by_len: dict[int, list[tuple[SequenceState, int]]] = {}
        for seq, b in assigns:
            by_len.setdefault(len(seq.prompt), []).append((seq, b))
        for S, group in sorted(by_len.items()):
            self._prefill_group(S, group)
        return [seq for seq, _ in assigns]

    def _prefill_group(self, S: int,
                       group: list[tuple[SequenceState, int]]) -> None:
        from ..models import lm
        tokens = np.zeros((self.max_active, S), np.int64)
        for j, (seq, _b) in enumerate(group):
            tokens[j] = seq.prompt
        with span("engine.prefill", prompt_len=S, n_seqs=len(group),
                  tenants=[str(s.tenant) for s, _ in group]):
            logits, caches = lm.prefill(
                self.params, self.cfg,
                torch.as_tensor(tokens, device=self.device))
        first = logits[:, -1].argmax(dim=-1).tolist()
        for j, (seq, b) in enumerate(group):
            for (g, i), layer in self.caches.layers.items():
                entry = caches[f"pos{i}"]
                layer.open_slot(b, owner=seq.tenant)
                layer.ingest_slot(b, entry["k"][g][j:j + 1, :S],
                                  entry["v"][g][j:j + 1, :S])
            if not seq.generated:
                # the prefill's last logit gives the first generated token
                seq.generated.append(int(first[j]))
            seq.replay_idx = 0
            seq.slot = b
            seq.status = "active"
            seq.admit_step = self._step_no
            self.slots[b] = seq
            if len(seq.generated) >= seq.max_new:
                # max_new == 1: the prefill already gave the only token
                self._release_slot(seq)
                seq.status = "done"

    def _release_slot(self, seq: SequenceState) -> None:
        # the only place slot-store counters enter seq.stats: close_slot
        # frees the stores in the same motion, so a counter is banked once
        for layer in self.caches.layers.values():
            ControllerStats.add_counts(seq.stats, layer.close_slot(seq.slot))
        self.slots[seq.slot] = None
        seq.slot = None

    def _preempt_one(self) -> int | None:
        """Evict the youngest active sequence (LIFO): cheapest to replay,
        and the oldest tenants keep streaming. Returns the freed slot."""
        live = [s for s in self.slots if s is not None]
        if len(live) <= 1:
            return None
        victim = max(live, key=lambda s: (s.admit_step, s.slot))
        slot = victim.slot
        self._release_slot(victim)
        victim.status = "waiting"
        victim.preemptions += 1
        victim.replay_idx = 0
        self.waiting.appendleft(victim)   # readmitted first
        return slot

    def _preflight(self, active_mask: np.ndarray) -> None:
        if not self.protected:
            return
        while True:
            needed = sum(layer.freeze_candidates(active_mask)
                         for layer in self.caches.layers.values())
            if needed <= self.pool.available:
                return
            slot = self._preempt_one()
            if slot is None:
                raise PoolExhausted(
                    f"next step freezes need {needed} pool pages, only "
                    f"{self.pool.available} free and nothing to preempt: "
                    "grow capacity_pages or lower max_active")
            active_mask[slot] = False

    # -- the step -----------------------------------------------------------

    @torch.no_grad()
    def step(self) -> dict:
        """One engine tick: admit, preflight capacity, one batched decode
        step across the active slots, retire finished sequences, and the
        scrub when due. Returns the step's report.

        Under `repro_torch.obs` the tick is one `engine.step` span with
        its children, the step counters and latency go to the ambient
        registry, and an ambient RAS estimator drives the scrub schedule
        (`_due_for_scrub`, `prioritize=True`)."""
        t_start = time.perf_counter()
        with span("engine.step", step=self._step_no) as sp:
            report = self._step_inner(sp)
        reg = obs_metrics.current()
        if reg.enabled:
            reg.counter("engine_steps", layer="engine").inc()
            reg.counter("engine_tokens", layer="engine").inc(
                report["tokens"])
            reg.counter("engine_retired", layer="engine").inc(
                report["retired"])
            reg.counter("engine_preemptions", layer="engine").inc(
                report["preempted"])
            reg.histogram("engine_step_seconds", layer="engine").observe(
                time.perf_counter() - t_start)
            reg.gauge("engine_active_slots", layer="engine").set(
                report["active"])
        return report

    def _step_inner(self, sp) -> dict:
        from ..models import lm
        with span("engine.admit"):
            admitted = self._admit()
        active_mask = np.zeros(self.max_active, bool)
        tokens = np.zeros((self.max_active, 1), np.int64)
        pos = np.zeros(self.max_active, np.int64)
        for b, seq in enumerate(self.slots):
            if seq is None:
                continue
            active_mask[b] = True
            tokens[b, 0] = seq.generated[seq.replay_idx]
            pos[b] = len(seq.prompt) + seq.replay_idx
        report = {"step": self._step_no, "admitted": len(admitted),
                  "active": int(active_mask.sum()), "tokens": 0,
                  "retired": 0, "preempted": 0}
        sp.set(active=report["active"], admitted=report["admitted"])
        if not active_mask.any():
            self._step_no += 1
            return report
        pre = sum(s.preemptions for s in self.sequences)
        self._preflight(active_mask)
        report["preempted"] = sum(s.preemptions
                                  for s in self.sequences) - pre
        if report["preempted"]:
            tr = obs_trace.current()
            if tr.enabled:
                tr.instant("engine.preempt", count=report["preempted"])
        if not active_mask.any():
            self._step_no += 1
            return report
        self.caches.set_active(active_mask)
        with span("engine.decode", step=self._step_no,
                  active=report["active"]):
            logits, _ = lm.decode_step(
                self.params, self.cfg, self.caches,
                torch.as_tensor(tokens, device=self.device), pos)
            # the sampled tokens stay on the device until after the scrub,
            # so its scans queue behind the decode step instead of waiting
            # for it
            nxt_dev = logits[:, -1, :].argmax(dim=-1)
        self._step_no += 1
        if self.protected:
            self._touch_pages()
            if self.scrub_every and self._due_for_scrub():
                # a scrub moves storage toward clean, so the memoized
                # corrected views stay valid: no invalidation
                est = obs_ras.current()
                with span("engine.scrub") as ssp:
                    rep = self.pool.scrub(max_pages=self.scrub_max_pages,
                                          now=self._step_no,
                                          min_age=self.scrub_min_age,
                                          prioritize=est.enabled)
                    ssp.set(pages=rep["pages"],
                            flagged=rep["flagged_words"],
                            repaired=rep["repaired_words"])
                self.scrub_reports.append(rep)
                report["scrubbed_pages"] = rep["pages"]
        with span("engine.sample_sync", step=self._step_no - 1):
            nxt = nxt_dev.tolist()
        for b, seq in enumerate(self.slots):
            if seq is None or not active_mask[b]:
                continue
            report["tokens"] += 1
            if seq.replay_idx < len(seq.generated) - 1:
                seq.replay_idx += 1          # teacher-forced replay
            else:
                seq.generated.append(int(nxt[b]))
                seq.replay_idx += 1
            if len(seq.generated) >= seq.max_new:
                self._release_slot(seq)
                seq.status = "done"
                report["retired"] += 1
        return report

    def _due_for_scrub(self) -> bool:
        """The fixed `scrub_every` cadence, unless an ambient RAS estimator
        is installed: then the period is `adaptive_interval(scrub_every)`,
        shorter while pages flag above the estimator's target rate and
        longer when the pool is quiet. As in the JAX engine, it reads the
        estimator's default region "", which only owner-less reads and
        scrubs feed (tenants' pages feed their tenants' regions)."""
        est = obs_ras.current()
        interval = self.scrub_every
        if est.enabled:
            interval = max(1, est.adaptive_interval(self.scrub_every))
        return self._step_no % interval == 0

    def _touch_pages(self) -> None:
        for b, seq in enumerate(self.slots):
            if seq is None:
                continue
            for layer in self.caches.layers.values():
                for pid in layer.slot_pages(b):
                    self.pool.touch(pid, self._step_no)

    def _invalidate_all(self) -> None:
        for layer in self.caches.layers.values():
            layer.invalidate()

    def run(self, max_steps: int = 100000) -> dict[Any, list[int]]:
        """Step until every submitted sequence finishes. Returns
        {tenant: generated tokens}."""
        steps = 0
        while self.waiting or any(s is not None for s in self.slots):
            if steps >= max_steps:
                raise RuntimeError(f"run() exceeded {max_steps} steps")
            self.step()
            steps += 1
        return {s.tenant: list(s.generated) for s in self.sequences}

    # -- fault injection / stats --------------------------------------------

    def inject(self, channel, key=None, *, tenants=None, **kw) -> int:
        """Corrupt the shared pool mid-serving (optionally only pages owned
        by `tenants`; `key` a seed or a generator, see `pool.inject`) and
        drop the memoized views, so the next step's reads go through the
        decoder."""
        if not self.protected:
            return 0
        changed = self.pool.inject(channel, key, owners=tenants, **kw)
        self._invalidate_all()
        return changed

    @staticmethod
    def _slot_stores(layer, b: int):
        """The live `PooledStore`s behind slot b of one KV layer (none for
        dense layers)."""
        for name in ("k_stores", "v_stores"):
            stores = getattr(layer, name, None)
            if stores is not None and stores[b] is not None:
                yield stores[b]

    def tenant_stats(self, tenant) -> dict[str, int]:
        """One tenant's correction accounting: counters banked from its
        retired or preempted slots, its live slot stores, and the pool's
        per-owner scrub attribution."""
        out = dict.fromkeys(
            ControllerStats.CORRECTION_KEYS + ("scrub_flagged",
                                               "scrub_repaired"), 0)
        for seq in self.sequences:
            if seq.tenant != tenant:
                continue
            # banked counters and live stores are disjoint: close_slot
            # banks and frees in one motion (see _release_slot)
            ControllerStats.add_counts(out, seq.stats)
            if seq.slot is not None:
                for layer in self.caches.layers.values():
                    for store in self._slot_stores(layer, seq.slot):
                        ControllerStats.add_counts(out, store.stats)
        if self.protected:
            ent = self.pool.scrub_by_owner.get(tenant)
            if ent:
                out["scrub_flagged"] = ent["flagged_words"]
                out["scrub_repaired"] = ent["repaired_words"]
        return out

    def publish_metrics(self, registry=None) -> None:
        """Export the engine's accounting into a metrics registry (the
        ambient one by default): each tenant's correction triple and scrub
        attribution as `tenant_*` gauges, and the pool's `ControllerStats`,
        `pool_allocated` and `pool_available`. Gauges are set, so repeated
        publishes do not double count."""
        reg = obs_metrics.current() if registry is None else registry
        if not getattr(reg, "enabled", False):
            return
        tenants = {}
        for s in self.sequences:
            tenants.setdefault(str(s.tenant), s.tenant)
        for label in sorted(tenants):
            for k, v in self.tenant_stats(tenants[label]).items():
                reg.gauge(f"tenant_{k}", layer="engine",
                          tenant=label).set(v)
        if self.protected:
            self.pool.stats.publish(reg, layer="pool")
            reg.gauge("pool_allocated", layer="pool").set(
                self.pool.n_allocated)
            reg.gauge("pool_available", layer="pool").set(
                self.pool.available)

    def stats(self) -> dict:
        live = sum(s is not None for s in self.slots)
        out = {"step": self._step_no, "active": live,
               "waiting": len(self.waiting),
               "done": sum(s.done for s in self.sequences),
               "preemptions": sum(s.preemptions for s in self.sequences)}
        if self.protected:
            out["pool_allocated"] = self.pool.n_allocated
            out["pool_available"] = self.pool.available
            out["scrub_rounds"] = self.pool.stats.scrub_rounds
        return out
