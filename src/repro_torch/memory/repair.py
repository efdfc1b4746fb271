"""Coalescing repair pipeline: cross-page flagged-word batching.

At raw BER 1e-3 a page of 256 words carries a handful of flagged rows;
decoding each page's flags on their own and waiting for each before the
next makes decode dispatch, not the scan, the sweep bottleneck.
`RepairQueue` decouples flag discovery from repair:

- **accumulate** — `enqueue()` collects flagged (b, n) level-word batches
  from anywhere (controller pages, several stores), each with a writeback
  closure, an owner label for per-owner attribution, and provenance;
- **chunked decode** — `drain()` concatenates everything queued and
  decodes it in `chunk_size`-row chunks, the tail at its own row count.
  The JAX package (`repro.memory.repair`) pads the tail with zero words
  up to a power-of-two bucket so that it reuses a compiled executable;
  eager PyTorch compiles nothing, so the port pads nothing and its drain
  reports carry no pad fields;
- **one decode per drain** — the whole batch is decoded first and the
  repairs scatter back through the writebacks afterwards. FBP is
  row-independent (per-codeword early exit), so decoding rows in a
  coalesced batch is bit-exact with decoding them per page.

Queue depth, drain latency and repair counts feed `repro_torch.obs`
metrics, and each drained entry's iteration vector feeds the RAS estimator
in its owner's region, as in the JAX package; all of it free when no
registry or estimator is installed. The `repair_pad_rows` counter is
always 0 here, since nothing is padded.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable

import torch

from ..core.construction import LDPCCode
from ..core.decode import decode_integers
from ..core.gf import symbol_dtype
from ..device import resolve_device
from ..distributed.sharding import decode_sharded
from ..obs import metrics as obs_metrics
from ..obs import ras as obs_ras

__all__ = ["RepairQueue"]


@dataclasses.dataclass
class _Entry:
    """One enqueued batch of flagged rows awaiting the next drain."""

    words: torch.Tensor         # (rows, n) flagged level-words
    writeback: Callable         # (symbols (rows, n), ok (rows,)) -> None
    owner: object               # label for per-owner attribution
    provenance: tuple           # e.g. ("page", page_index, row_indices)
    rows: int


class RepairQueue:
    """Accumulates flagged codeword rows across pages/stores and drains
    them through chunked decodes with one host sync."""

    def __init__(self, code: LDPCCode, *, chunk_size: int = 256,
                 n_iters: int = 10,
                 damping: float = 0.3, llv_scale: float = 4.0,
                 llv_mode: str = "manhattan", device=None, mesh=None):
        self.code = code
        self.device = resolve_device(device)
        self.mesh = mesh
        self.chunk_size = int(chunk_size)
        self.n_iters = n_iters
        self.damping = damping
        self.llv_scale = llv_scale
        self.llv_mode = llv_mode
        self._entries: list[_Entry] = []
        self._pending = 0

    def decode_batch(self, words: torch.Tensor):
        """Decode (B, n) flagged level-words in `chunk_size` chunks, each
        fanned over `mesh` (`decode_sharded`) when the queue has one.
        Returns (symbols (B, n) in symbol_dtype(p), fail (B,) bool,
        iterations (B,) int32), tensors on the queue's device."""
        words = words.to(self.device)
        if words.shape[0] == 0:
            n = self.code.n
            return (torch.zeros((0, n), dtype=symbol_dtype(self.code.p),
                                device=self.device),
                    torch.zeros(0, dtype=torch.bool, device=self.device),
                    torch.zeros(0, dtype=torch.int32, device=self.device))
        kw = dict(n_iters=self.n_iters, llv_scale=self.llv_scale,
                  llv_mode=self.llv_mode, damping=self.damping,
                  early_exit=True)
        syms, fail, iters = [], [], []
        for chunk in torch.split(words, self.chunk_size):
            chunk = chunk.to(torch.int32)
            if self.mesh is None:
                _y, res = decode_integers(self.code, chunk, observe=False,
                                          **kw)
            else:
                _y, res = decode_sharded(self.code, chunk, mesh=self.mesh,
                                         **kw)
            syms.append(res.symbols)
            fail.append(res.detect_fail)
            iters.append(res.iterations)
        return torch.cat(syms), torch.cat(fail), torch.cat(iters)

    # -- queue surface ------------------------------------------------------

    @property
    def pending_words(self) -> int:
        return self._pending

    def enqueue(self, words: torch.Tensor, writeback, *, owner=None,
                provenance: tuple = ()) -> None:
        """Queue (rows, n) flagged level-words for the next drain.
        `writeback(symbols, ok)` is called with the decoded (rows, n) int8
        symbols and the (rows,) repaired mask; `owner` labels the rows for
        per-owner attribution in the drain report."""
        rows = int(words.shape[0])
        if rows == 0:
            return
        self._entries.append(
            _Entry(words, writeback, owner, tuple(provenance), rows))
        self._pending += rows

    def drain(self) -> dict:
        """Decode everything queued as one coalesced batch, scatter repairs
        through each entry's writeback, and report words / repaired / pad
        by_owner."""
        entries, self._entries = self._entries, []
        pending, self._pending = self._pending, 0
        if not entries:
            return {"entries": 0, "words": 0, "repaired": 0, "failed": 0,
                    "by_owner": {}, "seconds": 0.0}
        t0 = time.perf_counter()
        batch = torch.cat([e.words.to(self.device) for e in entries])
        syms, fail, iters = self.decode_batch(batch)
        ok_all = ~fail
        est = obs_ras.current()
        by_owner: dict[object, dict] = {}
        lo = 0
        for e in entries:
            ok = ok_all[lo:lo + e.rows]
            e.writeback(syms[lo:lo + e.rows], ok)
            ent = by_owner.setdefault(
                e.owner, {"flagged_words": 0, "repaired_words": 0})
            ent["flagged_words"] += e.rows
            ent["repaired_words"] += int(ok.sum())
            if est.enabled:
                est.observe_decode(iters[lo:lo + e.rows], self.n_iters,
                                   detect_fail=fail[lo:lo + e.rows],
                                   region=str(e.owner)
                                   if e.owner is not None else "")
            lo += e.rows
        repaired = int(ok_all.sum())
        dt = time.perf_counter() - t0
        reg = obs_metrics.current()
        if reg.enabled:
            reg.histogram("repair_queue_depth", layer="repair").observe(
                pending)
            reg.histogram("repair_drain_seconds", layer="repair").observe(dt)
            reg.counter("repair_drains", layer="repair").inc()
            reg.counter("repair_rows", layer="repair").inc(pending)
            reg.counter("repair_pad_rows", layer="repair").inc(0)
            reg.counter("repair_repaired", layer="repair").inc(repaired)
            reg.counter("repair_uncorrectable", layer="repair").inc(
                pending - repaired)
        return {"entries": len(entries), "words": pending,
                "repaired": repaired, "failed": pending - repaired,
                "by_owner": by_owner, "seconds": dt}
