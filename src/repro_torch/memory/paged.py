"""`PagedProtectedStore`: the device-resident protected store.

Where `ProtectedMemoryArray` holds whole tensors for checkpoint-style
reads, this store keeps fixed-shape (page_words, n) pages of GF(p) cells
(int8) on the device, so protection can sit under a live workload:

- **encode on the device** — appended info words go through
  `core.encode_words` (the `gf_matmul` CUDA kernel on the card); pages
  never round-trip through the host;
- **scan on the device** — per-page syndrome flags from the fused
  `scan_syndromes` kernel;
- **corrected reads** — `read_page_corrected` scans a page and decodes it
  only when a word flags (clean pages skip the decoder), with the
  correction accounting on the store's `ControllerStats`;
  `iter_corrected` streams every page that way, page i+1 dispatched
  before page i is yielded; `decode_stream` is the raw
  `core.decode_pipelined` over the pages. On the card this lookahead
  reorders the work but does not overlap it: the scan gate reads each
  page's flag count back to the host, and the decoder reads one byte back
  per early-exit iteration, so page i+1 is decoded before page i is
  yielded;
- **scrub** — scan, repair flagged words, write back: coalesced through
  the store's `RepairQueue` (one decode for the sweep), or page by page.

`read_page_corrected` feeds the ambient observability layer as the JAX
store's does: the page's scan and decode into the RAS estimator and the
correction counters into the metrics registry, under the store's `owner`
label (the tenant of a pool-backed store), free when neither is installed.

`quantize_tensor` / `dequantize_tensor` are the float <-> GF bridge of the
protected KV cache (`models/kv.py`): absmax int8 quantization, then base-p
symbolization (`memory/packing.py`), exactly as the JAX package's
`repro.memory.paged` does, so pages written by either decode in the other.

With `mesh` (a `distributed.sharding.Mesh` with a "data" axis) every page
is stored as row shards, rows [k·W/S, (k+1)·W/S) on the axis's device k
(`shard_page`), as the JAX store's pages are sharded row-wise: the scan
and the decode of a page run shard by shard, each on its own device, and
the repair queue decodes its flagged rows over the mesh
(`decode_sharded`). `page(i)` gathers a page onto the store's device, the
mesh's first (the compute device, where the fused attention reads it);
a write (an append, a scrub's repairs) replaces the page's shards, and
`inject` draws each page's faults on the compute device with the store's
generator, so a sharded store holds, reads and corrupts exactly what the
unsharded one does. `page_words` must be a multiple of the mesh size.

Pages are replaced, never written in place, so a tensor handed out by
`page(i)` keeps its contents when the store changes (as with the JAX
package's immutable arrays). The JAX store's kernel `policy` has no
counterpart: the wrappers pick kernel or plain version by the tensors'
device. The storage primitives (`page`, `_stored`, `_set_page`,
`_append_page`, `_iter_pages`) are what a pool-backed store overrides.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Iterator

import torch
import torch.nn.functional as F

from ..core.codes import get_code
from ..core.construction import LDPCCode
from ..core.encode import encode_words
from ..core.protected import decode_pipelined, np_prod_mesh
from ..device import as_tensor, generator, resolve_device
from ..core.gf import symbol_dtype
from ..distributed.sharding import (axis_devices, decode_shards,
                                    gather_decode, gather_rows, scan_shards,
                                    shard_page)
from ..obs import metrics as obs_metrics
from ..obs import ras as obs_ras
from .channel import Channel
from .controller import ControllerStats
from .packing import desymbolize_u8, digits_per_byte, symbolize_u8
from .repair import RepairQueue

__all__ = ["PagedProtectedStore", "QuantizedTensor", "quantize_tensor",
           "dequantize_tensor", "words_for_tensor"]


# ---------------------------------------------------------------------------
# float tensor <-> info words (the KV-cache quantization bridge)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """What is needed to reassemble a tensor from its info words."""

    shape: tuple
    dtype: torch.dtype
    scale: torch.Tensor         # () float32 absmax scale, on the device
    n_words: int                # info words the tensor occupies


def words_for_tensor(shape, p: int, k: int) -> int:
    """Info words an int8-quantized tensor of `shape` packs into."""
    numel = math.prod(shape) if shape else 1
    return math.ceil(numel * digits_per_byte(p) / k) if numel else 0


def quantize_tensor(x: torch.Tensor, p: int, k: int
                    ) -> tuple[torch.Tensor, QuantizedTensor]:
    """absmax-int8 quantize, symbolize and pack: float tensor -> ((m, k)
    int8 info words in [0, p), QuantizedTensor). Padding digits are zero
    (they decode to bytes that are sliced off)."""
    shape, dtype = tuple(x.shape), x.dtype
    xf = x.to(torch.float32).reshape(-1)
    absmax = (xf.abs().max() if xf.numel()
              else torch.zeros((), dtype=torch.float32, device=x.device))
    scale = torch.clamp_min(absmax, 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    digits = symbolize_u8(q + 128, p).reshape(-1)      # bytes in [1, 255]
    m = words_for_tensor(shape, p, k)
    digits = F.pad(digits, (0, m * k - digits.numel()))
    return digits.reshape(m, k), QuantizedTensor(shape, dtype, scale, m)


def dequantize_tensor(words: torch.Tensor, meta: QuantizedTensor,
                      p: int) -> torch.Tensor:
    """(m, k) decoded info words -> the tensor of `meta.shape`. Symbols
    left uncorrected degrade to wrong values, never to a crash (digits are
    clipped into the field)."""
    numel = math.prod(meta.shape) if meta.shape else 1
    D = digits_per_byte(p)
    digits = words.reshape(-1)[:numel * D].reshape(numel, D)
    q = desymbolize_u8(digits, p).to(torch.float32) - 128.0
    return (q * meta.scale).to(meta.dtype).reshape(meta.shape)


# ---------------------------------------------------------------------------
# the device-resident paged store
# ---------------------------------------------------------------------------


class PagedProtectedStore:
    """Fixed-shape (page_words, n) GF-level pages on one device, or row
    shards over a mesh, with device encode, per-page syndrome flags and
    corrected reads. Pages are int8 while p <= 128 (`symbol_dtype(p)` past
    it); encode and scan go to the kernels or, for fields past int8 or the
    int32 bound, to the exact product (`gf_matmul.field_route`)."""

    def __init__(self, code: str | LDPCCode = "wl1024_r08", *,
                 page_words: int = 256, mesh=None, n_iters: int = 10,
                 damping: float = 0.3, llv_scale: float = 4.0,
                 llv_mode: str = "manhattan", key: int = 0, device=None):
        self.code = get_code(code) if isinstance(code, str) else code
        self.dtype = symbol_dtype(self.code.p)
        if page_words <= 0:
            raise ValueError(f"page_words must be positive, got {page_words}")
        if mesh is not None:
            mesh_size = np_prod_mesh(mesh)
            if page_words % mesh_size != 0:
                raise ValueError(
                    f"page_words={page_words} is not a multiple of the mesh "
                    f"size {mesh_size}; pages are shard_map'd row-wise, so "
                    "pick a page size divisible by the device count")
            if device is None:
                device = mesh.device
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"store on {device}, mesh on "
                                 f"{mesh.device.type} devices")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.page_words = page_words
        self.n_iters = n_iters
        self.damping = damping
        self.llv_scale = llv_scale
        self.llv_mode = llv_mode
        self._pages: list[torch.Tensor] = []    # (page_words, n) levels
        self._n_words = 0                       # valid words across pages
        self._gen = torch.Generator(device=self.device).manual_seed(key)
        self._repair_q: RepairQueue | None = None
        # read/scrub correction accounting, per store
        self.stats = ControllerStats()

    # -- introspection ------------------------------------------------------

    @property
    def n_words(self) -> int:
        return self._n_words

    @property
    def n_pages(self) -> int:
        return len(self._pages)

    @property
    def n_cells(self) -> int:
        return self._n_words * self.code.n

    # -- page layout: a tensor, or a tuple of row shards over the mesh ------

    def _split(self, page: torch.Tensor):
        """A (page_words, n) page in the store's layout."""
        return page if self.mesh is None else shard_page(page, self.mesh)

    def _join(self, stored) -> torch.Tensor:
        """A stored page as one tensor on the store's device."""
        if isinstance(stored, torch.Tensor):
            return stored
        return gather_rows(stored, self.device)

    @staticmethod
    def _parts(stored) -> tuple:
        """A stored page's row blocks, each on its own device (a tensor,
        such as one poked in as `store._pages[i] = ...`, is one block)."""
        return (stored,) if isinstance(stored, torch.Tensor) else stored

    def _zeros(self):
        """A zeroed page in the store's layout, each shard made on its
        own device."""
        if self.mesh is None:
            return torch.zeros((self.page_words, self.code.n),
                               dtype=self.dtype, device=self.device)
        devices = axis_devices(self.mesh)
        rows = self.page_words // len(devices)
        return tuple(torch.zeros((rows, self.code.n), dtype=self.dtype,
                                 device=d) for d in devices)

    # -- storage primitives (a pool-backed store overrides these) -------------

    def page(self, i: int) -> torch.Tensor:
        return self._join(self._pages[i])

    def _stored(self, i: int):
        """Page `i` in the store's layout (its shards)."""
        return self._pages[i]

    def _set_page(self, i: int, page: torch.Tensor) -> None:
        self._pages[i] = self._split(page)

    def _append_page(self) -> None:
        """Grow storage by one zeroed page."""
        self._pages.append(self._zeros())

    def _iter_pages(self) -> Iterator[torch.Tensor]:
        for i in range(self.n_pages):
            yield self.page(i)

    def free(self) -> None:
        """Release all storage."""
        self._pages.clear()
        self._n_words = 0

    # -- the kernels' calls ---------------------------------------------------

    def _scan(self, stored) -> torch.Tensor:
        """(page_words,) bool nonzero-syndrome flags of one stored page,
        one scan per shard on the shard's device, gathered onto the
        store's device."""
        flags = scan_shards(self.code, self._parts(stored))
        return flags[0] if len(flags) == 1 else gather_rows(flags,
                                                            self.device)

    def _decode(self, stored):
        """(y_corrected, DecodeResult) of a whole stored page, early exit
        on, one decode per shard on the shard's device, gathered onto the
        store's device."""
        outs = decode_shards(
            self.code, self._parts(stored), n_iters=self.n_iters,
            damping=self.damping, llv_scale=self.llv_scale,
            llv_mode=self.llv_mode, early_exit=True)
        return outs[0] if len(outs) == 1 else gather_decode(outs,
                                                            self.device)

    def _repair_queue(self) -> RepairQueue:
        """The queue this store's coalesced scrubs drain through (over
        the mesh, when the store has one)."""
        if self._repair_q is None:
            self._repair_q = RepairQueue(
                self.code, chunk_size=self.page_words, n_iters=self.n_iters,
                damping=self.damping, llv_scale=self.llv_scale,
                llv_mode=self.llv_mode, device=self.device, mesh=self.mesh)
        return self._repair_q

    # -- write path ---------------------------------------------------------

    def _put_rows(self, enc: torch.Tensor) -> tuple[int, int]:
        """Pack (m, n) codewords into pages after the valid words. A
        partly filled trailing page is padded with all-zero words (valid
        codewords, scan-neutral) and topped up by the next append."""
        m = enc.shape[0]
        start = self._n_words
        pw = self.page_words
        done = 0
        while done < m:
            slot = self._n_words % pw
            if slot == 0:
                self._append_page()
            take = min(m - done, pw - slot)
            last = self.n_pages - 1
            page = self.page(last).clone()
            page[slot:slot + take] = enc[done:done + take]
            self._set_page(last, page)
            done += take
            self._n_words += take
        self.stats.writes += 1
        self.stats.words_written += m
        return start, start + m

    def append_words(self, u) -> tuple[int, int]:
        """Append (m, k) info words (field symbols in [0, p)): encode on the
        device and pack into pages. Returns the occupied word range
        [start, start + m)."""
        u = as_tensor(u, self.device)
        if u.dim() != 2 or u.shape[1] != self.code.k:
            raise ValueError(f"expected (m, {self.code.k}) info words, got "
                             f"{tuple(u.shape)}")
        enc = encode_words(u.to(self.dtype), self.code)
        return self._put_rows(enc)

    def append_encoded(self, enc) -> tuple[int, int]:
        """Adopt already-encoded (m, n) codewords (e.g. cells exported by
        another store) without re-encoding."""
        enc = as_tensor(enc, self.device)
        if enc.dim() != 2 or enc.shape[1] != self.code.n:
            raise ValueError(f"expected (m, {self.code.n}) codewords, got "
                             f"{tuple(enc.shape)}")
        return self._put_rows(enc.to(self.dtype))

    def export_words(self) -> torch.Tensor:
        """All valid stored codewords as one (n_words, n) tensor."""
        if not self.n_pages:
            return torch.zeros((0, self.code.n), dtype=self.dtype,
                               device=self.device)
        return torch.cat(list(self._iter_pages()))[:self._n_words]

    # -- fault injection ----------------------------------------------------

    def inject(self, channel: Channel,
               key: int | torch.Generator | None = None, *, t: float = 0.0,
               n_reads: int = 0) -> int:
        """Corrupt the stored pages through a level-domain channel model.
        `key` is a seed or a generator on the store's device; without one
        the store's own generator is drawn on, so repeated injections
        differ. Returns the number of cells changed. Pad rows of the
        trailing page are storage like any other and are corrupted too."""
        if channel.p != self.code.p:
            raise ValueError(f"channel alphabet {channel.p} != "
                             f"GF({self.code.p})")
        gen = generator(key, self._gen, self.device)
        changed = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(self.n_pages):
            page = self.page(i)
            new = channel.apply(gen, page, t=t, n_reads=n_reads).to(
                self.dtype)
            changed += (new != page).sum()
            self._set_page(i, new)
        return int(changed)

    # -- read path ----------------------------------------------------------

    def scan_flags(self) -> torch.Tensor:
        """(n_words,) bool per-word nonzero-syndrome flags."""
        if not self.n_pages:
            return torch.zeros(0, dtype=torch.bool, device=self.device)
        flags = torch.cat([self._scan(self._stored(i))
                           for i in range(self.n_pages)])
        return flags[:self._n_words]

    def iter_corrected(self, *, scan_first: bool = True,
                       depth: int = 1) -> Iterator[torch.Tensor]:
        """Yield (page_words, n) corrected symbol pages in storage order,
        `depth` pages dispatched ahead of the one yielded (the JAX store's
        contract). On the card that reorders and does not overlap: the
        scan gate and the decoder's early exit each read a count back to
        the host, so page i+1's decode has finished before page i reaches
        its consumer. With `scan_first`, clean pages skip the decoder
        (only flagged pages pay for FBP)."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")

        def dispatch(i):
            stored = self._stored(i)
            if scan_first:
                nf = int(self._scan(stored).sum())
                if not nf:                       # clean: levels ARE symbols
                    return self._join(stored)
                self.stats.detected += nf
            return self._decode(stored)[1].symbols

        pending = []
        for i in range(self.n_pages):
            self.stats.reads += 1
            self.stats.words_read += self.page_words
            pending.append(dispatch(i))
            if len(pending) > depth:
                yield pending.pop(0)
        yield from pending

    def read_page_corrected(self, i: int) -> torch.Tensor:
        """Scan-gated corrected read of page `i`, with the correction
        accounting (detected / corrected / uncorrectable) on `stats`, and
        the telemetry attributed to the store's `owner`."""
        stored = self._stored(i)
        self.stats.reads += 1
        self.stats.words_read += self.page_words
        flags = self._scan(stored)
        nf = int(flags.sum())
        est = obs_ras.current()
        owner = getattr(self, "owner", None)
        region = str(owner) if owner is not None else ""
        if est.enabled:
            est.observe_scan(nf, self.page_words, n_symbols=self.code.n,
                             region=region)
        if not nf:
            return self._join(stored)
        self.stats.detected += nf
        _y, res = self._decode(stored)
        bad = int((flags & res.detect_fail).sum())
        self.stats.uncorrectable += bad
        self.stats.corrected += nf - bad
        reg = obs_metrics.current()
        if reg.enabled:
            lab = {"layer": "paged", "tenant": region,
                   "code": f"gf{self.code.p}n{self.code.n}"}
            reg.counter("mem_detected", **lab).inc(nf)
            reg.counter("mem_corrected", **lab).inc(nf - bad)
            reg.counter("mem_uncorrectable", **lab).inc(bad)
        if est.enabled:
            est.observe_decode(res.iterations, self.n_iters,
                               detect_fail=res.detect_fail, region=region)
        return res.symbols

    def read_corrected(self) -> torch.Tensor:
        """Whole-store corrected read: every page decoded, stacked to
        (n_words, n) symbols (the baseline of the pipelined read)."""
        if not self.n_pages:
            return torch.zeros((0, self.code.n), dtype=self.dtype,
                               device=self.device)
        outs = [self._decode(self._stored(i))[1].symbols
                for i in range(self.n_pages)]
        return torch.cat(outs)[:self._n_words]

    def read_words(self, start: int, stop: int, *,
                   corrected: bool = True) -> torch.Tensor:
        """Stored words [start, stop) across pages, corrected through the
        per-page scan and decode, or raw levels."""
        if not 0 <= start <= stop <= self._n_words:
            raise ValueError(f"word range [{start}, {stop}) outside "
                             f"[0, {self._n_words})")
        if start == stop:
            return torch.zeros((0, self.code.n), dtype=self.dtype,
                               device=self.device)
        pw = self.page_words
        out = []
        for pi in range(start // pw, (stop - 1) // pw + 1):
            page = (self.read_page_corrected(pi) if corrected
                    else self.page(pi))
            out.append(page[max(start - pi * pw, 0):min(stop - pi * pw, pw)])
        return torch.cat(out)

    def read_info(self, start: int, stop: int, *,
                  corrected: bool = True) -> torch.Tensor:
        """`read_words` sliced to the (m, k) info symbols, the shape
        `dequantize_tensor` takes."""
        return self.read_words(start, stop,
                               corrected=corrected)[:, :self.code.k]

    def decode_stream(self, **kw) -> Iterator:
        """`core.decode_pipelined` over the stored pages (over the store's
        mesh by default, each page's shards decoded where they lie): one
        `(y_corrected, DecodeResult)` per page, for callers that need the
        decode's metadata."""
        kw.setdefault("chunk_size", self.page_words)
        kw.setdefault("mesh", self.mesh)
        kw.setdefault("n_iters", self.n_iters)
        kw.setdefault("damping", self.damping)
        kw.setdefault("llv_scale", self.llv_scale)
        kw.setdefault("llv_mode", self.llv_mode)
        pages = self._iter_pages()
        if self.mesh is not None and kw["mesh"] is self.mesh:
            pages = (tuple(self._parts(self._stored(i)))
                     for i in range(self.n_pages))
        return decode_pipelined(self.code, pages, **kw)

    # -- scrub --------------------------------------------------------------

    def scrub(self, pages=None, *, coalesce: bool = True) -> dict:
        """Sweep the pages (all, or the indices in `pages`): scan, repair
        flagged words, write back. Returns {pages, flagged_words,
        repaired_words, coalesced}.

        `coalesce=True` scans every page first (one host read of all the
        masks), queues the flagged rows of every page on the store's
        `RepairQueue` and decodes them in one drain. `coalesce=False` is
        the per-page baseline: each flagged page is decoded whole. Both
        repair the same words (decoding is row-independent)."""
        idxs = list(range(self.n_pages) if pages is None else pages)
        report = (self._scrub_coalesced(idxs) if coalesce
                  else self._scrub_baseline(idxs))
        self.stats.scrub_rounds += 1
        self.stats.scrub_words += report["pages"] * self.page_words
        self.stats.scrub_corrected += report["repaired_words"]
        self.stats.scrub_uncorrectable += (report["flagged_words"]
                                           - report["repaired_words"])
        return report

    def _scrub_baseline(self, idxs: list[int]) -> dict:
        flagged_words = repaired = 0
        for i in idxs:
            stored = self._stored(i)
            flags = self._scan(stored)
            nf = int(flags.sum())
            if not nf:
                continue
            flagged_words += nf
            _y, res = self._decode(stored)
            page = self._join(stored)
            good = flags & ~res.detect_fail
            self._set_page(i, torch.where(good[:, None], res.symbols, page))
            repaired += int(good.sum())
        return {"pages": len(idxs), "flagged_words": flagged_words,
                "repaired_words": repaired, "coalesced": False}

    def _scrub_coalesced(self, idxs: list[int]) -> dict:
        if not idxs:
            return {"pages": 0, "flagged_words": 0, "repaired_words": 0,
                    "coalesced": True}
        masks = torch.stack([self._scan(self._stored(i))
                             for i in idxs]).cpu()
        queue = self._repair_queue()
        flagged_words = 0
        for i, mask in zip(idxs, masks, strict=True):
            rows = torch.nonzero(mask).flatten().to(self.device)
            if not rows.numel():
                continue
            flagged_words += int(rows.numel())
            page = self.page(i)

            def writeback(syms, ok, i=i, rows=rows, page=page):
                good = rows[ok]
                if good.numel():
                    new = page.clone()
                    new[good] = syms[ok].to(self.dtype)
                    self._set_page(i, new)

            queue.enqueue(page[rows], writeback,
                          owner=getattr(self, "owner", None),
                          provenance=("store", i, rows))
        rep = queue.drain()
        return {"pages": len(idxs), "flagged_words": flagged_words,
                "repaired_words": rep["repaired"], "coalesced": True,
                "drain": {k: rep[k] for k in (
                    "entries", "words", "repaired", "failed", "seconds")}}
