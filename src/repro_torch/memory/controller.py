"""Memory-controller policies for NB-LDPC-protected storage.

Modeled on the classic ECC-memory-controller taxonomy (basic / write-back /
refresh):

- **basic** — correct read responses, never touch the stored words; latent
  errors accumulate in storage until they exceed the code's strength.
- **writeback** — additionally rewrite every corrected word back into
  storage on read, so each read also repairs (read-triggered refresh).
- **scrub** — writeback plus a periodic background sweep over the whole
  array: every stored word is scanned, flagged words are batch-decoded and
  repaired in place. `interval` counts read/write operations between
  automatic sweeps; `scrub()` can also be called explicitly.

All policies share the same read path: the fused syndrome scan
(`repro_torch.kernels.scan_syndromes`, the CUDA kernel on the card) over
the stored int8 words, or the exact product for codes past the kernel's
int8 symbols or int32 bound (`_scan_route`, as the JAX controller's), then
the decoder runs ONLY on flagged words,
through the controller's `RepairQueue`. Sweeps use the coalesced repair
pipeline (pages are scanned a window ahead, flagged rows from many pages
are queued and decoded together) or, with `coalesce=False`, the per-page
baseline it is measured against. Per-policy counters (detected / corrected
/ uncorrectable / writebacks / scrub bandwidth) live in `ControllerStats`.
With `use_sharded` the scan and the decoder fan out over a device mesh
(`distributed.sharding`), as the JAX controller's do over its devices.

Every read and sweep also feeds the ambient observability layer
(`repro_torch.obs`), where the JAX controller does: correction counters
into the metrics registry, per-read and per-page scan-flag rates and the
decoder's iteration vectors into the RAS estimator. Both are free no-ops
unless `use_metrics` / `use_estimator` is active.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Iterable, Iterator

import torch

from ..core.construction import LDPCCode
from ..device import resolve_device
from ..core.gf import symbol_dtype
from ..distributed.sharding import data_mesh, scan_syndromes_sharded
from ..kernels.gf_matmul import field_route, scan_syndromes_routed
from ..obs import metrics as obs_metrics
from ..obs import ras as obs_ras
from .repair import RepairQueue

__all__ = ["ControllerStats", "MemoryController", "WritebackController",
           "ScrubController", "make_controller"]

# per-page entries kept in a sweep report; totals keep accumulating past
# this, so a million-page sweep does not hold millions of stat dicts
MAX_PAGE_STATS = 1024


@dataclasses.dataclass
class ControllerStats:
    reads: int = 0
    writes: int = 0
    words_read: int = 0
    words_written: int = 0
    detected: int = 0              # words with nonzero syndrome seen on read
    corrected: int = 0             # flagged words the decoder fixed
    uncorrectable: int = 0         # flagged words with residual syndrome
    writebacks: int = 0            # corrected words rewritten into storage
    scrub_rounds: int = 0
    scrub_words: int = 0           # words syndrome-scanned by scrubbing
    scrub_cells: int = 0           # cells scanned (words * n)
    scrub_corrected: int = 0
    scrub_uncorrectable: int = 0
    scrub_seconds: float = 0.0

    CORRECTION_KEYS = ("detected", "corrected", "uncorrectable")

    @property
    def scrub_bandwidth_cells_per_s(self) -> float:
        return self.scrub_cells / self.scrub_seconds if self.scrub_seconds \
            else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["scrub_bandwidth_cells_per_s"] = self.scrub_bandwidth_cells_per_s
        return d

    def merge(self, other: ControllerStats) -> ControllerStats:
        """Add another stats block into this one (every counter sums;
        returns self, so merges chain)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self

    def correction_counts(self) -> dict[str, int]:
        """The read-path correction triple."""
        return {k: getattr(self, k) for k in self.CORRECTION_KEYS}

    @staticmethod
    def add_counts(out: dict[str, int], src) -> dict[str, int]:
        """Add one correction-count source (a `ControllerStats` or a dict
        holding the triple) into `out` in place: the one merge behind every
        per-tenant sum of the serving engine."""
        get = src.correction_counts().get if isinstance(
            src, ControllerStats) else src.get
        for k in ControllerStats.CORRECTION_KEYS:
            out[k] = out.get(k, 0) + int(get(k, 0))
        return out

    def publish(self, registry, **labels) -> None:
        """Export every counter into a `MetricsRegistry` as gauges (the
        stats are cumulative totals, so a gauge set is idempotent across
        repeated publishes where a counter increment would double count)."""
        if registry is None or not getattr(registry, "enabled", False):
            return
        for f in dataclasses.fields(self):
            registry.gauge(f"controller_{f.name}", **labels).set(
                getattr(self, f.name))


class MemoryController:
    """`basic` policy: correct-on-read, storage untouched.

    `use_sharded` fans the device scan and the decoder over a mesh
    (`distributed.sharding.scan_syndromes_sharded` / `decode_sharded`):
    `mesh`, or every visible card (`data_mesh()`). By default it is on
    when a mesh is given or more than one card is visible, and never for
    CPU tensors, as the JAX controller's default is on with more than one
    device; a mesh with `use_sharded=False` raises. Every word is independent, so the results and `stats` equal
    the unsharded controller's bit for bit. Codes past the scan kernel's
    int8 symbols or int32 bound keep the exact scan (`_scan_route`)."""

    policy = "basic"

    def __init__(self, *, n_iters: int = 10, damping: float = 0.3,
                 llv_scale: float = 4.0, llv_mode: str = "manhattan",
                 chunk_size: int = 256, page_words: int | None = None,
                 device=None, use_sharded: bool | None = None, mesh=None):
        self.device = resolve_device(device)
        if use_sharded is None:
            use_sharded = mesh is not None or (
                self.device.type == "cuda" and torch.cuda.device_count() > 1)
        elif mesh is not None and not use_sharded:
            raise ValueError("a mesh with use_sharded=False: the "
                             "unsharded controller has no mesh")
        self.use_sharded = use_sharded
        self.mesh = None
        if use_sharded:
            self.mesh = data_mesh() if mesh is None else mesh
            if self.mesh.device.type != self.device.type:
                raise ValueError(f"controller on {self.device}, mesh on "
                                 f"{self.mesh.device.type} devices")
        self.n_iters = n_iters
        self.damping = damping
        self.llv_scale = llv_scale
        self.llv_mode = llv_mode
        self.chunk_size = chunk_size
        self.page_words = page_words          # default paging for sweeps
        self.stats = ControllerStats()

    # -- scan and decode ----------------------------------------------------

    def _repair_queue(self, code: LDPCCode) -> RepairQueue:
        """A coalescing repair queue for `code` with this controller's
        decoder settings."""
        return RepairQueue(code, chunk_size=self.chunk_size,
                           n_iters=self.n_iters, damping=self.damping,
                           llv_scale=self.llv_scale, llv_mode=self.llv_mode,
                           device=self.device, mesh=self.mesh)

    @staticmethod
    def _scan_route(code: LDPCCode) -> str:
        """Where a scan of `code` runs: "kernel" (the int8 scan kernel, its
        plain version on the CPU) or "exact" (the exact product, for GF(p)
        past int8 or n (p - 1)^2 >= 2^31), decided by the code alone."""
        return field_route(code.n, code.p)

    def _scan(self, code: LDPCCode, enc: torch.Tensor) -> torch.Tensor:
        """(B, n) stored words -> (B,) flags, on the words' device; over
        the mesh when the controller is sharded and the code takes the
        kernel."""
        if self.mesh is not None and self._scan_route(code) == "kernel":
            return scan_syndromes_sharded(code, enc, mesh=self.mesh)
        ht = code.tensor("H.T", enc.device, symbol_dtype(code.p))
        return scan_syndromes_routed(enc, ht, code.p)

    def _correct(self, code: LDPCCode, enc: torch.Tensor):
        """-> (corrected levels (B, n) int8, flagged, fail) without stats."""
        flagged = self._scan(code, enc)
        out = torch.remainder(enc, code.p)
        fail = torch.zeros_like(flagged)
        rows = torch.nonzero(flagged)[:, 0]
        if rows.numel():
            syms, f, iters = self._repair_queue(code).decode_batch(
                enc[rows])
            out[rows] = syms.to(out.device, out.dtype)
            fail[rows] = f.to(fail.device)
            est = obs_ras.current()
            if est.enabled:
                est.observe_decode(iters, self.n_iters, detect_fail=f)
        return out, flagged, fail

    # -- policy surface -----------------------------------------------------

    def read(self, code: LDPCCode, store: dict, name: str) -> torch.Tensor:
        st = store[name]
        out, flagged, fail = self._correct(code, st.enc)
        n_flagged = int(flagged.sum())
        n_fail = int(fail.sum())
        self.stats.reads += 1
        self.stats.words_read += st.enc.shape[0]
        self.stats.detected += n_flagged
        self.stats.corrected += n_flagged - n_fail
        self.stats.uncorrectable += n_fail
        reg = obs_metrics.current()
        if reg.enabled:
            labels = {"layer": "controller", "policy": self.policy,
                      "code": f"gf{code.p}n{code.n}"}
            reg.counter("mem_words_read", **labels).inc(st.enc.shape[0])
            reg.counter("mem_detected", **labels).inc(n_flagged)
            reg.counter("mem_corrected", **labels).inc(n_flagged - n_fail)
            reg.counter("mem_uncorrectable", **labels).inc(n_fail)
        est = obs_ras.current()
        if est.enabled:
            est.observe_scan(n_flagged, st.enc.shape[0], n_symbols=code.n)
        self._writeback(st, out, flagged, fail)
        return out

    def _writeback(self, st, corrected: torch.Tensor, flagged: torch.Tensor,
                   fail: torch.Tensor) -> None:
        pass                        # basic: never touch storage

    def note_write(self, n_words: int) -> None:
        self.stats.writes += 1
        self.stats.words_written += n_words

    def tick(self, code: LDPCCode, store: dict) -> None:
        pass                        # only the scrub policy acts on ticks

    @staticmethod
    def iter_pages(store: dict,
                   page_words: int | None = None) -> Iterator[torch.Tensor]:
        """Yield writable (b, n) row views over the stored words —
        `page_words` rows per page (ragged tails allowed), or one page per
        tensor when None. Repairs written into a page land in storage."""
        if page_words is not None and page_words <= 0:
            raise ValueError(f"page_words must be positive, got {page_words}")

        def gen():
            for st in store.values():
                enc = st.enc
                if page_words is None:
                    yield enc
                else:
                    for lo in range(0, enc.shape[0], page_words):
                        yield enc[lo:lo + page_words]
        return gen()

    def scrub(self, code: LDPCCode, store: dict, *,
              page_words: int | None = None, **kw) -> dict:
        """Full-array sweep: scan every stored word, repair flagged words in
        place. `page_words` (default: the controller's `page_words`) streams
        the sweep in fixed-size pages; other keywords (`coalesce=`,
        `scan_ahead=`, `drain_words=`) reach `scrub_pages`. Returns the
        sweep's report."""
        if page_words is None:
            page_words = self.page_words
        return self.scrub_pages(code, self.iter_pages(store, page_words),
                                page_words=page_words, **kw)

    def scrub_pages(self, code: LDPCCode, pages: Iterable[torch.Tensor], *,
                    page_words: int | None = None, coalesce: bool = True,
                    scan_ahead: int = 4,
                    drain_words: int | None = None) -> dict:
        """Paged sweep over any iterator of writable (b, n) level-word
        pages; repairs are written back through the page views.

        `coalesce=True` (default) is the repair pipeline: pages are
        scanned `scan_ahead` ahead of the one whose flags are being read
        (one host read per window of pages), flagged rows wait on the
        `RepairQueue`, which drains once `drain_words` rows have
        accumulated. `coalesce=False` is the per-page baseline: each
        page's flag count is read back and its flagged rows decoded before
        the next page. Both repair the same words (FBP is
        row-independent)."""
        if not coalesce:
            return self._scrub_pages_baseline(code, pages,
                                              page_words=page_words)
        t0 = time.perf_counter()
        scan_ahead = max(1, scan_ahead)
        if drain_words is None:
            drain_words = 4 * self.chunk_size
        queue = self._repair_queue(code)
        totals = {"words": 0, "flagged": 0, "corrected": 0,
                  "uncorrectable": 0, "pages": 0}
        page_stats: list[dict] = []
        drain_stats: list[dict] = []
        backend = None
        est = obs_ras.current()
        reg = obs_metrics.current()

        def flush():
            rep = queue.drain()
            if rep["words"]:
                totals["corrected"] += rep["repaired"]
                totals["uncorrectable"] += rep["failed"]
                drain_stats.append({k: rep[k] for k in (
                    "entries", "words", "repaired", "failed", "seconds")})

        def consume(window):
            """Read one window's flags with one nonzero over all its pages,
            then enqueue each page's flagged rows."""
            if not window:
                return
            sizes = [page.shape[0] for page, _mask in window]
            nz = torch.nonzero(torch.cat([m for _p, m in window]))[:, 0]
            starts = [0]
            for size in sizes:
                starts.append(starts[-1] + size)
            cuts = torch.searchsorted(
                nz, nz.new_tensor(starts)).tolist()
            for i, (page, _mask) in enumerate(window):
                rows = nz[cuts[i]:cuts[i + 1]] - starts[i]
                pg_flagged = cuts[i + 1] - cuts[i]
                totals["pages"] += 1
                totals["words"] += page.shape[0]
                totals["flagged"] += pg_flagged
                if est.enabled:
                    est.observe_scan(pg_flagged, page.shape[0],
                                     n_symbols=code.n)
                slot = None
                if totals["pages"] <= MAX_PAGE_STATS:
                    slot = {"words": int(page.shape[0]),
                            "flagged": pg_flagged, "corrected": 0,
                            "uncorrectable": 0}
                    page_stats.append(slot)
                if not pg_flagged:
                    continue

                def writeback(syms, ok, page=page, rows=rows, slot=slot):
                    good = rows[ok.to(rows.device)]
                    page[good] = syms[ok].to(page.dtype).to(page.device)
                    if slot is not None:
                        n_ok = int(ok.sum())
                        slot["corrected"] = n_ok
                        slot["uncorrectable"] = int(ok.numel()) - n_ok

                queue.enqueue(page[rows], writeback,
                              provenance=("page", totals["pages"] - 1, rows))

        prev: list = []
        cur: list = []
        for page in pages:
            backend = page.device.type
            cur.append((page, self._scan(code, page)))
            if len(cur) >= scan_ahead:
                consume(prev)
                prev, cur = cur, []
                if queue.pending_words >= drain_words:
                    flush()
        consume(prev)
        consume(cur)
        flush()
        dt = time.perf_counter() - t0
        words, corrected_n, fail_n = (totals["words"], totals["corrected"],
                                      totals["uncorrectable"])
        self._note_scrub_totals(code, words, corrected_n, fail_n, dt)
        if reg.enabled and drain_stats:
            reg.histogram("scrub_drains_per_sweep",
                          layer="controller").observe(len(drain_stats))
        return {"policy": self.policy, "backend": backend,
                "scan_route": self._scan_route(code),
                "words_scanned": words,
                "cells_scanned": words * code.n,
                "flagged": totals["flagged"],
                "corrected": corrected_n, "uncorrectable": fail_n,
                "pages": totals["pages"], "page_words": page_words,
                "page_stats": page_stats,
                "page_stats_truncated": totals["pages"] > MAX_PAGE_STATS,
                "coalesced": True, "scan_ahead": scan_ahead,
                "drains": len(drain_stats), "drain_stats": drain_stats,
                "seconds": dt,
                "bandwidth_cells_per_s": words * code.n / dt if dt else 0.0}

    def _scrub_pages_baseline(self, code: LDPCCode,
                              pages: Iterable[torch.Tensor], *,
                              page_words: int | None = None) -> dict:
        """Per-page sweep: a scan, a host read of its flag count and a
        decode of that page's flagged rows, page after page."""
        t0 = time.perf_counter()
        words = flagged_n = corrected_n = fail_n = n_pages = 0
        page_stats: list[dict] = []
        backend = None
        est = obs_ras.current()
        reg = obs_metrics.current()
        for page in pages:
            n_pages += 1
            backend = page.device.type
            tp = time.perf_counter()
            flagged = self._scan(code, page)
            pg_flagged = int(flagged.sum())
            pg_fail = 0
            if pg_flagged:
                rows = torch.nonzero(flagged)[:, 0]
                syms, f, iters = self._repair_queue(code).decode_batch(
                    page[rows])
                if est.enabled:
                    # one feed per decoded chunk, as the JAX baseline's
                    # per-chunk decodes feed it
                    cs = self.chunk_size
                    for lo in range(0, f.shape[0], cs):
                        est.observe_decode(iters[lo:lo + cs], self.n_iters,
                                           detect_fail=f[lo:lo + cs])
                pg_fail = int(f.sum())
                ok = ~f.to(rows.device)
                if pg_fail < pg_flagged:
                    page[rows[ok]] = syms[ok].to(page.dtype).to(page.device)
            words += page.shape[0]
            flagged_n += pg_flagged
            corrected_n += pg_flagged - pg_fail
            fail_n += pg_fail
            if est.enabled:
                est.observe_scan(pg_flagged, page.shape[0],
                                 n_symbols=code.n)
            if reg.enabled:
                reg.histogram("scrub_page_seconds",
                              layer="controller").observe(
                    time.perf_counter() - tp)
            if n_pages <= MAX_PAGE_STATS:
                page_stats.append({
                    "words": int(page.shape[0]), "flagged": pg_flagged,
                    "corrected": pg_flagged - pg_fail,
                    "uncorrectable": pg_fail,
                    "seconds": time.perf_counter() - tp})
        dt = time.perf_counter() - t0
        self._note_scrub_totals(code, words, corrected_n, fail_n, dt)
        return {"policy": self.policy, "backend": backend,
                "scan_route": self._scan_route(code),
                "words_scanned": words,
                "cells_scanned": words * code.n, "flagged": flagged_n,
                "corrected": corrected_n, "uncorrectable": fail_n,
                "pages": n_pages, "page_words": page_words,
                "page_stats": page_stats,
                "page_stats_truncated": n_pages > MAX_PAGE_STATS,
                "coalesced": False, "seconds": dt,
                "bandwidth_cells_per_s": words * code.n / dt if dt else 0.0}

    def _note_scrub_totals(self, code: LDPCCode, words: int, corrected_n: int,
                           fail_n: int, dt: float) -> None:
        self.stats.scrub_rounds += 1
        self.stats.scrub_words += words
        self.stats.scrub_cells += words * code.n
        self.stats.scrub_corrected += corrected_n
        self.stats.scrub_uncorrectable += fail_n
        self.stats.scrub_seconds += dt
        reg = obs_metrics.current()
        if reg.enabled:
            labels = {"layer": "controller", "policy": self.policy,
                      "code": f"gf{code.p}n{code.n}"}
            reg.counter("scrub_words_scanned", **labels).inc(words)
            reg.counter("scrub_corrected", **labels).inc(corrected_n)
            reg.counter("scrub_uncorrectable", **labels).inc(fail_n)


class WritebackController(MemoryController):
    """`writeback` policy: reads repair storage as a side effect."""

    policy = "writeback"

    def _writeback(self, st, corrected, flagged, fail):
        ok = flagged & ~fail
        n_ok = int(ok.sum())
        if n_ok:
            st.enc[ok] = corrected[ok].to(st.enc.dtype)
            self.stats.writebacks += n_ok


class ScrubController(WritebackController):
    """`scrub` policy: writeback + a background sweep every `interval`
    read/write operations."""

    policy = "scrub"

    def __init__(self, *, interval: int = 16, **kw):
        super().__init__(**kw)
        self.interval = interval
        self._ops = 0

    def tick(self, code: LDPCCode, store: dict) -> None:
        self._ops += 1
        if self._ops % self.interval == 0:
            self.scrub(code, store)


_POLICIES = {"basic": MemoryController, "writeback": WritebackController,
             "scrub": ScrubController}


def make_controller(spec, **kw) -> MemoryController:
    """spec: a policy name ("basic" | "writeback" | "scrub"), a controller
    instance (passed through), or None (basic)."""
    if isinstance(spec, MemoryController):
        return spec
    if spec is None:
        spec = "basic"
    if spec not in _POLICIES:
        raise KeyError(f"unknown controller policy {spec!r}; "
                       f"available: {sorted(_POLICIES)}")
    return _POLICIES[spec](**kw)
