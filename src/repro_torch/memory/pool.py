"""Shared protected page pool and block allocator for multi-tenant serving.

A `PagedProtectedStore` owns grow-only pages: right for one sequence,
wasteful across many, and nothing reclaims a retired tenant's pages. This
module is the layer underneath the serving engine, as the JAX package's
`repro.memory.pool` is:

- **`ProtectedPagePool`** — a fixed capacity of `(page_words, n)` GF(p)
  pages (`gf.symbol_dtype(p)`, on the pool's device) with a free list
  that hands out pid 0 first, reference counts (prefix-shared sequences
  alias blocks), per-page owner labels and last-touch stamps, a per-page
  flag EWMA with a scanned marker, and an incremental `scrub()` that
  sweeps allocated pages with the stores' scan -> decode -> writeback
  path, attributing repairs to the owning tenant. The sweep order is a
  round-robin cursor, or `hot_pages()` (never-scanned pages first, then
  by flag EWMA) with `prioritize=True`.
- **`PooledStore`** — a `PagedProtectedStore` whose four storage
  primitives address the pool through a per-tenant block table: appends
  allocate from the pool, a write to a shared page copies it first
  (copy-on-write), `free()` returns every block and `fork()` clones a
  store by aliasing its blocks. Every tenant's store shares the pool's
  template store's scanner, decoder and `RepairQueue`, so repairs from
  all tenants coalesce into one drain.

An allocation that does not fit raises `PoolExhausted` before any state
is mutated: the engine preflights capacity and preempts, and a caller
that races anyway gets a clean error, never a corrupted block table.

Scrubs feed the ambient observability layer as the JAX pool's do: sweep
and per-owner counters into the metrics registry, and each scanned page's
flags and each decoded page's iterations into the RAS estimator under its
owner's region (free when neither is installed).

With `mesh`, every block is stored as row shards over the mesh, as the
template store lays out its pages (`memory.paged`): the scrubs scan and
decode shard by shard, each on its own device, `page(pid)` gathers a
block onto the pool's device (the mesh's first) and writes replace a
block's shards. The JAX pool's kernel `policy` is not ported: the
wrappers pick kernel or plain version by the tensors' device.
"""
from __future__ import annotations

from collections.abc import Iterator

import torch

from ..core.construction import LDPCCode
from ..device import as_tensor, generator
from ..obs import metrics as obs_metrics
from ..obs import ras as obs_ras
from .controller import ControllerStats
from .paged import PagedProtectedStore

__all__ = ["PoolExhausted", "ProtectedPagePool", "PooledStore"]


class PoolExhausted(RuntimeError):
    """Raised when an allocation needs more pages than the pool has free.

    Raised before any block table or pool state is mutated, so callers can
    evict and retry."""


class ProtectedPagePool:
    """Fixed-capacity pool of (page_words, n) GF pages with a free list,
    reference counts, owner labels and incremental scrubbing."""

    def __init__(self, code: str | LDPCCode = "wl1024_r08", *,
                 page_words: int = 256, capacity_pages: int = 64,
                 mesh=None, n_iters: int = 10, damping: float = 0.3,
                 llv_scale: float = 4.0, llv_mode: str = "manhattan",
                 device=None):
        if capacity_pages <= 0:
            raise ValueError(
                f"capacity_pages must be positive, got {capacity_pages}")
        # the template store carries the code, its checks, the page
        # layout, the scanner, the decoder and the repair queue every
        # PooledStore delegates to
        self._template = PagedProtectedStore(
            code, page_words=page_words, mesh=mesh, n_iters=n_iters,
            damping=damping, llv_scale=llv_scale, llv_mode=llv_mode,
            device=device)
        self.device = self._template.device
        self.mesh = mesh
        self.code = self._template.code
        self.dtype = self._template.dtype
        self.page_words = page_words
        self.capacity_pages = capacity_pages
        # a page: a tensor, or a tuple of row shards over the mesh
        self._storage: list = [None] * capacity_pages
        self._refcount = [0] * capacity_pages
        self._owner: list[object | None] = [None] * capacity_pages
        self._stamp = [0] * capacity_pages     # last touch (engine step)
        self._free = list(range(capacity_pages - 1, -1, -1))  # pop() -> 0,1,…
        self._scrub_cursor = 0
        # per-page scrub-flag EWMA and scanned marker: the order of a
        # prioritized sweep (hot-flagging pages first)
        self._flag_ewma = [0.0] * capacity_pages
        self._scanned = [False] * capacity_pages
        self.flag_alpha = 0.3
        self.peak_allocated = 0                # most pages held at once
        self.stats = ControllerStats()         # pool-level scrub totals
        self.scrub_by_owner: dict[object, dict] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(0)

    # -- introspection ------------------------------------------------------

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return self.capacity_pages - len(self._free)

    @property
    def page_bytes(self) -> int:
        return self.page_words * self.code.n * self.dtype.itemsize

    def refcount(self, pid: int) -> int:
        return self._refcount[pid]

    def owner(self, pid: int):
        return self._owner[pid]

    def allocated(self) -> list[int]:
        """The allocated pids, ascending."""
        return [pid for pid in range(self.capacity_pages)
                if self._storage[pid] is not None]

    def copy(self, pids=None, device=None) -> ProtectedPagePool:
        """A new pool with this pool's code and decoder, holding copies of
        pages `pids` (every allocated page by default) under the same
        pids, owners, stamps and scan state, one reference each: on this
        pool's device and mesh by default, else unsharded on `device`.
        Its cursor, totals and generator start fresh; scrubbing it leaves
        this pool as it is."""
        tpl = self._template
        out = ProtectedPagePool(
            self.code, page_words=self.page_words,
            capacity_pages=self.capacity_pages,
            mesh=self.mesh if device is None else None, n_iters=tpl.n_iters,
            damping=tpl.damping, llv_scale=tpl.llv_scale,
            llv_mode=tpl.llv_mode,
            device=self.device if device is None else device)
        out.flag_alpha = self.flag_alpha
        held = set(self.allocated() if pids is None else pids)
        for pid in held:
            out._storage[pid] = out._template._split(
                self.page(pid).to(out.device, copy=True))
            out._refcount[pid] = 1
            out._owner[pid] = self._owner[pid]
            out._stamp[pid] = self._stamp[pid]
            out._scanned[pid] = self._scanned[pid]
            out._flag_ewma[pid] = self._flag_ewma[pid]
        out._free = [pid for pid in out._free if pid not in held]
        out.peak_allocated = out.n_allocated
        return out

    # -- allocator ----------------------------------------------------------

    def alloc(self, owner=None) -> int:
        """Take one zeroed page off the free list. Raises `PoolExhausted`
        (mutating nothing) when the pool is full."""
        if not self._free:
            raise PoolExhausted(
                f"pool exhausted: all {self.capacity_pages} pages allocated")
        pid = self._free.pop()
        self._storage[pid] = self._template._zeros()
        self._refcount[pid] = 1
        self._owner[pid] = owner
        self._stamp[pid] = 0
        self._flag_ewma[pid] = 0.0
        self._scanned[pid] = False
        self.peak_allocated = max(self.peak_allocated, self.n_allocated)
        return pid

    def ref(self, pid: int) -> None:
        """Add an aliasing reference (prefix-shared block tables)."""
        if self._refcount[pid] <= 0:
            raise ValueError(f"page {pid} is not allocated")
        self._refcount[pid] += 1

    def free(self, pid: int) -> None:
        """Drop one reference; the page returns to the free list when the
        last reference goes."""
        if self._refcount[pid] <= 0:
            raise ValueError(f"page {pid} is not allocated")
        self._refcount[pid] -= 1
        if self._refcount[pid] == 0:
            self._storage[pid] = None
            self._owner[pid] = None
            self._flag_ewma[pid] = 0.0
            self._scanned[pid] = False
            self._free.append(pid)

    # -- page access --------------------------------------------------------

    def _stored(self, pid: int):
        """Page `pid` in the pool's layout (its shards)."""
        pg = self._storage[pid]
        if pg is None:
            raise ValueError(f"page {pid} is not allocated")
        return pg

    def page(self, pid: int) -> torch.Tensor:
        """Page `pid` as one tensor on the pool's device."""
        return self._template._join(self._stored(pid))

    def set_page(self, pid: int, page: torch.Tensor) -> None:
        """Replace page `pid` (pages are replaced, never written in place,
        so a tensor handed out earlier keeps its contents)."""
        if self._storage[pid] is None:
            raise ValueError(f"page {pid} is not allocated")
        self._storage[pid] = self._template._split(page)

    def touch(self, pid: int, step: int) -> None:
        """Record that `pid` was accessed at engine step `step` (the
        scrub's `min_age` skips recently touched pages)."""
        self._stamp[pid] = step

    def stamp(self, pid: int) -> int:
        return self._stamp[pid]

    # -- background scrub ---------------------------------------------------

    def page_flag_rate(self, pid: int) -> float:
        """EWMA fraction of this page's words flagged across scrub scans
        (0.0 until the first scan)."""
        return self._flag_ewma[pid]

    def hot_pages(self, top: int | None = None) -> list[int]:
        """Allocated pages ranked for scrubbing: never-scanned pages first
        (coverage), then by descending flag EWMA (repair pressure)."""
        ranked = sorted(self.allocated(),
                        key=lambda pid: (self._scanned[pid],
                                         -self._flag_ewma[pid], pid))
        return ranked[:top] if top is not None else ranked

    def scrub(self, *, max_pages: int | None = None, now: int = 0,
              min_age: int = 0, prioritize: bool = False,
              coalesce: bool = True) -> dict:
        """Incrementally sweep allocated pages: scan, repair flagged words,
        write back, attributing repairs to each page's owner. Returns
        {pages, flagged_words, repaired_words, by_owner}.

        A persistent round-robin cursor spreads work across calls;
        `max_pages` caps this call's sweep, and `min_age` skips pages
        touched within the last `min_age` steps of `now`. `prioritize=True`
        sweeps in `hot_pages()` order instead.

        `coalesce=True` scans every selected page, reads all the flags
        back once, queues every flagged row on the shared `RepairQueue`
        and decodes them in one drain. `coalesce=False` is the per-page
        baseline (a flag count read back a page, a decode of each flagged
        page). Both repair the same words with the same attribution."""
        allocated = self.allocated()
        if not allocated:
            return {"pages": 0, "flagged_words": 0, "repaired_words": 0,
                    "by_owner": {}}
        budget = len(allocated) if max_pages is None else max_pages
        if prioritize:
            order = self.hot_pages()
        else:
            # rotate so the sweep resumes where the previous call stopped
            start = next((j for j, pid in enumerate(allocated)
                          if pid >= self._scrub_cursor), 0)
            order = allocated[start:] + allocated[:start]
        # the selection does not depend on the scans, so both sweeps share it
        selected: list[int] = []
        for pid in order:
            if len(selected) >= budget:
                break
            if now - self._stamp[pid] < min_age:
                continue
            selected.append(pid)
            if not prioritize:
                self._scrub_cursor = pid + 1
        if self._scrub_cursor >= self.capacity_pages:
            self._scrub_cursor = 0
        sweep = (self._scrub_selected_coalesced if coalesce
                 else self._scrub_selected_baseline)
        swept, flagged_words, repaired, by_owner = sweep(selected)
        self.stats.scrub_rounds += 1
        self.stats.scrub_words += swept * self.page_words
        self.stats.scrub_corrected += repaired
        self.stats.scrub_uncorrectable += flagged_words - repaired
        reg = obs_metrics.current()
        if reg.enabled:
            reg.counter("pool_scrub_pages", layer="pool").inc(swept)
            reg.counter("pool_scrub_flagged", layer="pool").inc(flagged_words)
            reg.counter("pool_scrub_repaired", layer="pool").inc(repaired)
        for owner, ent in by_owner.items():
            tot = self.scrub_by_owner.setdefault(
                owner, {"flagged_words": 0, "repaired_words": 0})
            tot["flagged_words"] += ent["flagged_words"]
            tot["repaired_words"] += ent["repaired_words"]
            if reg.enabled:
                lab = {"layer": "pool",
                       "tenant": str(owner) if owner is not None else ""}
                reg.counter("pool_scrub_flagged_by_owner", **lab).inc(
                    ent["flagged_words"])
                reg.counter("pool_scrub_repaired_by_owner", **lab).inc(
                    ent["repaired_words"])
        return {"pages": swept, "flagged_words": flagged_words,
                "repaired_words": repaired, "by_owner": by_owner}

    def _note_page_scan(self, pid: int, nf: int, est):
        """Post-scan bookkeeping of both sweeps: flag EWMA, scanned marker,
        the estimator's feed in the owner's region. Returns the page's
        owner."""
        a = self.flag_alpha if self._scanned[pid] else 1.0
        self._flag_ewma[pid] += a * (nf / self.page_words
                                     - self._flag_ewma[pid])
        self._scanned[pid] = True
        owner = self._owner[pid]
        if est.enabled:
            est.observe_scan(nf, self.page_words, n_symbols=self.code.n,
                             region=str(owner) if owner is not None else "")
        return owner

    def _scrub_selected_baseline(self, selected: list[int]):
        """Per-page sweep: read each page's flag count back, decode the
        whole page when any row flags."""
        est = obs_ras.current()
        flagged_words = repaired = 0
        by_owner: dict[object, dict] = {}
        for pid in selected:
            stored = self._storage[pid]
            flags = self._template._scan(stored)
            nf = int(flags.sum())
            owner = self._note_page_scan(pid, nf, est)
            if not nf:
                continue
            flagged_words += nf
            _y, res = self._template._decode(stored)
            good = flags & ~res.detect_fail
            page = self._template._join(stored)
            self._storage[pid] = self._template._split(torch.where(
                good[:, None], res.symbols, page).to(self.dtype))
            ok = int(good.sum())
            repaired += ok
            if est.enabled:
                est.observe_decode(res.iterations, self._template.n_iters,
                                   detect_fail=res.detect_fail,
                                   region=str(owner) if owner is not None
                                   else "")
            ent = by_owner.setdefault(
                owner, {"flagged_words": 0, "repaired_words": 0})
            ent["flagged_words"] += nf
            ent["repaired_words"] += ok
        return len(selected), flagged_words, repaired, by_owner

    def _scrub_selected_coalesced(self, selected: list[int]):
        """Every selected page's scan, one read of all the flags, the
        flagged rows of every tenant's pages queued on the shared
        `RepairQueue` and decoded in one drain; repairs replace the pages
        through each entry's writeback."""
        if not selected:
            return 0, 0, 0, {}
        masks = torch.stack([self._template._scan(self._storage[pid])
                             for pid in selected]).cpu()
        est = obs_ras.current()
        queue = self._template._repair_queue()
        flagged_words = 0
        for pid, mask in zip(selected, masks, strict=True):
            rows = torch.nonzero(mask)[:, 0]
            owner = self._note_page_scan(pid, int(rows.numel()), est)
            if not rows.numel():
                continue
            flagged_words += int(rows.numel())
            rows = rows.to(self.device)
            page = self.page(pid)

            def writeback(syms, ok, pid=pid, rows=rows, page=page):
                good = rows[ok]
                if good.numel():
                    new = page.clone()
                    new[good] = syms[ok].to(self.dtype)
                    self._storage[pid] = self._template._split(new)

            queue.enqueue(page[rows], writeback, owner=owner,
                          provenance=("pool", pid, rows))
        rep = queue.drain()
        by_owner = {owner: dict(ent)
                    for owner, ent in rep["by_owner"].items()}
        return len(selected), flagged_words, rep["repaired"], by_owner

    # -- fault injection over the whole pool --------------------------------

    def inject(self, channel, key: int | torch.Generator | None = None, *,
               t: float = 0.0, n_reads: int = 0, owners=None) -> int:
        """Corrupt allocated pages through a level-domain channel, in pid
        order (optionally only pages owned by `owners`). `key` is a seed
        or a generator on the pool's device; without one the pool's own
        generator is drawn on. Returns cells changed. A shared page is
        corrupted once, as one physical page going bad under every
        alias."""
        if channel.domain != "level":
            raise ValueError(f"{type(channel).__name__} is an integer-domain "
                             "channel; stored cells need a level-domain one")
        if channel.p != self.code.p:
            raise ValueError(f"channel alphabet {channel.p} != "
                             f"GF({self.code.p})")
        gen = generator(key, self._gen, self.device)
        want = None if owners is None else set(owners)
        changed = torch.zeros((), dtype=torch.int64, device=self.device)
        for pid in self.allocated():
            if want is not None and self._owner[pid] not in want:
                continue
            # drawn on the pool's device, so a sharded pool takes the
            # unsharded pool's faults
            page = self.page(pid)
            new = channel.apply(gen, page, t=t, n_reads=n_reads).to(
                self.dtype)
            changed += (new != page).sum()
            self._storage[pid] = self._template._split(new)
        return int(changed)


class PooledStore(PagedProtectedStore):
    """A `PagedProtectedStore` whose pages live in a shared
    `ProtectedPagePool`, addressed through a per-tenant block table.

    Reads, writes, injection and scrubs behave as the standalone store's;
    what changes is where pages live: appends allocate from the pool, a
    write to an aliased page copies it first, and `free()` returns every
    block. The scanner, decoder and repair queue are the pool template's,
    shared by every tenant."""

    def __init__(self, pool: ProtectedPagePool, *, owner=None, key: int = 0):
        tpl = pool._template
        super().__init__(pool.code, page_words=pool.page_words,
                         mesh=pool.mesh, n_iters=tpl.n_iters,
                         damping=tpl.damping, llv_scale=tpl.llv_scale,
                         llv_mode=tpl.llv_mode, key=key, device=pool.device)
        self.pool = pool
        self.owner = owner
        self.block_table: list[int] = []
        self._pages = _BlockTableView(self)   # `store._pages[i]` debugging

    # -- storage indirection over the pool ----------------------------------

    @property
    def n_pages(self) -> int:
        return len(self.block_table)

    def page(self, i: int) -> torch.Tensor:
        return self.pool.page(self.block_table[i])

    def _stored(self, i: int):
        return self.pool._stored(self.block_table[i])

    def _set_page(self, i: int, page: torch.Tensor) -> None:
        pid = self.block_table[i]
        if self.pool.refcount(pid) > 1:
            # copy-on-write: a write through an aliased block must never be
            # seen by the other tenants holding it
            new_pid = self.pool.alloc(self.owner)
            self.pool.set_page(new_pid, page)
            self.pool.touch(new_pid, self.pool.stamp(pid))
            self.pool.free(pid)
            self.block_table[i] = new_pid
        else:
            self.pool.set_page(pid, page)

    def _append_page(self) -> None:
        self.block_table.append(self.pool.alloc(self.owner))

    def _iter_pages(self) -> Iterator[torch.Tensor]:
        for i in range(self.n_pages):
            yield self.page(i)

    def free(self) -> None:
        for pid in self.block_table:
            self.pool.free(pid)
        self.block_table.clear()
        self._n_words = 0

    def fork(self, owner=None) -> PooledStore:
        """Clone this store by aliasing every block (prefix sharing): no
        page is copied until either side writes (copy-on-write)."""
        clone = PooledStore(self.pool, owner=owner)
        for pid in self.block_table:
            self.pool.ref(pid)
            clone.block_table.append(pid)
        clone._n_words = self._n_words
        return clone

    # -- capacity preflight --------------------------------------------------

    def pages_needed(self, m: int) -> int:
        """Worst-case fresh pool pages an append of m words takes: new
        trailing pages, plus one copy when the current tail block is
        aliased and partly filled."""
        pw = self.page_words
        slot = self._n_words % pw
        new_pages = -(-(self._n_words + m) // pw) - self.n_pages
        cow = int(slot != 0 and bool(self.block_table)
                  and self.pool.refcount(self.block_table[-1]) > 1)
        return max(new_pages, 0) + cow

    def _preflight(self, m: int) -> None:
        need = self.pages_needed(m)
        if need > self.pool.available:
            raise PoolExhausted(
                f"append of {m} words needs {need} pool pages but only "
                f"{self.pool.available} are free")

    def append_words(self, u) -> tuple[int, int]:
        u = as_tensor(u, self.device)
        if u.dim() == 2 and u.shape[1] == self.code.k:
            self._preflight(int(u.shape[0]))
        return super().append_words(u)

    def append_encoded(self, enc) -> tuple[int, int]:
        enc = as_tensor(enc, self.device)
        if enc.dim() == 2 and enc.shape[1] == self.code.n:
            self._preflight(int(enc.shape[0]))
        return super().append_encoded(enc)

    # -- the template's scanner, decoder and queue ----------------------------

    def _scan(self, stored) -> torch.Tensor:
        return self.pool._template._scan(stored)

    def _decode(self, stored):
        return self.pool._template._decode(stored)

    def _repair_queue(self):
        # one queue for every tenant: cross-tenant repairs share a drain
        return self.pool._template._repair_queue()


class _BlockTableView:
    """List-like view of a PooledStore's pages, so the storage debugging
    idioms (`store._pages[i]`, `store._pages[i] = corrupted`) work against
    the pool-backed store."""

    def __init__(self, store: PooledStore):
        self._store = store

    def __len__(self) -> int:
        return self._store.n_pages

    def __getitem__(self, i: int) -> torch.Tensor:
        return self._store.page(i)

    def __setitem__(self, i: int, page) -> None:
        self._store._set_page(i, torch.as_tensor(
            page, device=self._store.device).to(self._store.dtype))

    def __iter__(self):
        return self._store._iter_pages()

    def __bool__(self) -> bool:
        return self._store.n_pages > 0

    def clear(self) -> None:
        self._store.free()
