"""Port parity: the shared protected page pool (`repro_torch.memory.pool`)
and the controller's per-page baseline sweep, against the JAX package on
the CPU.

- The allocator, reference counts, copy-on-write, `fork`, exhaustion and
  `pages_needed` mirror `tests/test_pool.py` on the port, with the same
  numpy words appended to a JAX pool beside it: pages, block tables,
  refcounts and `pages_needed` exactly equal.
- Scrubs: the same numpy corruption poked into both pools through
  `store._pages[i] = ...`; the reports (pages, flagged and repaired words,
  by owner), the round-robin cursor, the pool's totals and every page
  exactly equal, coalesced and per-page, with a page budget, with
  `min_age` and prioritized.
- Injection draws from torch generators on the port and from JAX keys in
  the reference, so it is checked by behaviour only (scoped to owners,
  shared pages once, repaired by a scrub).
- `ProtectedKVLayer` over a pool stores the same pages as the JAX layer.
- `MemoryController.scrub_pages(coalesce=False)` against the coalesced
  sweep and against the JAX package's baseline report
  (`tests/test_repair_pipeline.py`'s parity cases).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CODE_REGISTRY
from repro.core import get_code as jget_code
from repro.core import np_encode_words
from repro.memory import PooledStore as JStore
from repro.memory import ProtectedPagePool as JPool
from repro.memory.controller import MemoryController as JController
from repro.models import ProtectedKVConfig as JPKV
from repro.models.kv import ProtectedKVLayer as JLayer
from repro_torch.convert import CODE_FIELDS, code_from_arrays
from repro_torch.memory import (MemoryController, PooledStore, PoolExhausted,
                                ProtectedPagePool, asymmetric_adjacent,
                                uniform_flip)
from repro_torch.memory.paged import PagedProtectedStore
from repro_torch.models import ProtectedKVConfig, ProtectedKVLayer
from _torch_threads import torch_threads_per_worker  # noqa: F401

CODE = "wl160_r08"
ULP = dict(rtol=2 ** -7, atol=2 ** -10)
REPORT_KEYS = ("pages", "flagged_words", "repaired_words", "by_owner")
STAT_SKIP = ("scrub_seconds", "scrub_bandwidth_cells_per_s")


def _pools(capacity=8, page_words=6):
    return (JPool(CODE, page_words=page_words, capacity_pages=capacity,
                  n_iters=8),
            ProtectedPagePool(CODE, page_words=page_words,
                              capacity_pages=capacity, n_iters=8,
                              device="cpu"))


def _words(rng, m):
    code = jget_code(CODE)
    return rng.integers(0, code.p, (m, code.k))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _append(jst, tst, u):
    jst.append_words(jnp.asarray(u, jnp.int32))
    tst.append_words(torch.as_tensor(u))


def _assert_same_pool(jp, tp):
    assert tp.n_allocated == jp.n_allocated
    assert tp._free == jp._free
    for pid in range(jp.capacity_pages):
        assert tp.refcount(pid) == jp.refcount(pid)
        assert tp.owner(pid) == jp.owner(pid)
        assert tp.stamp(pid) == jp.stamp(pid)
        jpg, tpg = jp._storage[pid], tp._storage[pid]
        assert (jpg is None) == (tpg is None), pid
        if jpg is not None:
            np.testing.assert_array_equal(_np(tpg), np.asarray(jpg))
            assert tpg.dtype == torch.int8


def _assert_same_store(jst, tst):
    assert tst.block_table == jst.block_table
    assert (tst.n_words, tst.n_pages) == (jst.n_words, jst.n_pages)
    np.testing.assert_array_equal(_np(tst.export_words()),
                                  np.asarray(jst.export_words()))


# -- allocator / refcount ----------------------------------------------------


def test_alloc_free_cycle():
    jp, tp = _pools(capacity=3)
    for pool in (jp, tp):
        a, b = pool.alloc("t0"), pool.alloc("t1")
        assert (a, b) == (0, 1)                  # pid 0 first
        assert pool.n_allocated == 2 and pool.available == 1
        assert pool.owner(a) == "t0" and pool.refcount(b) == 1
        pool.free(a)
        assert pool.available == 2
        with pytest.raises(ValueError):
            pool.page(a)                         # a freed page is gone
        c = pool.alloc("t2")
        assert c == a and pool.n_allocated == 2
        assert int(_np(pool.page(c)).sum()) == 0   # handed out zeroed
    _assert_same_pool(jp, tp)
    for pool in (jp, tp):
        pool.free(1), pool.free(0)
        assert pool.available == 3
    _assert_same_pool(jp, tp)


def test_free_never_reclaims_live_refs():
    """A page freed by one alias stays live and untouched for the other
    holder: the free list never hands out a page with references."""
    jp, tp = _pools(capacity=2)
    marker = np.full((6, jp.code.n), 2)
    for pool, put in ((jp, lambda a: jnp.asarray(a, jnp.int32)),
                      (tp, lambda a: torch.as_tensor(a, dtype=torch.int8))):
        pid = pool.alloc("a")
        pool.set_page(pid, put(marker))
        pool.ref(pid)
        pool.free(pid)
        assert pool.refcount(pid) == 1
        other = pool.alloc("b")
        assert other != pid
        np.testing.assert_array_equal(_np(pool.page(pid)), marker)
    _assert_same_pool(jp, tp)
    for pool in (jp, tp):
        pool.free(0)
        with pytest.raises(ValueError):
            pool.free(0)                         # a double free is refused


def test_exhaustion_is_clean():
    jp, tp = _pools(capacity=2)
    for pool, exc in ((jp, None), (tp, PoolExhausted)):
        pool.alloc(), pool.alloc()
        with pytest.raises(exc or RuntimeError, match="exhausted"):
            pool.alloc()
        assert pool.n_allocated == 2 and pool.available == 0
    assert tp.peak_allocated == 2
    _assert_same_pool(jp, tp)


# -- pooled store: block tables, CoW, fork -----------------------------------


def test_pooled_store_matches_standalone(rng):
    """The pool-backed store is storage indirection only: the same
    codewords as a private store and as the JAX pooled store."""
    jp, tp = _pools(capacity=8)
    jst, tst = JStore(jp, owner="t0"), PooledStore(tp, owner="t0")
    u = _words(rng, 15)
    _append(jst, tst, u)
    assert tst.n_pages == 3 and tp.n_allocated == 3
    _assert_same_store(jst, tst)
    _assert_same_pool(jp, tp)
    ref = PagedProtectedStore(CODE, page_words=6, n_iters=8, device="cpu")
    ref.append_words(torch.as_tensor(u))
    assert torch.equal(tst.export_words(), ref.export_words())
    assert torch.equal(tst.read_info(0, 15), torch.as_tensor(u).to(
        torch.int8))
    for st in (jst, tst):
        st.free()
        assert st.n_pages == 0
    assert tp.available == jp.available == 8


def test_fork_aliases_then_cow(rng):
    jp, tp = _pools(capacity=8)
    jst, tst = JStore(jp, owner="a"), PooledStore(tp, owner="a")
    _append(jst, tst, _words(rng, 12))            # 2 full pages
    jcl, tcl = jst.fork(owner="b"), tst.fork(owner="b")
    for pool, st, cl in ((jp, jst, jcl), (tp, tst, tcl)):
        assert cl.block_table == st.block_table
        assert pool.n_allocated == 2              # aliased, nothing copied
        assert all(pool.refcount(pid) == 2 for pid in st.block_table)
    before = tst.page(0).clone()
    jcl._pages[0] = jnp.zeros_like(jcl.page(0))
    tcl._pages[0] = torch.zeros_like(tcl.page(0))
    _assert_same_pool(jp, tp)
    _assert_same_store(jcl, tcl)
    assert tcl.block_table[0] != tst.block_table[0]
    assert tp.n_allocated == 3 and tp.refcount(tst.block_table[0]) == 1
    assert torch.equal(tst.page(0), before)       # the original is intact
    for cl, st in ((jcl, jst), (tcl, tst)):
        cl.free()
        st.free()
    assert tp.available == jp.available == 8


def test_append_exhaustion_preserves_block_table(rng):
    jp, tp = _pools(capacity=2)
    jst, tst = JStore(jp, owner="a"), PooledStore(tp, owner="a")
    u = _words(rng, 12)
    _append(jst, tst, u)                          # fills the pool
    table, n_words = list(tst.block_table), tst.n_words
    more = _words(rng, 7)
    with pytest.raises(PoolExhausted):
        tst.append_words(torch.as_tensor(more))
    with pytest.raises(RuntimeError):
        jst.append_words(jnp.asarray(more, jnp.int32))
    # the failed append changed neither the table, the count nor the data
    assert tst.block_table == table and tst.n_words == n_words
    assert torch.equal(tst.read_info(0, 12), torch.as_tensor(u).to(
        torch.int8))
    _assert_same_store(jst, tst)
    _assert_same_pool(jp, tp)


def test_pages_needed_counts_cow_tail(rng):
    jp, tp = _pools(capacity=8)
    jst, tst = JStore(jp, owner="a"), PooledStore(tp, owner="a")
    _append(jst, tst, _words(rng, 8))             # 1 full + 1 partial page
    for m in (0, 1, 4, 5, 11, 17):
        assert tst.pages_needed(m) == jst.pages_needed(m)
    assert (tst.pages_needed(4), tst.pages_needed(5)) == (0, 1)
    jcl, tcl = jst.fork(owner="b"), tst.fork(owner="b")
    # the aliased partial tail must be copied before it takes more words
    for m in (1, 5, 9):
        assert tcl.pages_needed(m) == jcl.pages_needed(m)
    assert (tcl.pages_needed(1), tcl.pages_needed(5)) == (1, 2)
    u = _words(rng, 3)
    _append(jcl, tcl, u)                          # the CoW append itself
    _assert_same_store(jcl, tcl)
    _assert_same_store(jst, tst)
    _assert_same_pool(jp, tp)


# -- injection + scrub attribution -------------------------------------------


def test_inject_scopes_to_owner_and_scrub_attributes(rng):
    """By behaviour (the draws are torch's): corruption lands on the named
    owner's pages only, a scrub repairs it and attributes it to that
    owner, and the repairs stick."""
    _, tp = _pools(capacity=8, page_words=4)
    a, b = PooledStore(tp, owner="a"), PooledStore(tp, owner="b")
    a.append_words(torch.as_tensor(_words(rng, 8)))
    b.append_words(torch.as_tensor(_words(rng, 8)))
    clean_b = [pg.clone() for pg in b._iter_pages()]
    ch = asymmetric_adjacent(tp.code.p, 2e-3, 1e-3)
    with pytest.raises(ValueError, match="alphabet"):
        tp.inject(uniform_flip(5, 0.1), key=0)
    assert tp.inject(ch, key=0, owners=["a"]) > 0
    rep = tp.scrub(max_pages=tp.capacity_pages)
    assert rep["flagged_words"] > 0 and rep["repaired_words"] > 0
    assert set(rep["by_owner"]) == {"a"}          # only a's pages were hit
    for got, want in zip(b._iter_pages(), clean_b, strict=True):
        assert torch.equal(got, want)
    rep2 = tp.scrub(max_pages=tp.capacity_pages)
    assert rep2["flagged_words"] == (rep["flagged_words"]
                                     - rep["repaired_words"])
    assert tp.scrub_by_owner["a"]["repaired_words"] > 0
    # a shared page goes bad once, under every alias; a seed repeats
    c = a.fork(owner="c")
    n_alloc = tp.n_allocated
    assert tp.inject(uniform_flip(3, 0.05), key=7) > 0
    assert tp.n_allocated == n_alloc and c.block_table == a.block_table
    a.free(), b.free(), c.free()
    assert tp.available == tp.capacity_pages


def _corrupt_both(rng, jstores, tstores, rate):
    """The same numpy corruption poked into both pools' stores, page by
    page, through the stores' `_pages` views."""
    for jst, tst in zip(jstores, tstores, strict=True):
        for i in range(jst.n_pages):
            page = np.asarray(jst.page(i)).astype(np.int64)
            hit = rng.random(page.shape) < rate
            page[hit] = (page[hit] + rng.integers(1, 3, hit.sum())) % 3
            jst._pages[i] = jnp.asarray(page, jnp.int32)
            tst._pages[i] = page


def _scrub_pair(rng, n_pages=7):
    jp, tp = _pools(capacity=10, page_words=4)
    jstores, tstores = [], []
    for owner, m in (("a", 4 * n_pages - 6), ("b", 6)):
        jst, tst = JStore(jp, owner=owner), PooledStore(tp, owner=owner)
        _append(jst, tst, _words(rng, m))
        jstores.append(jst)
        tstores.append(tst)
    _corrupt_both(rng, jstores, tstores, 0.01)
    _assert_same_pool(jp, tp)
    return jp, tp


SCRUBS = {
    "budget": [dict(max_pages=3)] * 4,
    "min_age": [dict(now=9, min_age=4), dict(now=12, min_age=4),
                dict(now=20, min_age=4, max_pages=2)],
    "prioritized": [dict(max_pages=3, prioritize=True)] * 3,
}


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("case", sorted(SCRUBS))
def test_scrub_matches_reference(case, coalesce, rng):
    """Reports, the cursor, the pool's totals, per-owner totals and every
    page equal to the JAX pool's, sweep after sweep."""
    jp, tp = _scrub_pair(rng)
    if case == "min_age":
        for pid in range(jp.capacity_pages):
            if jp._storage[pid] is not None:
                jp.touch(pid, 2 * pid)
                tp.touch(pid, 2 * pid)
    flagged = 0
    for kw in SCRUBS[case]:
        jr = jp.scrub(coalesce=coalesce, **kw)
        tr = tp.scrub(coalesce=coalesce, **kw)
        assert {k: tr[k] for k in REPORT_KEYS} == \
            {k: jr[k] for k in REPORT_KEYS}
        assert tp._scrub_cursor == jp._scrub_cursor
        assert tp.hot_pages() == jp.hot_pages()
        _assert_same_pool(jp, tp)
        flagged += tr["flagged_words"]
    assert flagged > 0
    a, b = jp.stats.as_dict(), tp.stats.as_dict()
    for k in STAT_SKIP:
        a.pop(k), b.pop(k)
    assert a == b and tp.scrub_by_owner == jp.scrub_by_owner


def test_scrub_round_robin_budget(rng):
    jp, tp = _pools(capacity=8, page_words=4)
    u = _words(rng, 24)                           # 6 pages
    jst, tst = JStore(jp, owner="a"), PooledStore(tp, owner="a")
    _append(jst, tst, u)
    seen = set()
    for _ in range(3):
        jp.scrub(max_pages=2)
        tp.scrub(max_pages=2)
        assert tp._scrub_cursor == jp._scrub_cursor
        seen.add(tp._scrub_cursor)
    assert len(seen) == 3                         # the cursor advances
    assert tp.stats.scrub_rounds == 3
    assert tp.stats.scrub_words == 6 * 4


def test_scrub_min_age_skips_hot_pages(rng):
    jp, tp = _pools(capacity=4, page_words=4)
    jst, tst = JStore(jp, owner="a"), PooledStore(tp, owner="a")
    _append(jst, tst, _words(rng, 8))             # 2 pages
    for pool, st in ((jp, jst), (tp, tst)):
        pool.touch(st.block_table[0], 10)         # hot
        pool.touch(st.block_table[1], 0)          # cold
        assert pool.scrub(now=11, min_age=5)["pages"] == 1


def test_pool_copy_scrubs_like_the_original(rng):
    """`copy` holds the chosen pages under their pids, owners, stamps and
    scan state: a copy of every page scrubs to the same report and pages
    as the pool (which the copy's scrub leaves untouched), and a copy of
    some pages allocates around the pids it holds, lowest first."""
    _, tp = _scrub_pair(rng)
    for pid in tp.allocated():
        tp.touch(pid, pid)
    tp.scrub(max_pages=2)                         # some pages scanned
    before = {pid: tp.page(pid).clone() for pid in tp.allocated()}
    whole = tp.copy(device="cpu")
    assert whole.allocated() == tp.allocated()
    assert whole.hot_pages() == tp.hot_pages()
    kw = dict(now=8, min_age=2, prioritize=True)
    rep = whole.scrub(**kw)
    assert rep["repaired_words"] > 0
    for pid, pg in before.items():
        assert torch.equal(tp.page(pid), pg)
    assert tp.scrub(**kw) == rep
    for pid in tp.allocated():
        assert torch.equal(whole.page(pid), tp.page(pid))
        assert (whole.owner(pid), whole.stamp(pid), whole.refcount(pid)) \
            == (tp.owner(pid), tp.stamp(pid), 1)
    some = tp.allocated()[1::2]
    part = tp.copy(some)
    assert part.allocated() == some and part.n_allocated == len(some)
    assert part.alloc() == min(set(range(part.capacity_pages)) - set(some))


# -- the pool-backed protected KV layer ----------------------------------------


def _bf16_np(rng, shape, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def test_pool_backed_kv_layer_matches_reference(rng):
    """`ProtectedKVConfig(pool=...)`: both packages' layers store the same
    pages under the same block tables of their pools, attend alike, and
    `free()` returns every block; a pool of the wrong page size or code
    is refused."""
    from repro_torch.memory import words_for_tensor
    B, hkv, dh, T = 2, 2, 8, 4
    wpu = words_for_tensor((B, T, hkv, dh), 3, 128)
    jp, tp = _pools(capacity=16, page_words=wpu)
    jl = JLayer(JPKV(code_name=CODE, page_tokens=T, pool=jp), B, hkv, dh,
                owner="t")
    tl = ProtectedKVLayer(ProtectedKVConfig(code_name=CODE, page_tokens=T,
                                            pool=tp), B, hkv, dh,
                          owner="t", device="cpu")
    assert isinstance(tl.k_store, PooledStore)
    for t in (3, 6, 4):
        shape = (B, t, hkv, dh)
        k, v = _bf16_np(rng, shape, 2.0), _bf16_np(rng, shape)
        jl.append(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
        tl.append(torch.from_numpy(k).to(torch.bfloat16),
                  torch.from_numpy(v).to(torch.bfloat16))
        q = _bf16_np(rng, (B, 1, 4, dh))
        want = np.asarray(jl.attend(jnp.asarray(q, jnp.bfloat16)),
                          np.float32)
        got = tl.attend(torch.from_numpy(q).to(torch.bfloat16))
        np.testing.assert_allclose(got.float().numpy(), want, **ULP)
    for js, ts in ((jl.k_store, tl.k_store), (jl.v_store, tl.v_store)):
        _assert_same_store(js, ts)
    _assert_same_pool(jp, tp)
    assert tl.stats() == jl.stats()
    tl.free()
    assert tp.n_allocated == 0
    with pytest.raises(ValueError, match="page_words"):
        ProtectedKVLayer(ProtectedKVConfig(code_name=CODE, page_tokens=T,
                                           pool=tp), 1, hkv, dh,
                         device="cpu")
    other = ProtectedPagePool("wl128_r08", page_words=wpu, capacity_pages=2,
                              device="cpu")
    with pytest.raises(ValueError, match="code"):
        ProtectedKVLayer(ProtectedKVConfig(code_name=CODE, page_tokens=T,
                                           pool=other), B, hkv, dh,
                         device="cpu")


def test_pool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProtectedPagePool(CODE, page_words=4, capacity_pages=2)


# -- the controller's per-page baseline sweep ---------------------------------


def _corrupted(code, rng, n_words, n_errs):
    """(n_words, n) codewords with `n_errs` single-cell hits on distinct
    rows, and the clean words."""
    w = rng.integers(0, code.p, (n_words, code.k))
    enc = np_encode_words(w, code).astype(np.int8)
    bad = enc.copy()
    rows = rng.choice(n_words, size=min(n_errs, n_words), replace=False)
    cols = rng.integers(0, code.n, rows.size)
    bad[rows, cols] = (bad[rows, cols] + 1) % code.p
    return bad, enc


def _store(enc):
    return {"x": type("S", (), {"enc": enc})()}


def _sweep(tcode, bad, coalesce):
    """The port's sweep of `bad` (16-word pages) -> (report, storage)."""
    ctrl = MemoryController(n_iters=10, chunk_size=64, device="cpu")
    store = _store(torch.tensor(bad))
    rep = ctrl.scrub(tcode, store, page_words=16, coalesce=coalesce)
    return rep, store["x"].enc.numpy()


PAGE_KEYS = ("words", "flagged", "corrected", "uncorrectable")
SWEEP_KEYS = ("pages", "words_scanned", "cells_scanned", "flagged",
              "corrected", "uncorrectable", "page_words",
              "page_stats_truncated", "coalesced")


def _codes(name):
    code = jget_code(name)
    return code, code_from_arrays({f: getattr(code, f) for f in CODE_FIELDS})


@pytest.mark.parametrize("name", sorted(n for n in CODE_REGISTRY
                                        if CODE_REGISTRY[n][0] < 512))
def test_controller_baseline_matches_coalesced(name, rng):
    """The per-page baseline repairs exactly what the coalesced sweep
    repairs, with the same totals and per-page stats, on every registry
    code of n < 512 (the reference's parity test also runs the codes of
    n >= 512, as slow cases; they are left out here for the suite's
    time). Residual rows are exactly the uncorrectable ones."""
    code, tcode = _codes(name)
    bad, clean = _corrupted(code, rng, n_words=96, n_errs=23)
    rb, enc_b = _sweep(tcode, bad, False)
    rc, enc_c = _sweep(tcode, bad, True)
    assert rb["coalesced"] is False and rc["coalesced"] is True
    for key in ("pages", "words_scanned", "flagged", "corrected",
                "uncorrectable"):
        assert rb[key] == rc[key], key
    assert [{k: s[k] for k in PAGE_KEYS} for s in rb["page_stats"]] == \
        [{k: s[k] for k in PAGE_KEYS} for s in rc["page_stats"]]
    np.testing.assert_array_equal(enc_b, enc_c)
    assert rb["corrected"] + rb["uncorrectable"] == rb["flagged"] == 23
    assert int((enc_b != clean).any(axis=1).sum()) == rb["uncorrectable"]


@pytest.mark.parametrize("name", ["wl40_r08", "wl160_r08", "wl160_r08_gf5"])
def test_controller_baseline_matches_reference(name, rng):
    """The baseline's report and repaired storage equal the JAX package's
    `scrub_pages(coalesce=False)` on the same corrupted words (GF(3) with
    words left uncorrectable, the KV cache's code, and GF(5))."""
    code, tcode = _codes(name)
    bad, _clean = _corrupted(code, rng, n_words=96, n_errs=23)
    rb, enc_b = _sweep(tcode, bad, False)
    jstore = _store(bad.copy())
    jr = JController(n_iters=10, chunk_size=64).scrub(
        code, jstore, page_words=16, coalesce=False)
    assert {k: rb[k] for k in SWEEP_KEYS} == {k: jr[k] for k in SWEEP_KEYS}
    assert [{k: s[k] for k in PAGE_KEYS} for s in rb["page_stats"]] == \
        [{k: s[k] for k in PAGE_KEYS} for s in jr["page_stats"]]
    assert set(rb) == set(jr) | {"scan_route"}
    np.testing.assert_array_equal(enc_b, jstore["x"].enc)


def test_controller_zero_flag_sweep(rng):
    """A clean sweep decodes nothing on either path and leaves storage
    untouched."""
    code, tcode = _codes("wl64_r08")
    clean = np_encode_words(rng.integers(0, code.p, (64, code.k)),
                            code).astype(np.int8)
    for coalesce in (False, True):
        rep, enc = _sweep(tcode, clean, coalesce)
        assert rep["flagged"] == rep["corrected"] == 0
        np.testing.assert_array_equal(enc, clean)
