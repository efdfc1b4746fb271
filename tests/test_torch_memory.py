"""Port parity: memory mode. `repro_torch.memory.ProtectedMemoryArray`
against the JAX package's on identical cells: both arrays hold the same
code (the reference's arrays carried across with `code_from_arrays`) and
import the same numpy-corrupted words. Read-back bytes, `ControllerStats`,
from _torch_threads import torch_threads_per_worker  # noqa: F401
repaired storage and sweep/drain reports must match for all three
policies. The port's channel models are checked on their error rates."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codes import REGISTRY
from repro.core.construction import build_code
from repro.memory import ProtectedMemoryArray as JArray
from repro.memory import MemoryController as JController
from repro.memory import StoredTensor as JStored
from repro.memory import packing as jpacking
from repro.kernels.backend import policy_from_scan_backend
from repro_torch.convert import (CODE_FIELDS, code_from_arrays,
                                 stored_from_arrays)
from repro_torch.core import decode_integers, get_code, np_encode_words
from repro_torch.core import build_code as tbuild_code
from repro_torch.memory import (Compose, MemoryController,
                                ProtectedMemoryArray, ReadDisturb,
                                RepairQueue, RetentionDrift, StuckAt,
                                asymmetric_adjacent, packing, uniform_flip)

REPORT_KEYS = ("words_scanned", "cells_scanned", "flagged", "corrected",
               "uncorrectable", "pages", "page_words", "page_stats_truncated",
               "coalesced", "scan_ahead", "drains")
# the reference's drain reports also count the zero-word rows it pads a
# tail chunk with (`pad_rows`, ...); the port pads nothing
DRAIN_KEYS = ("entries", "words", "repaired", "failed")


def _pair(policy, name="wl40_r08", **kw):
    """A reference array on a freshly built code object and a port array
    on the same code."""
    n, k, p, dv = REGISTRY[name]
    jc = build_code.__wrapped__(n, k, p=p, dv=dv, seed=0)
    tc = code_from_arrays({f: getattr(jc, f) for f in CODE_FIELDS})
    jm = JArray(jc, controller=policy, chunk_size=32, **kw)
    tm = ProtectedMemoryArray(tc, controller=policy, chunk_size=32,
                              device="cpu", **kw)
    return jm, tm


def _corrupt_both(jm, tm, name, rng, rate):
    st = jm.stored(name)
    enc = st.enc.astype(np.int64)
    hit = rng.random(enc.shape) < rate
    enc[hit] = (enc[hit] + rng.integers(1, jm.code.p, hit.sum())) % jm.code.p
    jm.import_stored(name, JStored(enc.astype(np.int8), st.dtype, st.shape,
                                   st.nbytes))
    tm.import_stored(name, stored_from_arrays(enc, st.dtype, st.shape,
                                              st.nbytes, device="cpu"))


def _assert_stats(jm, tm):
    a, b = jm.stats.as_dict(), tm.stats.as_dict()
    for k in ("scrub_seconds", "scrub_bandwidth_cells_per_s"):
        a.pop(k), b.pop(k)
    assert a == b


def _assert_storage(jm, tm):
    for name in jm.names:
        assert np.array_equal(jm.stored(name).enc,
                              tm.stored(name).enc.numpy()), name


def _assert_reports(ra, rb):
    assert {k: ra[k] for k in REPORT_KEYS} == {k: rb[k] for k in REPORT_KEYS}
    assert ra["page_stats"] == rb["page_stats"]
    assert [{k: d[k] for k in DRAIN_KEYS} for d in ra["drain_stats"]] == \
        [{k: d[k] for k in DRAIN_KEYS} for d in rb["drain_stats"]]


@pytest.mark.parametrize("policy", ["basic", "writeback", "scrub"])
def test_read_and_scrub_match_reference(policy):
    rng = np.random.default_rng(21)
    jm, tm = _pair(policy)
    if policy == "scrub":
        jm.controller.interval = tm.controller.interval = 10 ** 9
    t = rng.normal(size=(20, 9)).astype(np.float32)
    jm.write("t", t)
    st = tm.write("t", torch.as_tensor(t))
    assert st.dtype == "float32" and st.shape == (20, 9)
    _assert_storage(jm, tm)
    _corrupt_both(jm, tm, "t", rng, 0.008)
    for _ in range(2):
        a, b = jm.read("t"), tm.read("t")
        assert np.array_equal(a, b) and b.dtype == np.float32
        _assert_stats(jm, tm)
        _assert_storage(jm, tm)
    assert 0 < jm.stats.uncorrectable < jm.stats.detected   # both kinds
    _assert_reports(jm.scrub(), tm.scrub())
    _assert_stats(jm, tm)
    _assert_storage(jm, tm)


def test_paged_sweep_with_several_drains_matches_reference():
    rng = np.random.default_rng(22)
    jm, tm = _pair("basic")
    for i, shape in enumerate([(30, 7), (11,), (5, 5, 3)]):
        arr = rng.integers(-1000, 1000, shape).astype(np.int32)
        jm.write(f"a{i}", arr)
        tm.write(f"a{i}", arr)
    for name in jm.names:
        _corrupt_both(jm, tm, name, rng, 0.005)
    kw = dict(page_words=6, scan_ahead=2, drain_words=5)
    ra = jm.scrub_pages(jm.iter_pages(6), **kw)
    rb = tm.scrub_pages(tm.iter_pages(6), **kw)
    assert rb["drains"] > 1 and rb["pages"] > 4
    _assert_reports(ra, rb)
    _assert_storage(jm, tm)
    for name in jm.names:
        assert np.array_equal(jm.read(name), tm.read(name))


def test_scrub_policy_ticks_match_reference():
    rng = np.random.default_rng(23)
    jm, tm = _pair("scrub", interval=3)
    t = rng.integers(0, 255, 300).astype(np.uint8)
    jm.write("t", t)
    tm.write("t", t)
    _corrupt_both(jm, tm, "t", rng, 0.004)
    for _ in range(4):
        assert np.array_equal(jm.read("t"), tm.read("t"))
    assert tm.stats.scrub_rounds == 1
    _assert_stats(jm, tm)
    _assert_storage(jm, tm)


def test_uncorrected_read_and_inject():
    tm = ProtectedMemoryArray("wl40_r08", controller="writeback",
                              device="cpu")
    x = torch.arange(64, dtype=torch.int16).reshape(8, 8)
    tm.write("x", x)
    assert np.array_equal(tm.read("x", correct=False), x.numpy())
    changed = tm.inject(uniform_flip(3, 0.01), key=5)
    assert changed == int((tm.stored("x").enc.numpy() !=
                           ProtectedMemoryArray("wl40_r08", device="cpu")
                           .write("x", x).enc.numpy()).sum())
    with pytest.raises(ValueError, match="alphabet"):
        tm.inject(uniform_flip(5, 0.01))


def test_repair_queue_decodes_unpadded_chunks_like_single_words():
    """A drain of 37 rows in chunks of 16 (a 5-row tail, not padded)
    repairs each row as decoding it alone does, and writes every entry
    back."""
    rng = np.random.default_rng(24)
    code = get_code("wl40_r08")
    y = np_encode_words(rng.integers(0, code.p, (37, code.k)), code)
    hit = rng.random(y.shape) < 0.03
    y[hit] = (y[hit] + 1) % code.p
    words = torch.as_tensor(y, dtype=torch.int8)
    q = RepairQueue(code, chunk_size=16, n_iters=8, device="cpu")
    got = {}
    for lo, hi in ((0, 20), (20, 37)):
        q.enqueue(words[lo:hi], lambda s, ok, lo=lo: got.update({lo: (s, ok)}),
                  owner=lo)
    rep = q.drain()
    syms = torch.cat([got[0][0], got[20][0]])
    ok = torch.cat([got[0][1], got[20][1]])
    want = [decode_integers(code, y[i:i + 1], n_iters=8, damping=0.3,
                            early_exit=True, device="cpu")[1]
            for i in range(37)]
    assert torch.equal(syms, torch.cat([r.symbols for r in want]))
    assert torch.equal(ok, ~torch.cat([r.detect_fail for r in want]))
    assert rep["words"] == 37 and rep["entries"] == 2
    assert rep["repaired"] + rep["failed"] == 37 and rep["repaired"] > 0
    assert q.pending_words == 0 and q.drain()["words"] == 0


@pytest.mark.parametrize("p", [3, 5, 7])
def test_packing_matches_reference(p, rng):
    raw = rng.integers(0, 256, 333).astype(np.uint8)
    want = np.asarray(jpacking.symbolize_u8(jnp.asarray(raw), p))
    got = packing.symbolize_u8(torch.as_tensor(raw), p)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    noisy = want.copy()
    noisy[::7, 0] = p                          # out-of-field digits clip
    assert np.array_equal(
        packing.desymbolize_u8(torch.as_tensor(noisy), p).numpy(),
        np.asarray(jpacking.desymbolize_u8(jnp.asarray(noisy), p)))


@pytest.mark.parametrize("ch", [
    uniform_flip(3, 0.05),
    asymmetric_adjacent(3, 0.04, 0.01),
    RetentionDrift(3, rate=1e-3, rest_level=0),
    ReadDisturb(3, per_read=1e-3),
    Compose(asymmetric_adjacent(5, 0.02, 0.01), RetentionDrift(5, 1e-3)),
])
def test_channel_transition_frequencies(ch):
    """Empirical level transitions of the port's channels match their
    (p, p) transition matrix."""
    p = ch.p
    levels = torch.arange(p, dtype=torch.int8).repeat(40000)
    gen = torch.Generator().manual_seed(0)
    kw = dict(t=100.0, n_reads=50)
    out = ch.apply(gen, levels, **kw)
    T = ch.transition(**kw)
    for i in range(p):
        freq = torch.bincount(out[levels == i].long(), minlength=p).numpy()
        assert np.allclose(freq / 40000, T[i], atol=0.006), (i, freq)
    again = ch.apply(torch.Generator().manual_seed(0), levels, **kw)
    assert torch.equal(out, again)


def test_stuck_cells_are_persistent_and_at_rate():
    ch = StuckAt(3, fraction=0.05, stuck_level=1, seed=3)
    levels = torch.zeros(100000, dtype=torch.int8)
    a = ch.apply(torch.Generator().manual_seed(0), levels)
    b = ch.apply(torch.Generator().manual_seed(9), levels)
    assert torch.equal(a, b)
    assert abs((a == 1).float().mean().item() - 0.05) < 0.005


# ---------------------------------------------------------------------------
# fields past int8: the exact scan route (the JAX package's big-field tests)
# ---------------------------------------------------------------------------

def _host_controller():
    return JController(policy=policy_from_scan_backend("host"),
                       use_sharded=False)


def test_big_field_scan_is_exact(rng):
    """Mirror of the JAX package's GF(4099) test: n (p - 1)^2 >= 2^24, where
    a float32 product misflags valid words. The port's scan routes to the
    exact product, flags no clean codeword and every corrupted one, as the
    reference's host scan does on the same words."""
    code = tbuild_code(64, 48, p=4099, dv=4, seed=0)
    assert code.n * (code.p - 1) ** 2 >= 2 ** 24
    w = rng.integers(0, code.p, (32, code.k))
    enc = np_encode_words(w, code)
    ctl = MemoryController(device="cpu")
    assert ctl._scan_route(code) == "exact"
    host = _host_controller()
    jcode = build_code(64, 48, p=4099, dv=4, seed=0)
    for _ in range(2):
        got = ctl._scan(code, torch.as_tensor(enc)).numpy()
        assert np.array_equal(got, host._scan_syndromes(jcode, enc))
        enc[:, 0] = (enc[:, 0] + 1) % code.p
    assert got.all()


def test_big_field_past_the_kernel_bound_routes_to_exact(rng):
    """Mirror of the JAX package's GF(8191) test: n (p - 1)^2 >= 2^31, past
    the int32 scan kernel, routes to the exact scan, and a sweep reports
    that route. (GF(8191) is not decoded: its (p, p) tables are the
    reference's limit too, so only clean pages are swept.)"""
    code = tbuild_code(48, 40, p=8191, dv=4, seed=0)
    assert code.n * (code.p - 1) ** 2 >= 2 ** 31
    w = rng.integers(0, code.p, (16, code.k))
    enc = torch.as_tensor(np_encode_words(w, code))
    ctl = MemoryController(device="cpu")
    assert ctl._scan_route(code) == "exact"
    assert not ctl._scan(code, enc).any()
    rep = ctl.scrub_pages(code, iter([enc]))
    assert rep["scan_route"] == "exact" and rep["flagged"] == 0
    enc[:, 3] = (enc[:, 3] + 1) % code.p
    assert ctl._scan(code, enc).all()
    assert MemoryController._scan_route(get_code("wl1024_r08")) == "kernel"


def test_gf257_array_stores_wide_cells_and_reads_back(rng):
    """A GF(257) array holds its cells in int16 (int8 would wrap symbols
    past 127): a written tensor scans clean and reads back exactly, and
    one changed cell is flagged by the scan the read runs."""
    code = tbuild_code(64, 48, p=257, dv=4, seed=0)
    mem = ProtectedMemoryArray(code, controller="basic", device="cpu")
    t = rng.integers(0, 256, 500).astype(np.uint8)
    st = mem.write("t", t)
    assert st.enc.dtype == torch.int16 and int(st.enc.max()) > 127
    assert not mem.controller._scan(code, st.enc).any()
    assert np.array_equal(mem.read("t"), t)
    st.enc[3, 5] = (st.enc[3, 5] + 1) % code.p
    flags = mem.controller._scan(code, st.enc)
    assert flags.nonzero().flatten().tolist() == [3]
