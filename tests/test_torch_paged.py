"""Port parity: the device-resident paged store and its quantization bridge.

`repro_torch.memory.paged` against the JAX package's `repro.memory.paged`
on identical numpy inputs, on the CPU: quantized words and scales, stored
pages after `append_words`, and — on the same numpy-corrupted codewords
written into both stores with `append_encoded` — corrected pages
(`read_page_corrected`, `iter_corrected`, `read_corrected`,
`read_words`), `decode_stream` results, both scrub modes (reports, repaired
storage) and the stores' `ControllerStats`, all exactly equal (but for the
LLV totals of `decode_stream`, see its test). Randomness never crosses
frameworks: the corruption is drawn once with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_code as jget_code
from repro.memory import paged as jpaged
from repro_torch.convert import CODE_FIELDS, code_from_arrays
from repro_torch.core import decode_pipelined
from repro_torch.memory import paged, uniform_flip
from _torch_threads import torch_threads_per_worker  # noqa: F401

STAT_SKIP = ("scrub_seconds", "scrub_bandwidth_cells_per_s")


def _codes(name):
    jc = jget_code(name)
    return jc, code_from_arrays({f: getattr(jc, f) for f in CODE_FIELDS})


def _stores(name, page_words, **kw):
    jc, tc = _codes(name)
    return (jpaged.PagedProtectedStore(jc, page_words=page_words, **kw),
            paged.PagedProtectedStore(tc, page_words=page_words,
                                      device="cpu", **kw))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_stats(js, ts):
    a, b = js.stats.as_dict(), ts.stats.as_dict()
    for k in STAT_SKIP:
        a.pop(k), b.pop(k)
    assert a == b


def _kv_tensor(rng, shape, edge=False):
    x = rng.standard_normal(shape).astype(np.float32) * 3
    if edge:
        x.reshape(-1)[:5] = [0.0, 1e-3, -1e-3, 40.0, -40.0]
    return x


@pytest.mark.parametrize("code_name", ["wl40_r08", "wl160_r08"])
@pytest.mark.parametrize("shape,edge", [((2, 4, 2, 8), False),
                                        ((3, 5, 7), True), ((1,), False)])
def test_quantize_bridge_bit_exact(code_name, shape, edge, rng):
    """Words, scale and the dequantized bf16 tensor are identical."""
    code = jget_code(code_name)
    x = _kv_tensor(rng, shape, edge)
    jw, jm = jpaged.quantize_tensor(jnp.asarray(x, jnp.bfloat16), code.p,
                                    code.k)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tw, tm = paged.quantize_tensor(xt, code.p, code.k)
    assert tw.dtype == torch.int8 and tm.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    assert float(tm.scale) == float(jm.scale)
    assert tm.n_words == jm.n_words == paged.words_for_tensor(
        shape, code.p, code.k)
    jd = np.asarray(jpaged.dequantize_tensor(jw, jm, code.p))
    td = paged.dequantize_tensor(tw, tm, code.p)
    np.testing.assert_array_equal(td.float().numpy(), jd.astype(np.float32))


def test_append_words_stores_identical_pages(rng):
    """Appends of several sizes across page boundaries (a trailing page
    topped up by the next append) give bit-identical stored pages."""
    js, ts = _stores("wl40_r08", page_words=16)
    k = js.code.k
    for m in (5, 16, 30, 1):
        u = rng.integers(0, 3, (m, k))
        assert js.append_words(jnp.asarray(u)) == ts.append_words(
            torch.as_tensor(u))
    assert js.n_pages == ts.n_pages == 4
    np.testing.assert_array_equal(_np(ts.export_words()),
                                  js.export_words())
    for i in range(js.n_pages):
        assert ts.page(i).dtype == torch.int8
        np.testing.assert_array_equal(_np(ts.page(i)), np.asarray(js.page(i)))
    _assert_stats(js, ts)


def _corrupted_pair(rng, *, rate, name="wl40_r08", page_words=16, m=70):
    """Two stores holding the same numpy-corrupted codewords."""
    src, _ = _stores(name, page_words)
    src.append_words(jnp.asarray(rng.integers(0, 3, (m, src.code.k))))
    enc = src.export_words().astype(np.int64)
    hit = rng.random(enc.shape) < rate
    enc[hit] = (enc[hit] + rng.integers(1, 3, hit.sum())) % 3
    js, ts = _stores(name, page_words, n_iters=8)
    js.append_encoded(jnp.asarray(enc))
    ts.append_encoded(torch.as_tensor(enc))
    return js, ts


# a light rate (every flagged word corrected) and a heavy one (some words
# beyond the code's strength, so the uncorrectable accounting is exercised)
RATES = [0.01, 0.06]


@pytest.mark.parametrize("rate", RATES)
def test_corrected_reads_match(rate, rng):
    js, ts = _corrupted_pair(rng, rate=rate)
    for i in range(js.n_pages):
        np.testing.assert_array_equal(_np(ts.read_page_corrected(i)),
                                      np.asarray(js.read_page_corrected(i)))
    _assert_stats(js, ts)
    assert ts.stats.detected > 0
    if rate > 0.05:
        assert ts.stats.uncorrectable > 0
    np.testing.assert_array_equal(_np(ts.scan_flags()), js.scan_flags())
    np.testing.assert_array_equal(_np(ts.read_corrected()),
                                  np.asarray(js.read_corrected()))
    for start, stop in ((0, 70), (3, 40), (16, 32), (69, 70), (5, 5)):
        for corrected in (True, False):
            np.testing.assert_array_equal(
                _np(ts.read_info(start, stop, corrected=corrected)),
                np.asarray(js.read_info(start, stop, corrected=corrected)))
    _assert_stats(js, ts)


@pytest.mark.parametrize("scan_first", [True, False])
def test_iter_corrected_matches(scan_first, rng):
    js, ts = _corrupted_pair(rng, rate=0.02)
    got = list(ts.iter_corrected(scan_first=scan_first, depth=2))
    want = list(js.iter_corrected(scan_first=scan_first, depth=2))
    assert len(got) == len(want) == js.n_pages
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    _assert_stats(js, ts)


def test_decode_stream_is_pipelined_decode(rng):
    """The store's decode_stream and decode_pipelined over its pages give
    the JAX store's per-page results, at every pipeline depth: corrected
    words, symbols, detect_fail and iterations exactly; the LLV totals to
    rtol 1e-5, since the JAX pipeline's executable (`_chunk_runner`) fuses
    the damped update in another order than the eager decoder."""
    js, ts = _corrupted_pair(rng, rate=0.03)
    want = list(js.decode_stream())
    for depth in (1, 3):
        got = list(ts.decode_stream(depth=depth))
        assert len(got) == len(want)
        for (ty, tr), (jy, jr) in zip(got, want, strict=True):
            np.testing.assert_array_equal(_np(ty), np.asarray(jy))
            for field in ("symbols", "detect_fail", "iterations"):
                np.testing.assert_array_equal(
                    _np(getattr(tr, field)), np.asarray(getattr(jr, field)))
            np.testing.assert_allclose(_np(tr.llv_totals),
                                       np.asarray(jr.llv_totals), rtol=1e-5)
    pages = list(ts._iter_pages())
    direct = list(decode_pipelined(ts.code, pages, chunk_size=16,
                                   n_iters=8, damping=0.3))
    for (a, _), (b, _) in zip(direct, want, strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    with pytest.raises(ValueError, match="depth"):
        decode_pipelined(ts.code, pages, depth=0)


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("rate", RATES)
def test_scrub_matches(coalesce, rate, rng):
    js, ts = _corrupted_pair(rng, rate=rate)
    jr = js.scrub(coalesce=coalesce)
    tr = ts.scrub(coalesce=coalesce)
    for key in ("pages", "flagged_words", "repaired_words", "coalesced"):
        assert tr[key] == jr[key], key
    if coalesce:
        for key in ("entries", "words", "repaired", "failed"):
            assert tr["drain"][key] == jr["drain"][key], key
    assert tr["flagged_words"] > 0
    np.testing.assert_array_equal(_np(ts.export_words()), js.export_words())
    _assert_stats(js, ts)
    # a page subset, then a second sweep over what the first left
    assert ts.scrub([0, 2], coalesce=coalesce)["pages"] == \
        js.scrub([0, 2], coalesce=coalesce)["pages"] == 2
    np.testing.assert_array_equal(_np(ts.export_words()), js.export_words())
    _assert_stats(js, ts)


def test_scrub_modes_repair_identically(rng):
    _, a = _corrupted_pair(rng, rate=0.04)
    b = paged.PagedProtectedStore(a.code, page_words=16, n_iters=8,
                                  device="cpu")
    b.append_encoded(a.export_words())
    ra, rb = a.scrub(coalesce=True), b.scrub(coalesce=False)
    assert (ra["flagged_words"], ra["repaired_words"]) == \
        (rb["flagged_words"], rb["repaired_words"])
    assert torch.equal(a.export_words(), b.export_words())


def test_inject_draws_from_generators(rng):
    """The port's own channel: a seed reproduces its pattern, the store's
    generator moves on between injections, the rate is the channel's."""
    _, ts = _corrupted_pair(rng, rate=0.0, m=400)
    clean = ts.export_words().clone()
    copies = []
    for key in (11, 11, None, None):
        s = paged.PagedProtectedStore(ts.code, page_words=16, device="cpu")
        s.append_encoded(clean)
        n = s.inject(uniform_flip(3, 0.05), key)
        if key is None:
            n += s.inject(uniform_flip(3, 0.05))
        copies.append((n, s.export_words()))
    assert torch.equal(copies[0][1], copies[1][1])
    assert not torch.equal(copies[0][1], clean)
    cells = clean.numel()
    assert 0.03 < copies[0][0] / cells < 0.07
    assert 0.07 < copies[2][0] / cells < 0.13
    with pytest.raises(ValueError, match="alphabet"):
        ts.inject(uniform_flip(5, 0.1))


def test_store_rejects_bad_inputs():
    s = paged.PagedProtectedStore("wl40_r08", page_words=8, device="cpu")
    with pytest.raises(ValueError, match="info words"):
        s.append_words(torch.zeros((2, 5), dtype=torch.int8))
    with pytest.raises(ValueError, match="codewords"):
        s.append_encoded(torch.zeros((2, 5), dtype=torch.int8))
    with pytest.raises(ValueError, match="page_words"):
        paged.PagedProtectedStore("wl40_r08", page_words=0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        s.read_words(0, 1)
    assert s.scan_flags().numel() == 0 and s.read_corrected().shape == (0, 40)
