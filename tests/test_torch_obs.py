"""Port parity: the observability layer (`repro_torch.obs`) and its hooks
in the codec, the memory layers, the KV layer and the serving engine,
against the JAX package's `repro.obs`, on the CPU.

- Every case of `tests/test_obs.py` mirrored on the port.
- Scripted parity: the same calls into both packages' registries,
  estimators and tracers give equal snapshots, Prometheus text, JSONL
  records (but for their time stamps), adaptive intervals, hot-region
  rankings and (name, ph, depth, args) span sequences.
- The hooks on identical numpy-corrupted words, poked into storage as
  `tests/test_torch_pool.py` does: `MemoryController.read` and
  `scrub_pages` (coalesced and per page), `read_page_corrected` by
  tenant, pool scrubs with per-owner counters and regions, the KV layer's
  freeze and injection telemetry, and the serving engine with all three
  pillars installed, against the JAX engine. Metric snapshots and
  estimator snapshots are exactly equal, with two differences by design:
  the port pads no repair chunk, so its `repair_pad_rows` counter is 0
  where the JAX one counts bucket padding; and `*_seconds` histograms are
  wall times, compared by `count` only.
- Injection draws from torch generators on the port, so the KV layer's
  injection telemetry is held to each package's own returned count.
- With nothing installed, no path constructs an instrument or records an
  event.

The engine case reuses `tests/test_torch_engine.py`'s tiny model on the
JAX `init_params` unscaled, for the reason stated there (the reference's
top-2 margins at the scaled init fall to one bf16 ulp).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.core import get_code as jget_code
from repro.core import np_encode_words
from repro.memory import PagedProtectedStore as JStore
from repro.memory import ProtectedMemoryArray as JArray
from repro.memory import ProtectedPagePool as JPool
from repro.memory.array import StoredTensor as JStored
from repro.memory.controller import MemoryController as JController
from repro.models import ProtectedKVConfig as JPKV
from repro.models import init_params as jinit_params
from repro.models.kv import ProtectedKVLayer as JLayer
from repro.obs import ras as jras
from repro.serving import ServingEngine as JEngine
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_arrays
from repro_torch.core import get_code
from repro_torch.memory import (MemoryController, PagedProtectedStore,
                                ProtectedMemoryArray, ProtectedPagePool,
                                uniform_flip, words_for_tensor)
from repro_torch.memory.controller import ControllerStats
from repro_torch.models import ProtectedKVConfig, ProtectedKVLayer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import ras as obs_ras
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import ServingEngine
from _torch_threads import torch_threads_per_worker  # noqa: F401

TINY = dict(n_groups=2, d_model=32, n_heads=2, d_ff=64, vocab=128)
ENGINE_CODE = "wl160_r08"
PAGE_TOKENS = 8


# -- comparison helpers -------------------------------------------------------


def _norm(snap: dict) -> dict:
    """A metrics snapshot with the differences by design taken out:
    `*_seconds` histograms keep their count only, `repair_pad_rows`
    its labels only."""
    out = {}
    for name, ent in snap.items():
        rows = []
        for row in ent["series"]:
            if name.endswith("_seconds") and ent["kind"] == "histogram":
                row = {"labels": row["labels"], "count": row["count"]}
            elif name == "repair_pad_rows":
                row = {"labels": row["labels"]}
            rows.append(row)
        out[name] = {"kind": ent["kind"], "series": rows}
    return out


def _assert_same_metrics(treg, jreg):
    tsnap, jsnap = treg.snapshot(), jreg.snapshot()
    assert _norm(tsnap) == _norm(jsnap)
    for row in tsnap.get("repair_pad_rows", {"series": []})["series"]:
        assert row["value"] == 0.0          # the port pads nothing


def _spans(tracer) -> list:
    return [(e["name"], e["ph"], e["args"].get("depth"), e["args"])
            for e in tracer.events()]


def _pillars():
    return (obs.MetricsRegistry(), obs.Tracer(), obs.ErrorRateEstimator(),
            jobs.MetricsRegistry(), jobs.Tracer(), jobs.ErrorRateEstimator())


def _corrupt(rng, page: np.ndarray, rate: float, p: int) -> np.ndarray:
    page = np.asarray(page).astype(np.int64)
    hit = rng.random(page.shape) < rate
    page[hit] = (page[hit] + rng.integers(1, p, hit.sum())) % p
    return page


# ---------------------------------------------------------------------------
# the JAX file's cases, on the port
# ---------------------------------------------------------------------------


def test_registry_instruments_and_snapshot_roundtrip():
    reg = obs.MetricsRegistry()
    reg.counter("reads", layer="controller", tenant="a").inc(3)
    reg.counter("reads", layer="controller", tenant="a").inc(2)
    reg.gauge("slots", layer="engine").set(7)
    h = reg.histogram("lat", layer="engine")
    for v in (0.001, 0.003, 0.2):
        h.observe(v)
    snap = json.loads(json.dumps(reg.snapshot()))
    assert obs.MetricsRegistry.value(snap, "reads", tenant="a",
                                     layer="controller") == 5.0
    assert reg.counter("reads", tenant="a", layer="controller").value == 5.0
    assert obs.MetricsRegistry.value(snap, "slots", layer="engine") == 7.0
    hist = snap["lat"]["series"][0]
    assert hist["count"] == 3 and hist["sum"] == pytest.approx(0.204)
    assert hist["buckets"]["+Inf"] == 3
    assert obs.MetricsRegistry.value(snap, "nope") is None


def test_registry_kind_mismatch_rejected():
    reg = obs.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="registered as counter"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="max_series"):
        obs.MetricsRegistry(max_series=0)
    with pytest.raises(ValueError, match=">= 0"):
        reg.counter("y").inc(-1)


def test_registry_label_cardinality_bounded():
    reg = obs.MetricsRegistry(max_series=4)
    for i in range(4):
        reg.counter("hits", tenant=str(i)).inc()
    with pytest.warns(RuntimeWarning, match="max_series"):
        reg.counter("hits", tenant="overflowing").inc()
    reg.counter("hits", tenant="another").inc()         # warns only once
    snap = reg.snapshot()
    assert len(snap["hits"]["series"]) == 5
    assert obs.MetricsRegistry.value(snap, "hits", overflow="true") == 2.0


def test_registry_exporters():
    reg = obs.MetricsRegistry()
    reg.counter("mem_detected", code="gf3n32").inc(4)
    reg.histogram("step_s").observe(0.01)
    text = reg.to_prometheus()
    assert '# TYPE mem_detected_total counter' in text
    assert 'mem_detected_total{code="gf3n32"} 4.0' in text
    assert 'step_s_bucket{le="0.01"} 1' in text
    assert "step_s_count 1" in text


def test_registry_append_jsonl(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("c").inc()
    path = tmp_path / "m.jsonl"
    reg.append_jsonl(str(path), meta={"bench": "unit"})
    reg.append_jsonl(str(path))
    lines = path.read_text().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["bench"] == "unit"
    assert rec["metrics"]["c"]["series"][0]["value"] == 1.0


def test_span_nesting_and_chrome_trace_export(tmp_path):
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        with obs.span("outer", step=1) as sp:
            with obs.span("inner"):
                pass
            sp.set(tokens=4)
        tr.instant("mark", kind="preempt")
    path = tmp_path / "trace.json"
    doc = tr.to_chrome_trace(str(path))
    loaded = json.loads(path.read_text())
    assert loaded["traceEvents"] == doc["traceEvents"]
    inner, outer = tr.spans("inner")[0], tr.spans("outer")[0]
    assert outer["args"]["depth"] == 0 and inner["args"]["depth"] == 1
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["args"] == {"step": 1, "tokens": 4, "depth": 0}
    marks = [e for e in tr.events() if e["ph"] == "i"]
    assert marks and marks[0]["name"] == "mark"


def test_tracer_bounds_event_count():
    tr = obs.Tracer(max_events=3)
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    doc = tr.to_chrome_trace()
    assert len(doc["traceEvents"]) == 3
    assert doc["otherData"]["dropped_events"] == 2
    assert [e["name"] for e in doc["traceEvents"]] == ["s2", "s3", "s4"]


def test_span_disabled_is_shared_noop():
    assert obs_trace.current() is obs_trace.NULL_TRACER
    a = obs.span("anything", step=1)
    b = obs.span("else", sync=torch.zeros(2))
    assert a is b
    with a as s:
        s.set(x=1)


def test_span_sync_and_profiler_bridge_on_cpu():
    """`sync=` takes a tensor or a structure of them (CPU tensors need no
    wait); `Tracer(torch_profiler=True)` puts every span's name into a
    `torch.profiler` capture."""
    tr = obs.Tracer(torch_profiler=True)
    x = torch.ones(4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.use_tracer(tr):
            with obs.span("outer.block", sync=(x, {"y": [x * 2]})):
                with obs.span("inner.block", sync=x):
                    (x + 1).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"outer.block", "inner.block"} <= names
    assert [e["name"] for e in tr.spans()] == ["inner.block", "outer.block"]


def test_ewma_converges_to_channel_flag_rate():
    eps, n = 2e-3, 40
    ch = uniform_flip(3, eps)
    f_exp = obs_ras.expected_flag_rate(ch.T, n)
    est = obs.ErrorRateEstimator(alpha=0.05)
    rng = np.random.default_rng(0)
    words = 512
    for _ in range(400):
        flagged = int(rng.binomial(words, f_exp))
        est.observe_scan(flagged, words, n_symbols=n, region="bank0")
    r = est.region("bank0")
    assert r.flag_rate == pytest.approx(f_exp, rel=0.15)
    assert r.raw_ber() == pytest.approx(eps, rel=0.15)
    assert obs_ras.invert_flag_rate(f_exp, n) == pytest.approx(eps, rel=1e-6)
    assert f_exp == jras.expected_flag_rate(ch.T, n)
    assert obs_ras.invert_flag_rate(f_exp, n) == \
        jras.invert_flag_rate(f_exp, n)


def test_estimator_stress_and_adaptive_interval():
    est = obs.ErrorRateEstimator(alpha=0.5, target_flag_rate=0.05)
    for _ in range(8):
        est.observe_scan(0, 1024, region="cold")
    assert est.adaptive_interval(16, region="cold") > 16
    for _ in range(8):
        est.observe_scan(512, 1024, region="hot")
        est.observe_decode([10, 10, 10], 10, detect_fail=[0, 0, 1],
                           region="hot")
    assert est.region("hot").stress == pytest.approx(1.0)
    assert est.adaptive_interval(16, region="hot") < 16
    assert est.hot_regions(1)[0][0] == "hot"
    json.dumps(est.snapshot())
    assert est.region("hot").residual_ber_proxy() > 0
    with pytest.raises(ValueError, match="alpha"):
        obs.ErrorRateEstimator(alpha=0.0)


def test_estimator_publish_to_registry():
    est = obs.ErrorRateEstimator(alpha=1.0)
    est.observe_scan(8, 64, n_symbols=32, region="t0")
    reg = obs.MetricsRegistry()
    est.publish(reg)
    snap = reg.snapshot()
    assert obs.MetricsRegistry.value(snap, "ras_flag_rate", layer="ras",
                                     region="t0") == pytest.approx(0.125)
    assert obs.MetricsRegistry.value(snap, "ras_raw_ber", layer="ras",
                                     region="t0") > 0


def test_disabled_hot_paths_allocate_no_instruments():
    """With no ambient registry, tracer or estimator, the instrumented
    read / scrub / decode paths construct no instrument and record no
    event."""
    assert obs_metrics.current() is obs_metrics.NULL_REGISTRY
    assert obs_ras.current() is obs_ras.NULL_ESTIMATOR
    rng = np.random.default_rng(0)
    code = get_code("wl32_r08")
    u = rng.integers(0, code.p, (12, code.k))
    st = PagedProtectedStore(code, page_words=8, device="cpu")
    st.append_words(torch.as_tensor(u))
    st.owner = "t"
    st._pages[0] = torch.as_tensor(_corrupt(rng, st.page(0), 0.05, code.p),
                                   dtype=torch.int8)
    ctl = MemoryController(device="cpu")
    enc = torch.as_tensor(
        _corrupt(rng, np_encode_words(u, jget_code("wl32_r08")), 0.05,
                 code.p), dtype=torch.int8)
    before = obs.instrument_count()
    for i in range(st.n_pages):
        st.read_page_corrected(i)
    assert st.stats.detected > 0
    ctl.scrub_pages(code, iter([enc.clone()]))
    ctl.scrub_pages(code, iter([enc.clone()]), coalesce=False)
    assert obs.instrument_count() == before
    assert obs_trace.current().events() == []
    assert obs_metrics.current().snapshot() == {}


def test_ambient_installers_nest_and_restore():
    reg, tr, est = (obs.MetricsRegistry(), obs.Tracer(),
                    obs.ErrorRateEstimator())
    with obs.use_metrics(reg), obs.use_tracer(tr), obs.use_estimator(est):
        assert obs.current_metrics() is reg
        assert obs.current_tracer() is tr
        assert obs.current_estimator() is est
        with obs.use_metrics() as inner:
            assert obs_metrics.current() is inner is not reg
        assert obs_metrics.current() is reg
    assert obs_metrics.current() is obs.NULL_REGISTRY
    assert obs_trace.current() is obs.NULL_TRACER
    assert obs_ras.current() is obs.NULL_ESTIMATOR


def test_controller_stats_merge_and_add_counts():
    a, b = ControllerStats(), ControllerStats()
    a.detected, a.corrected, a.words_read = 3, 2, 10
    b.detected, b.corrected, b.uncorrectable = 1, 1, 5
    out = ControllerStats().merge(a).merge(b)
    assert (out.detected, out.corrected, out.uncorrectable) == (4, 3, 5)
    assert out.words_read == 10
    assert a.correction_counts() == {"detected": 3, "corrected": 2,
                                     "uncorrectable": 0}
    acc = dict.fromkeys(ControllerStats.CORRECTION_KEYS, 0)
    ControllerStats.add_counts(acc, a)
    ControllerStats.add_counts(acc, {"detected": 2, "scrub_flagged": 7})
    assert acc["detected"] == 5 and acc["corrected"] == 2
    assert "scrub_flagged" not in acc


def test_stats_publish_gauges_are_idempotent():
    from repro.memory.controller import ControllerStats as JStats
    s, js = ControllerStats(), JStats()
    s.detected = js.detected = 9
    s.scrub_seconds = js.scrub_seconds = 0.5
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    for _ in range(2):                  # gauge-set, not counter-inc
        s.publish(reg, layer="pool")
        js.publish(jreg, layer="pool")
    snap = reg.snapshot()
    assert obs.MetricsRegistry.value(snap, "controller_detected",
                                     layer="pool") == 9.0
    assert snap == jreg.snapshot()
    s.publish(obs.NULL_REGISTRY)        # a disabled sink is skipped


def test_pool_prioritized_scrub_orders_by_flag_ewma():
    """The JAX file's case, each step held against the JAX pool: one page
    with exactly one wrong cell in every word (numpy-drawn, the same in
    both pools)."""
    pools = (JPool("wl80_r08", page_words=8, capacity_pages=4),
             ProtectedPagePool("wl80_r08", page_words=8, capacity_pages=4,
                               device="cpu"))
    jpool, pool = pools
    code = jget_code("wl80_r08")
    pids = [[p.alloc(owner=t) for t in "abcd"] for p in pools][1]
    rng = np.random.default_rng(1)
    for pid in pids:
        w = np_encode_words(rng.integers(0, code.p, (8, code.k)), code)
        jpool.set_page(pid, jnp.asarray(w, jnp.int32))
        pool.set_page(pid, torch.as_tensor(w, dtype=torch.int8))
    for p in pools:
        p.scrub()
    hot = pids[2]
    page = np.asarray(jpool.page(hot)).astype(np.int64)
    cols = rng.integers(0, code.n, 8)
    rows = np.arange(8)
    page[rows, cols] = (page[rows, cols]
                        + rng.integers(1, code.p, 8)) % code.p
    jpool.set_page(hot, jnp.asarray(page, jnp.int32))
    pool.set_page(hot, torch.as_tensor(page, dtype=torch.int8))
    est, jest = obs.ErrorRateEstimator(), jobs.ErrorRateEstimator()
    with obs.use_estimator(est):
        rep = pool.scrub()
    with jobs.use_estimator(jest):
        jrep = jpool.scrub()
    assert rep == jrep
    assert rep["flagged_words"] == rep["repaired_words"] == 8
    assert set(rep["by_owner"]) == {"c"}
    assert est.region("c").flag_rate == pytest.approx(1.0)
    assert est.snapshot() == jest.snapshot()
    assert pool.page_flag_rate(hot) == pytest.approx(0.3)
    assert pool.hot_pages(1) == [hot] == jpool.hot_pages(1)
    rep1 = pool.scrub(max_pages=1, prioritize=True)
    assert rep1 == jpool.scrub(max_pages=1, prioritize=True)
    assert rep1["pages"] == 1 and rep1["flagged_words"] == 0
    assert pool.page_flag_rate(hot) == pytest.approx(0.3 * 0.7)
    assert all(pool.page_flag_rate(p) == 0.0 for p in pids if p != hot)


# ---------------------------------------------------------------------------
# scripted parity: the same calls into both packages
# ---------------------------------------------------------------------------


def _script_metrics(m, reg):
    reg.counter("reads", layer="controller", tenant="a").inc(3)
    reg.counter("reads", tenant="b", layer="controller").inc(2.5)
    reg.counter("writes_total").inc()
    reg.gauge("slots", layer="engine").set(7)
    reg.gauge("slots", layer="engine").add(-2.25)
    reg.gauge("ratio").set(1 / 3)
    h = reg.histogram("lat", layer="engine")
    for v in (0.0004, 0.001, 0.003, 0.2, 11.0, 0.05):
        h.observe(v)
    reg.histogram("depth", buckets=(1, 4, 16)).observe(5)
    with pytest.warns(RuntimeWarning, match="max_series"):
        for i in range(6):
            reg.counter("hits", tenant=str(i)).inc(i)


def test_registry_scripted_parity(tmp_path):
    reg = obs.MetricsRegistry(max_series=4)
    jreg = jobs.MetricsRegistry(max_series=4)
    _script_metrics(obs, reg)
    _script_metrics(jobs, jreg)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.to_prometheus() == jreg.to_prometheus()
    for r, name in ((reg, "port"), (jreg, "jax")):
        r.append_jsonl(str(tmp_path / f"{name}.jsonl"), meta={"k": 1})
    recs = [json.loads((tmp_path / f"{n}.jsonl").read_text())
            for n in ("port", "jax")]
    for rec in recs:
        rec.pop("ts")
    assert recs[0] == recs[1]
    snap = reg.snapshot()
    for name, labels in (("reads", {"tenant": "a", "layer": "controller"}),
                         ("lat", {"layer": "engine"}),
                         ("hits", {"overflow": "true"}), ("nope", {})):
        assert obs.MetricsRegistry.value(snap, name, **labels) == \
            jobs.MetricsRegistry.value(snap, name, **labels)


def test_estimator_scripted_parity():
    """Random scan and decode observations over four regions, fed as
    numpy to the JAX estimator and as torch tensors to the port's."""
    rng = np.random.default_rng(3)
    kw = dict(alpha=0.07, target_flag_rate=0.04, stress_threshold=0.6)
    est, jest = obs.ErrorRateEstimator(**kw), jobs.ErrorRateEstimator(**kw)
    for _ in range(60):
        region = str(rng.choice(["", "0", "1", "t"]))
        if rng.random() < 0.5:
            total = int(rng.integers(0, 300))
            flagged = int(rng.integers(0, total + 1)) if total else 0
            n = int(rng.choice([0, 32, 160]))
            for e in (est, jest):
                e.observe_scan(flagged, total, n_symbols=n, region=region)
        else:
            k = int(rng.integers(0, 20))
            iters = rng.integers(1, 9, k).astype(np.int32)
            fail = rng.random(k) < 0.2
            est.observe_decode(torch.from_numpy(iters), 8,
                               detect_fail=torch.from_numpy(fail),
                               region=region)
            jest.observe_decode(jnp.asarray(iters), 8,
                                detect_fail=jnp.asarray(fail),
                                region=region)
    est.observe_decode(3, 8, region="scalar")
    jest.observe_decode(3, 8, region="scalar")
    assert est.snapshot() == jest.snapshot()
    assert est.hot_regions() == jest.hot_regions()
    assert est.hot_regions(2) == jest.hot_regions(2)
    for region in ("", "0", "1", "t", "scalar", "never"):
        assert est.pressure(region) == jest.pressure(region)
        for nominal in (0, 1, 2, 4, 16, 100):
            assert est.adaptive_interval(nominal, region=region) == \
                jest.adaptive_interval(nominal, region=region)
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    est.publish(reg, layer="x")
    jest.publish(jreg, layer="x")
    assert reg.snapshot() == jreg.snapshot()
    assert obs.NULL_ESTIMATOR.adaptive_interval(7) == 7


def _script_trace(m, tr):
    with m.use_tracer(tr):
        with m.span("a", step=0) as sp:
            with m.span("b", k="v"):
                m.span("c").__enter__().__exit__(None, None, None)
            tr.instant("mark", count=2)
            sp.set(active=3)
        for i in range(3):
            with m.span("loop", i=i):
                pass


def test_tracer_scripted_parity():
    for max_events in (200_000, 4):
        tr, jtr = obs.Tracer(max_events=max_events), \
            jobs.Tracer(max_events=max_events)
        _script_trace(obs, tr)
        _script_trace(jobs, jtr)
        assert _spans(tr) == _spans(jtr)
        doc, jdoc = tr.to_chrome_trace(), jtr.to_chrome_trace()
        assert doc["otherData"] == jdoc["otherData"]
        assert doc["displayTimeUnit"] == jdoc["displayTimeUnit"]


# ---------------------------------------------------------------------------
# the hooks, against the JAX package on identical words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["basic", "writeback"])
def test_controller_read_hooks_match_reference(policy):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(300).astype(np.float32)
    jarr = JArray("wl32_r08", controller=policy)
    arr = ProtectedMemoryArray("wl32_r08", controller=policy, device="cpu")
    st = jarr.write("w", x)
    arr.write("w", x)
    enc = _corrupt(rng, st.enc, 0.005, 3).astype(np.int8)
    for a in (jarr, arr):               # a copy each: writeback writes it
        a.import_stored("w", JStored(enc.copy(), st.dtype, st.shape,
                                     st.nbytes))
    reg, _tr, est, jreg, _jtr, jest = _pillars()
    for _ in range(2):                  # writeback repairs on the first
        with obs.use_metrics(reg), obs.use_estimator(est):
            got = arr.read("w")
        with jobs.use_metrics(jreg), jobs.use_estimator(jest):
            want = jarr.read("w")
        np.testing.assert_array_equal(got, want)
    assert arr.stats.detected == jarr.stats.detected > 0
    _assert_same_metrics(reg, jreg)
    assert est.snapshot() == jest.snapshot()
    assert est.region("").decode_words > 0


@pytest.mark.parametrize("coalesce", [True, False])
def test_controller_scrub_hooks_match_reference(coalesce):
    """Six pages of 16 words; chunks of 8 rows, so the per-page baseline
    feeds the estimator chunk by chunk and the coalesced sweep drains
    more than once."""
    rng = np.random.default_rng(6)
    jcode, code = jget_code("wl32_r08"), get_code("wl32_r08")
    u = rng.integers(0, 3, (96, jcode.k))
    enc = _corrupt(rng, np_encode_words(u, jcode), 0.03, 3)
    pages = [enc[i:i + 16] for i in range(0, 96, 16)]
    reg, _tr, est, jreg, _jtr, jest = _pillars()
    ctl = MemoryController(chunk_size=8, device="cpu")
    jctl = JController(chunk_size=8)
    tpages = [torch.as_tensor(pg, dtype=torch.int8) for pg in pages]
    jpages = [pg.astype(np.int8) for pg in pages]
    with obs.use_metrics(reg), obs.use_estimator(est):
        rep = ctl.scrub_pages(code, iter(tpages), coalesce=coalesce,
                              page_words=16, drain_words=8,
                              scan_ahead=1)
    with jobs.use_metrics(jreg), jobs.use_estimator(jest):
        jrep = jctl.scrub_pages(jcode, iter(jpages), coalesce=coalesce,
                                page_words=16, drain_words=8,
                                scan_ahead=1)
    for k in ("words_scanned", "flagged", "corrected", "uncorrectable",
              "pages"):
        assert rep[k] == jrep[k]
    assert rep["flagged"] > 8
    if coalesce:
        assert rep["drains"] == jrep["drains"] > 1
    for tp, jp in zip(tpages, jpages, strict=True):
        np.testing.assert_array_equal(tp.numpy(), jp)
    _assert_same_metrics(reg, jreg)
    assert est.snapshot() == jest.snapshot()


def test_paged_read_hooks_match_reference():
    """`read_page_corrected` by tenant: a store owned by "t0" and one
    with no owner, the same corrupted pages in both packages."""
    rng = np.random.default_rng(7)
    reg, _tr, est, jreg, _jtr, jest = _pillars()
    stats = []
    for owner in ("t0", None):
        jst = JStore("wl32_r08", page_words=8, n_iters=8)
        st = PagedProtectedStore("wl32_r08", page_words=8, n_iters=8,
                                 device="cpu")
        if owner is not None:
            jst.owner = st.owner = owner
        u = rng.integers(0, 3, (30, jst.code.k))
        jst.append_words(jnp.asarray(u, jnp.int32))
        st.append_words(torch.as_tensor(u))
        for i in range(jst.n_pages):
            pg = _corrupt(rng, jst.page(i), 0.03, 3)
            jst._pages[i] = jnp.asarray(pg, jnp.int32)
            st._pages[i] = torch.as_tensor(pg, dtype=torch.int8)
        for i in range(jst.n_pages):
            with obs.use_metrics(reg), obs.use_estimator(est):
                got = st.read_page_corrected(i)
            with jobs.use_metrics(jreg), jobs.use_estimator(jest):
                want = jst.read_page_corrected(i)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert st.stats.as_dict() == jst.stats.as_dict()
        stats.append(st.stats)
    assert all(s.detected > 0 for s in stats)
    _assert_same_metrics(reg, jreg)
    assert est.snapshot() == jest.snapshot()
    assert set(est.snapshot()) == {"", "t0"}


@pytest.mark.parametrize("coalesce", [True, False])
def test_pool_scrub_hooks_match_reference(coalesce):
    """Pool sweeps over two tenants' pages (round robin with a budget,
    then prioritized): per-owner counters, the pool totals and each
    owner's region estimate equal the JAX pool's."""
    from repro.memory import PooledStore as JPooled
    from repro_torch.memory import PooledStore
    rng = np.random.default_rng(8)
    jp = JPool("wl32_r08", page_words=4, capacity_pages=12, n_iters=8)
    tp = ProtectedPagePool("wl32_r08", page_words=4, capacity_pages=12,
                           n_iters=8, device="cpu")
    for owner, m in (("a", 22), ("b", 10)):
        jst, tst = JPooled(jp, owner=owner), PooledStore(tp, owner=owner)
        u = rng.integers(0, 3, (m, jp.code.k))
        jst.append_words(jnp.asarray(u, jnp.int32))
        tst.append_words(torch.as_tensor(u))
        for i in range(jst.n_pages):
            pg = _corrupt(rng, jst.page(i), 0.03, 3)
            jst._pages[i] = jnp.asarray(pg, jnp.int32)
            tst._pages[i] = pg
    reg, _tr, est, jreg, _jtr, jest = _pillars()
    for kw in (dict(max_pages=3), dict(max_pages=3),
               dict(max_pages=4, prioritize=True), {}):
        with obs.use_metrics(reg), obs.use_estimator(est):
            rep = tp.scrub(coalesce=coalesce, **kw)
        with jobs.use_metrics(jreg), jobs.use_estimator(jest):
            jrep = jp.scrub(coalesce=coalesce, **kw)
        assert rep == jrep
    assert tp.scrub_by_owner == jp.scrub_by_owner
    assert sum(v["flagged_words"] for v in tp.scrub_by_owner.values()) > 0
    tp.stats.publish(reg, layer="pool")
    jp.stats.publish(jreg, layer="pool")
    _assert_same_metrics(reg, jreg)
    assert est.snapshot() == jest.snapshot()
    assert set(est.snapshot()) == {"a", "b"}


def test_kv_layer_freeze_and_inject_telemetry():
    """Freezes: the same `kv.freeze` spans and `kv_pages_frozen` counts as
    the JAX layer. Injection: a `kv.inject` instant and a
    `kv_cells_injected` counter holding each package's own returned count
    (the packages draw from different generators)."""
    B, hkv, dh, T = 1, 2, 8, 4
    rng = np.random.default_rng(9)
    jl = JLayer(JPKV(code_name="wl32_r08", page_tokens=T), B, hkv, dh,
                owner="t")
    tl = ProtectedKVLayer(ProtectedKVConfig(code_name="wl32_r08",
                                            page_tokens=T), B, hkv, dh,
                          owner="t", device="cpu")
    reg, tr, _est, jreg, jtr, _jest = _pillars()
    ch = uniform_flip(3, 0.02)
    from repro.memory.channel import uniform_flip as juniform_flip
    for t in (3, 6, 4):
        k = torch.from_numpy(rng.standard_normal(
            (B, t, hkv, dh)).astype(np.float32)).to(torch.bfloat16)
        with obs.use_metrics(reg), obs.use_tracer(tr):
            tl.append(k, k)
        with jobs.use_metrics(jreg), jobs.use_tracer(jtr):
            jl.append(jnp.asarray(k.float().numpy(), jnp.bfloat16),
                      jnp.asarray(k.float().numpy(), jnp.bfloat16))
    assert _spans(tr) == _spans(jtr)
    assert [s[0] for s in _spans(tr)] == ["kv.freeze"] * 3
    with obs.use_metrics(reg), obs.use_tracer(tr):
        cells = tl.inject(ch, key=1)
    with jobs.use_metrics(jreg), jobs.use_tracer(jtr):
        jcells = jl.inject(juniform_flip(3, 0.02), key=1)
    assert cells > 0 and jcells > 0
    for r, t, c in ((reg, tr, cells), (jreg, jtr, jcells)):
        snap = r.snapshot()
        assert type(r).value(snap, "kv_pages_frozen", layer="kv",
                             tenant="t") == 3.0
        assert type(r).value(snap, "kv_cells_injected", layer="kv",
                             tenant="t") == c
        mark = t.events()[-1]
        assert (mark["name"], mark["ph"]) == ("kv.inject", "i")
        assert mark["args"] == {"owner": "t", "cells": c}


# ---------------------------------------------------------------------------
# the serving engine with all three pillars installed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plain():
    jcfg = jget_config("paper_pim").reduced(**TINY)
    cfg = get_config("paper_pim").reduced(**TINY)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(4)]
    return jcfg, jparams, cfg, params, prompts


ENGINE_KW = dict(max_active=4, max_seq=48, scrub_every=2,
                 scrub_max_pages=6)


def _engines(plain):
    jcfg, jparams, cfg, params, _ = plain
    code = get_code(ENGINE_CODE)
    wpu = words_for_tensor((1, PAGE_TOKENS, cfg.n_kv_heads, cfg.head_dim),
                           code.p, code.k)
    jeng = JEngine(jparams, jcfg,
                   pkv=JPKV(code_name=ENGINE_CODE, page_tokens=PAGE_TOKENS,
                            n_iters=8),
                   pool=JPool(ENGINE_CODE, page_words=wpu,
                              capacity_pages=128, n_iters=8), **ENGINE_KW)
    eng = ServingEngine(
        params, cfg,
        pkv=ProtectedKVConfig(code_name=ENGINE_CODE, page_tokens=PAGE_TOKENS,
                              n_iters=8),
        pool=ProtectedPagePool(ENGINE_CODE, page_words=wpu,
                               capacity_pages=128, n_iters=8, device="cpu"),
        **ENGINE_KW)
    return jeng, eng


def _poke(pool, put, seed=11, rate=1e-3):
    """The same numpy corruption into every allocated page of a pool."""
    rng = np.random.default_rng(seed)
    p = pool.code.p
    for pid in range(pool.capacity_pages):
        if pool._storage[pid] is not None:
            pool._storage[pid] = put(_corrupt(rng, pool._storage[pid], rate,
                                              p))


def _serve(eng, prompts, put, inject_after=3, gen=8):
    swept = []
    note = eng.pool._note_page_scan

    def record(pid, nf, est):
        swept.append((pid, nf))
        return note(pid, nf, est)

    eng.pool._note_page_scan = record
    for t, p in enumerate(prompts):
        eng.submit(t, p, max_new=gen)
    reports = []
    while eng.waiting or any(s is not None for s in eng.slots):
        reports.append(eng.step())
        if len(reports) == inject_after:
            _poke(eng.pool, put)
            eng._invalidate_all()
    tokens = {s.tenant: list(s.generated) for s in eng.sequences}
    return reports, tokens, swept


def test_engine_with_all_pillars_matches_reference(plain):
    """Corruption written after step 3, then served to the end under the
    three pillars in each package: the same step reports and tokens, the
    same scrub steps and pages swept in order (prioritized), the same
    estimator regions, counters, gauges and span structure."""
    jeng, eng = _engines(plain)
    prompts = plain[4]
    reg, tr, est, jreg, jtr, jest = _pillars()
    with obs.use_metrics(reg), obs.use_tracer(tr), obs.use_estimator(est):
        rep, tok, swept = _serve(
            eng, prompts, lambda a: torch.as_tensor(a, dtype=torch.int8))
        eng.publish_metrics()
    with jobs.use_metrics(jreg), jobs.use_tracer(jtr), \
            jobs.use_estimator(jest):
        jrep, jtok, jswept = _serve(
            jeng, prompts, lambda a: jnp.asarray(a, jnp.int32))
        jeng.publish_metrics()
    assert rep == jrep and tok == jtok
    assert swept == jswept
    scrub_steps = [r["step"] for r in rep if "scrubbed_pages" in r]
    assert scrub_steps and any(nf for _pid, nf in swept)
    assert est.snapshot() == jest.snapshot()
    assert set(est.snapshot()) == {"0", "1", "2", "3"}
    assert est.hot_regions() == jest.hot_regions()
    assert est.adaptive_interval(2) == jest.adaptive_interval(2) == 2
    _assert_same_metrics(reg, jreg)
    assert _spans(tr) == _spans(jtr)
    # the counters agree with the engine's own reports
    snap = reg.snapshot()
    value = obs.MetricsRegistry.value
    assert value(snap, "engine_steps", layer="engine") == len(rep)
    assert value(snap, "engine_tokens", layer="engine") == \
        sum(r["tokens"] for r in rep)
    assert value(snap, "pool_scrub_pages", layer="pool") == \
        sum(r["pages"] for r in eng.scrub_reports)
    for t in range(4):
        for k, v in eng.tenant_stats(t).items():
            assert value(snap, f"tenant_{k}", layer="engine",
                         tenant=str(t)) == v
    assert sum(eng.tenant_stats(t)["corrected"] for t in range(4)) > 0
    steps = tr.spans("engine.step")
    assert len(steps) == len(rep)
    assert all(e["args"]["depth"] == 1 for e in tr.spans("engine.decode"))
    assert len(tr.spans("engine.scrub")) == len(scrub_steps)


def test_engine_telemetry_off_constructs_nothing(plain):
    """Nothing installed: an engine run with injection and scrubs builds
    no instrument and records no event, and `publish_metrics` into the
    null registry is a no-op."""
    _jeng, eng = _engines(plain)
    before = obs.instrument_count()
    _serve(eng, plain[4], lambda a: torch.as_tensor(a, dtype=torch.int8))
    eng.publish_metrics()
    assert obs.instrument_count() == before
    assert obs_trace.current().events() == []
    assert eng.scrub_reports
