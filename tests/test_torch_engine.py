"""Port parity: the multi-tenant serving engine (`repro_torch.serving`)
against the JAX package's `repro.serving`, on the CPU.

The JAX engine tests' tiny model and traffic (`tests/test_serving_engine.py`:
reduced paper-pim-2b, `n_groups=2, d_model=32, n_heads=2, d_ff=64,
vocab=128`, the JAX `init_params` times 3, four 12-token prompts,
wl160_r08 pages of 8 tokens), the weights carried across with
`convert.params_from_arrays`. Tolerances:

- schedules (each step's admitted, active, preempted, retired and tokens),
  generated tokens, `BatchedPagedKV` pages, block tables, scales and
  valid counts from numpy-drawn K/V: exactly equal;
- the fused `attend`: one bf16 ulp (rtol 2^-7, atol 2^-10);
- logits: `LOGITS_ATOL` of `tests/test_torch_serving.py` (2^-6). Each
  sampled row's top-2 margin on the JAX side is first asserted to exceed
  2 LOGITS_ATOL, so a near-tie fails loudly instead of flipping a token.

The JAX engine tests multiply the weights by 3 so that the greedy tokens
vary. At that scale the reference's own top-2 margins on this traffic
fall to one bf16 ulp, exact ties included, and the logits reach 3, where
the two packages' bf16 roundings differ by 2^-5: greedy tokens cannot be
held across frameworks there. The cross-framework cases therefore run the
JAX `init_params` as it is (margins above 0.35, logits within 0.004 on
this data); the port's mirrors of the JAX cases keep the weights times 3.

The JAX engine's eight cases are mirrored on the port; injection draws
from torch generators there, so injected runs are checked by behaviour
from _torch_threads import torch_threads_per_worker  # noqa: F401
(tokens as the clean run's, corrections attributed, nothing left).
By design the port passes the kernel's page count as it is, where the
JAX engine pads it to a power of two (`np_bucket`) with exact no-op pages
(`test_batched_paged_kv_matches_reference`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.ops import np_bucket
from repro.memory import ProtectedPagePool as JPool
from repro.models import ProtectedKVConfig as JPKV
from repro.models import init_params as jinit_params
from repro.models import lm as jlm
from repro.serving import BatchedPagedKV as JBatched
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_arrays
from repro_torch.core import get_code
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.paged_attention import attend_protected_plain
from repro_torch.memory import (Compose, LevelTransition, PoolExhausted,
                                ProtectedPagePool, ReadDisturb,
                                asymmetric_adjacent, words_for_tensor)
from repro_torch.models import ProtectedKVConfig
from repro_torch.models import lm
from repro_torch.serving import BatchedPagedKV, ServingEngine

CODE = "wl160_r08"
PAGE_TOKENS = 8
ULP = dict(rtol=2 ** -7, atol=2 ** -10)
LOGITS_ATOL = 2 * 2 ** -7
TINY = dict(n_groups=2, d_model=32, n_heads=2, d_ff=64, vocab=128)
REPORT_KEYS = ("step", "admitted", "active", "tokens", "retired",
               "preempted")


def _models(scale):
    jcfg = jget_config("paper_pim").reduced(**TINY)
    cfg = get_config("paper_pim").reduced(**TINY)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.tree.map(lambda t: t * scale,
                           jinit_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_arrays(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(4)]
    return jcfg, jparams, cfg, params, prompts


@pytest.fixture(scope="module")
def tiny():
    """The JAX engine tests' model: weights times 3."""
    return _models(3.0)


@pytest.fixture(scope="module")
def plain():
    """The same model with the JAX `init_params` as it is."""
    return _models(1.0)


def _wpu(cfg):
    code = get_code(CODE)
    return words_for_tensor((1, PAGE_TOKENS, cfg.n_kv_heads, cfg.head_dim),
                            code.p, code.k)


def _pool(cfg, capacity):
    return ProtectedPagePool(CODE, page_words=_wpu(cfg),
                             capacity_pages=capacity, n_iters=8,
                             device="cpu")


def _engine(cfg, params, pool, **kw):
    pkv = ProtectedKVConfig(code_name=CODE, page_tokens=PAGE_TOKENS,
                            n_iters=8)
    kw.setdefault("max_active", 4)
    kw.setdefault("max_seq", 48)
    return ServingEngine(params, cfg, pkv=pkv, pool=pool, **kw)


def _jengine(jcfg, jparams, capacity, **kw):
    pool = JPool(CODE, page_words=_wpu(jcfg), capacity_pages=capacity,
                 n_iters=8)
    pkv = JPKV(code_name=CODE, page_tokens=PAGE_TOKENS, n_iters=8)
    kw.setdefault("max_active", 4)
    kw.setdefault("max_seq", 48)
    return JEngine(jparams, jcfg, pkv=pkv, pool=pool, **kw)


def _serve(eng, prompts, gen=8):
    for t, p in enumerate(prompts):
        eng.submit(t, p, max_new=gen)
    return eng.run()


def _mixed_channel(p, eps):
    # level drift and read disturb, composed: the JAX tests' stress mix
    drift = asymmetric_adjacent(p, eps, eps / 2)
    return Compose(LevelTransition(drift.T), ReadDisturb(p, eps / 2))


def _record(module, monkeypatch, calls):
    """Wrap `module.decode_step` and `module.prefill` to record each
    call's last-position logits (float32 numpy) and the rows it samples
    from (the active slots of a decode step, the group's rows of a
    prefill, whose size the engine does not pass: all rows are kept)."""
    decode, prefill = module.decode_step, module.prefill

    def decode_step(params, cfg, caches, token, pos, **kw):
        active = next(iter(caches.layers.values())).active.copy()
        out = decode(params, cfg, caches, token, pos, **kw)
        calls.append(("decode", np.asarray(
            jnp.asarray(out[0][:, -1], jnp.float32)
            if not isinstance(out[0], torch.Tensor)
            else out[0][:, -1].float().numpy()), active))
        return out

    def prefill_(params, cfg, tokens, **kw):
        out = prefill(params, cfg, tokens, **kw)
        calls.append(("prefill", np.asarray(
            jnp.asarray(out[0][:, -1], jnp.float32)
            if not isinstance(out[0], torch.Tensor)
            else out[0][:, -1].float().numpy()), None))
        return out

    monkeypatch.setattr(module, "decode_step", decode_step)
    monkeypatch.setattr(module, "prefill", prefill_)


def _run_recorded(eng, prompts, module, gen=8):
    calls, reports = [], []
    with pytest.MonkeyPatch.context() as mp:
        _record(module, mp, calls)
        for t, p in enumerate(prompts):
            eng.submit(t, p, max_new=gen)
        while eng.waiting or any(s is not None for s in eng.slots):
            reports.append({k: v for k, v in eng.step().items()
                            if k in REPORT_KEYS})
    tokens = {s.tenant: list(s.generated) for s in eng.sequences}
    return tokens, reports, calls


@pytest.fixture(scope="module")
def reference(plain):
    """The JAX engine's runs: the four prompts with a roomy pool, and with
    a pool of 24 pages (preemption)."""
    jcfg, jparams, _cfg, _params, prompts = plain
    roomy = _run_recorded(_jengine(jcfg, jparams, 256), prompts, jlm)
    small = _jengine(jcfg, jparams, 24)
    tight = _run_recorded(small, prompts, jlm)
    return roomy, tight, small.stats()


# -- cross-framework ----------------------------------------------------------


def test_schedule_tokens_and_logits_match_reference(plain, reference):
    """The same admissions, steps and retirements, the same tokens, and
    every call's logits within LOGITS_ATOL; every sampled row's JAX top-2
    margin is above 2 LOGITS_ATOL first."""
    _jcfg, _jparams, cfg, params, prompts = plain
    (jtok, jrep, jcalls), _, _ = reference
    pool = _pool(cfg, 256)
    n0 = LAUNCHES["attend_protected"]
    tok, rep, calls = _run_recorded(_engine(cfg, params, pool), prompts, lm)
    assert LAUNCHES["attend_protected"] == n0       # CPU tensors
    assert rep == jrep
    assert [c[0] for c in calls] == [c[0] for c in jcalls]
    for (kind, got, active), (_, want, _) in zip(calls, jcalls,
                                                 strict=True):
        rows = np.flatnonzero(active) if kind == "decode" else \
            np.arange(want.shape[0])
        top2 = np.sort(want[rows], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 2 * LOGITS_ATOL).all(), \
            "a near-tie in the reference's logits"
        np.testing.assert_allclose(got[rows], want[rows], atol=LOGITS_ATOL,
                                   rtol=0)
    assert tok == jtok
    assert pool.n_allocated == 0


def test_preemption_schedule_matches_reference(plain, reference):
    """A pool of 24 pages: the port preempts at the same steps as the JAX
    engine, readmits and replays, and gives the same tokens."""
    _jcfg, _jparams, cfg, params, prompts = plain
    _, (jtok, jrep, _), jstats = reference
    eng = _engine(cfg, params, _pool(cfg, 24))
    tok, rep, _calls = _run_recorded(eng, prompts, lm)
    assert jstats["preemptions"] > 0
    assert rep == jrep and tok == jtok
    assert eng.stats() == jstats


def _bf16_np(rng, shape, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("fused", [True, False])
def test_batched_paged_kv_matches_reference(fused, rng):
    """One layer's per-slot K/V from numpy: ingested prompts of different
    lengths, decode appends with slots idle, a retired slot. Pool pages,
    block tables, hot rows and the fused operands equal, and `attend`
    within one bf16 ulp. The port's operands hold NP page steps (the most
    any slot holds); the JAX engine's are padded to np_bucket(NP) with
    zero pages, scale 0 and valid 0. With `fused` off both read through
    the streaming `pages()`: every page step equal, and the port's
    streaming `attend` within one bf16 ulp of the JAX one and of its own
    fused read's plain version."""
    B, hkv, dh = 3, 2, 8
    code = get_code(CODE)
    wpu = words_for_tensor((1, PAGE_TOKENS, hkv, dh), code.p, code.k)
    jpool = JPool(CODE, page_words=wpu, capacity_pages=64, n_iters=8)
    tpool = ProtectedPagePool(CODE, page_words=wpu, capacity_pages=64,
                              n_iters=8, device="cpu")
    pkv = dict(code_name=CODE, page_tokens=PAGE_TOKENS, n_iters=8,
               fused=fused)
    jl = JBatched(JPKV(**pkv), jpool, B, hkv, dh)
    tl = BatchedPagedKV(ProtectedKVConfig(**pkv), tpool, B, hkv, dh)

    def both(name, *args):
        getattr(jl, name)(*(jnp.asarray(a, jnp.bfloat16)
                            if isinstance(a, np.ndarray) else a
                            for a in args))
        getattr(tl, name)(*(torch.from_numpy(a).to(torch.bfloat16)
                            if isinstance(a, np.ndarray) else a
                            for a in args))

    def check():
        for b in range(B):
            assert tl.slot_pages(b) == jl.slot_pages(b)
        for pid in range(64):
            jpg, tpg = jpool._storage[pid], tpool._storage[pid]
            assert (jpg is None) == (tpg is None)
            if jpg is not None:
                np.testing.assert_array_equal(tpg.numpy(), np.asarray(jpg))
        np.testing.assert_array_equal(tl.hot_len, jl.hot_len)
        np.testing.assert_array_equal(tl.hot_k.float().numpy(),
                                      np.asarray(jl.hot_k, np.float32))
        if fused:
            ops, jops = tl.fused_inputs(), jl._fused_inputs()
            NP = max(len(m) for m in jl.metas)
            assert ops[0].shape[0] == NP
            assert jops[0].shape[0] == np_bucket(NP)
            for t, j in zip(ops, jops, strict=True):
                np.testing.assert_array_equal(t.float().numpy(),
                                              np.asarray(j[:NP], np.float32))
                assert not np.asarray(j[NP:]).any()
        else:
            steps, jsteps = list(tl.pages()), list(jl.pages())
            assert len(steps) == len(jsteps)
            for step, jstep in zip(steps, jsteps, strict=True):
                for t, j in zip(step, jstep, strict=True):
                    np.testing.assert_array_equal(t.float().numpy(),
                                                  np.asarray(j, np.float32))
        q = _bf16_np(rng, (B, 1, 4, dh))
        want = np.asarray(jl.attend(jnp.asarray(q, jnp.bfloat16)),
                          np.float32)
        tq = torch.from_numpy(q).to(torch.bfloat16)
        got = tl.attend(tq).float().numpy()
        active = np.flatnonzero(jl.hot_len + np.array(
            [len(m) for m in jl.metas]) > 0)
        np.testing.assert_allclose(got[active], want[active], **ULP)
        if not fused:
            read = attend_protected_plain(
                tq, *tl.fused_inputs(), tl.hot_k, tl.hot_v, tl._hot_len_dev,
                p=code.p, k_info=code.k, page_shape=tl.page_shape)
            np.testing.assert_allclose(got[active],
                                       read.float().numpy()[active], **ULP)

    for b, S in ((0, 21), (2, 5)):
        both("open_slot", b, f"t{b}")
        both("ingest_slot", b, _bf16_np(rng, (1, S, hkv, dh), 2.0),
             _bf16_np(rng, (1, S, hkv, dh)))
    check()
    for step in range(12):
        active = np.array([True, step < 9, True]) & np.array(
            [True, step >= 3, True])
        if step == 3:
            both("open_slot", 1, "t1")
            both("ingest_slot", 1, _bf16_np(rng, (1, 16, hkv, dh)),
                 _bf16_np(rng, (1, 16, hkv, dh)))
        jl.active, tl.active = active.copy(), active.copy()
        both("append", _bf16_np(rng, (B, 1, hkv, dh), 2.0),
             _bf16_np(rng, (B, 1, hkv, dh)))
        if step == 9:
            assert tl.close_slot(1) == jl.close_slot(1)
        if step in (0, 6, 10):
            check()
    assert tl.freeze_candidates(np.ones(B, bool)) == \
        jl.freeze_candidates(np.ones(B, bool))


# -- the JAX engine's cases, on the port --------------------------------------


def test_engine_smoke_and_pool_drains(tiny):
    _, _, cfg, params, prompts = tiny
    pool = _pool(cfg, 256)
    eng = _engine(cfg, params, pool)
    out = _serve(eng, prompts)
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(v) == 8 for v in out.values())
    st = eng.stats()
    assert st["done"] == 4 and st["active"] == 0 and st["waiting"] == 0
    # every retired slot returned its blocks to the shared free list
    assert pool.n_allocated == 0 and pool.available == 256
    assert pool.peak_allocated > 0


def test_single_vs_multi_tenant_bit_exact(tiny):
    _, _, cfg, params, prompts = tiny
    multi = _serve(_engine(cfg, params, _pool(cfg, 256)), prompts)
    for t, p in enumerate(prompts):
        solo = _serve(_engine(cfg, params, _pool(cfg, 256)), [p])
        assert solo[0] == multi[t], f"tenant {t} diverged under batching"


def test_injection_mid_serving_corrected_and_attributed(tiny):
    """The shared pool corrupted mid-serving across 4 tenants through a
    composed LevelTransition + ReadDisturb channel: every tenant's tokens
    are its clean run's, and the corrections land on the tenants."""
    _, _, cfg, params, prompts = tiny
    clean = _serve(_engine(cfg, params, _pool(cfg, 256)), prompts)
    eng = _engine(cfg, params, _pool(cfg, 256))
    for t, p in enumerate(prompts):
        eng.submit(t, p, max_new=8)
    ch = _mixed_channel(3, 2e-4)
    steps = changed = 0
    while eng.waiting or any(s is not None for s in eng.slots):
        eng.step()
        if steps == 2:
            changed = eng.inject(ch, key=11, n_reads=2)
        steps += 1
    assert changed > 0
    assert {s.tenant: list(s.generated) for s in eng.sequences} == clean
    per_tenant = {t: eng.tenant_stats(t) for t in range(4)}
    assert sum(s["detected"] for s in per_tenant.values()) > 0
    assert all(s["uncorrectable"] == 0 for s in per_tenant.values())
    assert all(s["corrected"] == s["detected"]
               for s in per_tenant.values())


def test_injection_scoped_to_tenants(tiny):
    """`inject(..., tenants=[...])` corrupts only the named tenants'
    pages; the others read clean storage and bank no corrections."""
    _, _, cfg, params, prompts = tiny
    eng = _engine(cfg, params, _pool(cfg, 256))
    for t, p in enumerate(prompts):
        eng.submit(t, p, max_new=8)
    ch = _mixed_channel(3, 5e-3)
    steps = 0
    while eng.waiting or any(s is not None for s in eng.slots):
        eng.step()
        if steps == 1:
            assert eng.inject(ch, key=3, n_reads=2, tenants=[0, 1]) > 0
        steps += 1
    hit = [eng.tenant_stats(t)["detected"] for t in range(4)]
    assert hit[0] > 0 and hit[1] > 0
    assert hit[2] == 0 and hit[3] == 0


def test_preemption_and_resume_bit_exact(tiny):
    """A pool too small for 4 resident tenants forces LIFO preemption;
    evicted sequences readmit (re-prefill and teacher-forced replay) and
    still finish bit-exactly."""
    _, _, cfg, params, prompts = tiny
    clean = _serve(_engine(cfg, params, _pool(cfg, 256)), prompts)
    small = _pool(cfg, 24)
    eng = _engine(cfg, params, small)
    out = _serve(eng, prompts)
    assert eng.stats()["preemptions"] > 0
    assert out == clean
    assert small.n_allocated == 0      # eviction and retirement freed all


def test_pool_exhaustion_is_clean_error(tiny):
    _, _, cfg, params, prompts = tiny
    eng = _engine(cfg, params, _pool(cfg, 4))   # not even one sequence
    eng.submit(0, prompts[0], max_new=8)
    with pytest.raises(PoolExhausted):
        eng.run()


def test_submit_validates_against_max_seq(tiny):
    _, _, cfg, params, prompts = tiny
    eng = _engine(cfg, params, _pool(cfg, 64), max_seq=16)
    with pytest.raises(ValueError):
        eng.submit(0, prompts[0], max_new=8)   # 12 + 8 > 16


def test_background_scrub_preserves_outputs_and_repairs(tiny):
    """Interleaved scrub sweeps change no tenant's tokens and repair the
    injected corruption in place."""
    _, _, cfg, params, prompts = tiny
    pool = _pool(cfg, 256)

    def noisy_run(scrub_every):
        eng = _engine(cfg, params, pool, scrub_every=scrub_every,
                      scrub_max_pages=8)
        for t, p in enumerate(prompts):
            eng.submit(t, p, max_new=8)
        ch = _mixed_channel(3, 2e-4)
        steps = 0
        while eng.waiting or any(s is not None for s in eng.slots):
            eng.step()
            if steps == 1:
                eng.inject(ch, key=9, n_reads=2)
            steps += 1
        return {s.tenant: list(s.generated) for s in eng.sequences}, eng

    base, _ = noisy_run(0)
    scrubbed, eng = noisy_run(2)
    assert scrubbed == base
    assert pool.stats.scrub_rounds > 0
    reports = eng.scrub_reports
    assert sum(r["pages"] for r in reports) > 0
    repaired = sum(r["repaired_words"] for r in reports)
    flagged = sum(r["flagged_words"] for r in reports)
    assert repaired == flagged         # weak channel: all repairable


# -- the port's own surface -----------------------------------------------------


def test_dense_baseline_and_unported_metrics(tiny):
    """`protected=False` serves the same prompts through dense per-slot
    rows (tokens logged, not compared: int8 pages differ from bf16 rows);
    `publish_metrics` publishes each tenant's gauges (and no pool
    gauges, there being no pool), and into the null registry does
    nothing; the engine runs where the parameters are and refuses layers
    it cannot batch."""
    from repro_torch import obs
    _, _, cfg, params, prompts = tiny
    eng = ServingEngine(params, cfg, max_active=4, max_seq=48,
                        protected=False)
    out = _serve(eng, prompts)
    assert all(len(v) == 8 for v in out.values())
    assert eng.inject(_mixed_channel(3, 1e-2), key=0) == 0
    assert eng.tenant_stats(0)["detected"] == 0
    before = obs.instrument_count()
    eng.publish_metrics()
    assert obs.instrument_count() == before
    reg = obs.MetricsRegistry()
    eng.publish_metrics(reg)
    snap = reg.snapshot()
    assert {s["labels"]["tenant"] for s in snap["tenant_detected"]["series"]
            } == {"0", "1", "2", "3"}
    assert obs.MetricsRegistry.value(snap, "tenant_corrected",
                                     layer="engine", tenant="0") == 0.0
    assert "pool_allocated" not in snap
    windowed = dataclasses.replace(cfg, group_spec=tuple(
        dataclasses.replace(s, local_window=4) for s in cfg.group_spec))
    with pytest.raises(ValueError, match="global self-attention"):
        ServingEngine(params, windowed, protected=False)
