"""Port parity: protected KV-cache serving through the model stack.

The reduced `paper-pim-2b` (`reduced(n_groups=2, d_model=64, n_heads=4,
d_ff=128)`, vocab 512) on the CPU. Weights come from the JAX package's
`init_params` and are carried across with `convert.params_from_arrays`;
prompts, decode tokens and K/V are drawn with numpy and fed to both
packages. Tolerances:

- stored pages, scales and cache `stats()`: exact;
- one layer's fused `attend` output: one bf16 ulp (rtol 2**-7, atol
  2**-10), as in test_torch_paged_attention.py;
- model logits: atol 2**-6, two bf16 ulps at |logit| = 1 (the logits
  here reach about 1.3, and are bf16 values cast to float32). Both
  packages compute in bf16 (weights cast at use, fp32 norms and softmax),
  but XLA's CPU build and PyTorch round the bf16 matmuls and the SiLU at
  slightly different places; the largest gap measured is one ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ProtectedKVConfig as JPKV
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models.kv import ProtectedKVLayer as JLayer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_arrays
from repro_torch.kernels import LAUNCHES
from repro_torch.models import (ProtectedKVCaches, ProtectedKVConfig,
                                ProtectedKVLayer, decode_step, init_caches,
                                init_params, prefill, protected_overhead)
from _torch_threads import torch_threads_per_worker  # noqa: F401

ULP = dict(rtol=2 ** -7, atol=2 ** -10)
LOGITS_ATOL = 2 * 2 ** -7
REDUCED = dict(n_groups=2, d_model=64, n_heads=4, d_ff=128)


def _bf16_np(rng, shape, scale=1.0):
    """numpy values already on the bf16 grid, so both packages start from
    identical K/V."""
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("paper_pim").reduced(**REDUCED)
    cfg = get_config("paper_pim").reduced(**REDUCED)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_arrays(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------


def _layers(code_name, *, batch=2, hkv=2, dh=8, T=4, fused=True):
    jl = JLayer(JPKV(code_name=code_name, page_tokens=T, fused=fused),
                batch, hkv, dh)
    tl = ProtectedKVLayer(ProtectedKVConfig(code_name=code_name,
                                            page_tokens=T, fused=fused),
                          batch, hkv, dh, device="cpu")
    return jl, tl


def _feed(jl, tl, k, v):
    jl.append(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    tl.append(torch.from_numpy(k).to(torch.bfloat16),
              torch.from_numpy(v).to(torch.bfloat16))


def _assert_same_storage(jl, tl):
    assert (tl.n_frozen, tl.hot_len) == (jl.n_frozen, jl.hot_len)
    for js, ts in ((jl.k_store, tl.k_store), (jl.v_store, tl.v_store)):
        assert ts.n_pages == js.n_pages
        for i in range(js.n_pages):
            np.testing.assert_array_equal(_np(ts.page(i)),
                                          np.asarray(js.page(i)))
    for (tk, tv), (jk, jv) in zip(tl._metas, jl._metas, strict=True):
        assert float(tk.scale) == float(jk.scale)
        assert float(tv.scale) == float(jv.scale)
    np.testing.assert_array_equal(_np(tl.hot_k), _np(jl.hot_k))


@pytest.mark.parametrize("code_name,fused", [("wl40_r08", True),
                                             ("wl40_r08", False),
                                             ("wl160_r08", True)])
def test_layer_stores_same_pages_and_attends_alike(code_name, fused, rng):
    jl, tl = _layers(code_name, fused=fused)
    for t in (3, 6, 1, 4):           # appends that cross page boundaries
        shape = (2, t, 2, 8)
        _feed(jl, tl, _bf16_np(rng, shape, 2.0), _bf16_np(rng, shape))
        _assert_same_storage(jl, tl)
        q = _bf16_np(rng, (2, 1, 4, 8))
        want = _np(jl.attend(jnp.asarray(q, jnp.bfloat16), 30.0))
        n0 = LAUNCHES["attend_protected"]
        got = tl.attend(torch.from_numpy(q).to(torch.bfloat16), 30.0)
        assert LAUNCHES["attend_protected"] == n0
        np.testing.assert_allclose(_np(got), want, **ULP)
    assert tl.stats() == jl.stats()


READS = {"fused": {}, "streaming": dict(fused=False),
         "streaming_sync": dict(fused=False, overlap=False),
         "raw": dict(corrected=False),
         "raw_streaming": dict(corrected=False, fused=False)}


@pytest.mark.parametrize("read", sorted(READS))
def test_layer_reads_corrupted_pages_alike(read, rng):
    """The same numpy-corrupted cells written into both layers' stores:
    each read path (the fused kernel, the streaming refill pipelined or
    blocking on every page, the raw uncorrected read through the kernel's
    operands or streamed) attends alike and the stores account the same
    corrections."""
    jl, tl = _layers("wl40_r08")
    shape = (2, 14, 2, 8)
    _feed(jl, tl, _bf16_np(rng, shape, 2.0), _bf16_np(rng, shape))
    for js, ts in ((jl.k_store, tl.k_store), (jl.v_store, tl.v_store)):
        for i in range(js.n_pages):
            page = np.asarray(js.page(i)).astype(np.int64)
            hit = rng.random(page.shape) < 0.02
            page[hit] = (page[hit] + rng.integers(1, 3, hit.sum())) % 3
            js._set_page(i, jnp.asarray(page, jnp.int32))
            ts._set_page(i, torch.as_tensor(page, dtype=torch.int8))
    for layer, cfg in ((jl, JPKV), (tl, ProtectedKVConfig)):
        layer.pkv = cfg(code_name="wl40_r08", page_tokens=4, **READS[read])
        layer.invalidate()
    q = _bf16_np(rng, (2, 1, 4, 8))
    want = _np(jl.attend(jnp.asarray(q, jnp.bfloat16)))
    got = _np(tl.attend(torch.from_numpy(q).to(torch.bfloat16)))
    np.testing.assert_allclose(got, want, **ULP)
    assert tl.stats() == jl.stats()
    # only the scan-gated reads count detections: the sync refill decodes
    # every page without a scan, the raw read decodes nothing
    assert (tl.stats()["detected"] > 0) == (read in ("fused", "streaming"))
    assert tl.stats()["flagged_words"] > 0


def test_layer_inject_and_free():
    _, tl = _layers("wl40_r08")
    x = torch.randn((2, 9, 2, 8), generator=torch.Generator().manual_seed(0))
    tl.append(x.to(torch.bfloat16), x.to(torch.bfloat16))
    q = torch.zeros((2, 1, 4, 8), dtype=torch.bfloat16)
    tl.attend(q)
    assert tl._gf_pages is not None
    from repro_torch.memory import uniform_flip
    assert tl.inject(uniform_flip(3, 0.01), key=1) > 0
    assert tl._gf_pages is None
    tl.free()
    assert (tl.n_tokens, tl.k_store.n_pages) == (0, 0)
    with pytest.raises(ValueError, match="at least one KV page"):
        tl.attend(q)
    # pool-backed stores (ProtectedKVConfig(pool=...)) return every block
    from repro_torch.memory import ProtectedPagePool, words_for_tensor
    pool = ProtectedPagePool("wl40_r08", capacity_pages=8,
                             page_words=words_for_tensor((2, 4, 2, 8), 3, 32),
                             device="cpu")
    pl = ProtectedKVLayer(ProtectedKVConfig(code_name="wl40_r08",
                                            page_tokens=4, pool=pool),
                          2, 2, 8, device="cpu")
    pl.append(x.to(torch.bfloat16), x.to(torch.bfloat16))
    assert pool.n_allocated == 4 and pl.inject(uniform_flip(3, 0.01),
                                               key=1) > 0
    pl.free()
    assert pool.n_allocated == 0


# ---------------------------------------------------------------------------
# the model: prefill, then decode steps
# ---------------------------------------------------------------------------


def _tokens(rng, cfg, B, S, steps):
    return (rng.integers(0, cfg.vocab_size, (B, S)),
            rng.integers(0, cfg.vocab_size, (steps, B, 1)))


def test_params_from_arrays_carries_every_weight(model):
    jcfg, jparams, cfg, params = model
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_jax
    np.testing.assert_array_equal(
        params.block(1, 0).mlp.w_down.detach().numpy(),
        np.asarray(jparams["groups"]["pos0"]["mlp"]["w_down"][1]))


def test_protected_prefill_and_decode_match_jax(model, rng):
    """prefill(protected_kv=...) then 6 decode steps, crossing a page
    freeze: logits within LOGITS_ATOL at every step and identical cache
    stats. (The stored cells are not compared here: the model's K/V
    differ between the packages by bf16 rounding, so a few quantized
    bytes do; identical K/V store identical pages, see the layer tests.)"""
    jcfg, jparams, cfg, params = model
    B, S, steps, T = 2, 10, 6, 4
    prompt, toks = _tokens(rng, cfg, B, S, steps)
    code_name = "wl160_r08"                      # the serving code
    jl, jc = jprefill(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                      protected_kv=JPKV(code_name=code_name, page_tokens=T))
    tl, tc = prefill(params, cfg, torch.as_tensor(prompt),
                     protected_kv=ProtectedKVConfig(code_name=code_name,
                                                    page_tokens=T))
    assert isinstance(tc, ProtectedKVCaches)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)
    assert tc.stats() == jc.stats()
    n0 = LAUNCHES["attend_protected"]
    for i in range(steps):
        jl, jc = jdecode_step(jparams, jcfg, jc, jnp.asarray(toks[i],
                                                             jnp.int32),
                              jnp.asarray(S + i))
        tl, tc = decode_step(params, cfg, tc, torch.as_tensor(toks[i]),
                             S + i)
        assert tl.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL,
                                   rtol=0)
    assert LAUNCHES["attend_protected"] == n0          # CPU tensors
    assert tc.stats() == jc.stats()
    assert tc.stats()["tokens"] == S + steps


def _dense_decode(params, cfg, prompt, toks, max_seq):
    B, S = prompt.shape
    _, pre = prefill(params, cfg, torch.as_tensor(prompt))
    caches = init_caches(cfg, B, max_seq, device="cpu")
    for pos, e in pre.items():
        for name, val in e.items():
            caches[pos][name][:, :, :S] = val
    out = []
    for i in range(toks.shape[0]):
        lg, caches = decode_step(params, cfg, caches,
                                 torch.as_tensor(toks[i]), S + i)
        out.append(lg)
    return torch.cat(out, dim=1)


def test_dense_decode_matches_jax_and_protected(model, rng):
    """The dense-cache decode against the JAX package's, and the protected
    decode against the dense one on a clean cache: int8-quantized K/V
    agree to quantization noise (the JAX package's bound, 0.05)."""
    jcfg, jparams, cfg, params = model
    B, S, steps = 2, 12, 5
    prompt, toks = _tokens(rng, cfg, B, S, steps)
    dense = _dense_decode(params, cfg, prompt, toks, S + steps)

    _, jc = jprefill(jparams, jcfg, jnp.asarray(prompt, jnp.int32))
    full = jax.tree.map(lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, steps),
                                              (0, 0), (0, 0)]), jc)
    want = []
    step = jax.jit(jdecode_step, static_argnums=1)   # one trace, 5 steps
    for i in range(steps):
        lg, full = step(jparams, jcfg, full, jnp.asarray(toks[i], jnp.int32),
                        jnp.asarray(S + i))
        want.append(_np(lg))
    np.testing.assert_allclose(_np(dense), np.concatenate(want, axis=1),
                               atol=LOGITS_ATOL, rtol=0)

    _, pc = prefill(params, cfg, torch.as_tensor(prompt),
                    protected_kv=ProtectedKVConfig(code_name="wl40_r08",
                                                   page_tokens=4))
    prot = []
    for i in range(steps):
        lg, pc = decode_step(params, cfg, pc, torch.as_tensor(toks[i]),
                             S + i)
        prot.append(lg)
    assert float((torch.cat(prot, dim=1) - dense).abs().max()) < 0.05


def test_sliding_window_layers_keep_dense_rings(rng):
    """A local-window layer (gemma2's local/global pair, reduced) decodes
    through a dense ring inside the protected manager, and the whole
    protected decode stays within quantization noise of the dense one."""
    cfg = get_config("gemma2_27b").reduced(n_groups=1, d_model=32,
                                           n_heads=2, d_ff=64, vocab=64)
    assert [s.local_window > 0 for s in cfg.group_spec] == [True, False]
    cfg = dataclasses.replace(cfg, group_spec=tuple(
        dataclasses.replace(s, local_window=6 if s.local_window else 0)
        for s in cfg.group_spec))
    params = init_params(cfg, 0, device="cpu")
    B, S, steps = 2, 9, 4
    prompt, toks = _tokens(rng, cfg, B, S, steps)
    dense = _dense_decode(params, cfg, prompt, toks, S + steps)
    _, pc = prefill(params, cfg, torch.as_tensor(prompt),
                    protected_kv=ProtectedKVConfig(code_name="wl40_r08",
                                                   page_tokens=4),
                    max_seq=S + steps)
    assert pc.stats()["dense_layers"] == 1
    prot = []
    for i in range(steps):
        lg, pc = decode_step(params, cfg, pc, torch.as_tensor(toks[i]),
                             S + i)
        prot.append(lg)
    assert float((torch.cat(prot, dim=1) - dense).abs().max()) < 0.05


def test_init_params_distributions_and_overhead():
    cfg = get_config("paper_pim").reduced(**REDUCED)
    params = init_params(cfg, torch.Generator().manual_seed(3))
    assert params.device.type == "cpu"
    w = params.block(0, 0).attn.wq.detach()
    assert abs(float(w.std()) - 0.02) < 0.002 and abs(float(w.mean())) < 2e-3
    assert torch.equal(params.final_norm.scale, torch.ones(cfg.d_model))
    ov = protected_overhead(cfg, ProtectedKVConfig())
    assert ov["int8_bytes_per_token"] == 2 * cfg.n_kv_heads * cfg.head_dim
    assert ov["cells_per_token"] == pytest.approx(
        ov["int8_bytes_per_token"] * 6 / 0.8)


def test_unported_model_parts_raise():
    """What is still not ported raises: the PIM backward (Queue 1 item
    10) and the standin attention (by design). MoE and mamba models,
    once raising here, build (tests/test_torch_archs.py)."""
    for name in ("olmoe_1b_7b", "falcon_mamba_7b"):
        assert init_params(get_config(name).reduced(), 0, device="cpu")
    cfg = get_config("paper_pim").reduced(**REDUCED)
    params = init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 3), dtype=torch.int64)
    from repro_torch.core import PIMContext
    from repro_torch.models import loss_fn
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        loss_fn(params, cfg, {"tokens": toks, "labels": toks},
                pim_ctx=PIMContext(cfg.pim))
    standin = dataclasses.replace(cfg, attn_impl="standin")
    with pytest.raises(NotImplementedError, match="not ported by design"):
        prefill(params, standin, toks)


def test_caches_inject_then_scrub_restores_clean_serving(model, rng):
    """Faults injected into every protected layer's stores: the corrected
    read serves the clean logits exactly; a scrub repairs every flagged
    word in storage, after which the scan flags nothing and serving still
    gives the clean logits."""
    from repro_torch.memory import uniform_flip
    _, _, cfg, params = model
    B, S = 2, 12
    prompt, toks = _tokens(rng, cfg, B, S, 2)
    # wl160_r08 corrects every flagged word of this cache at this rate
    # (wl40_r08 leaves some single-flip words uncorrectable)
    pkv = ProtectedKVConfig(code_name="wl160_r08", page_tokens=4)

    def serve(inject, scrub):
        _, pc = prefill(params, cfg, torch.as_tensor(prompt),
                        protected_kv=pkv)
        changed = pc.inject(uniform_flip(3, 2e-3), key=5) if inject else 0
        if scrub:
            rep = pc.scrub()
            assert rep["flagged_words"] > 0
            assert rep["repaired_words"] == rep["flagged_words"]
            assert pc.stats()["flagged_words"] == 0
        lg, pc = decode_step(params, cfg, pc, torch.as_tensor(toks[0]), S)
        return lg, changed, pc

    clean, _, _ = serve(False, False)
    read, changed, pc = serve(True, False)
    assert changed > 0 and pc.stats()["flagged_words"] > 0
    assert torch.equal(read, clean)
    scrubbed, _, _ = serve(True, True)
    assert torch.equal(scrubbed, clean)
