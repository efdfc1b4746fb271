"""Port parity: PIM-protected serving. `repro_torch.core.PIMContext`, the
model's protected `mlp_down` / `attn_o` projections, `encode_params_for_pim`
and the serving command line against the JAX package on the CPU.

Exact:
- `quantize_acts`, and `PIMContext.matmul`'s integer path on ternary
  weights and integer activations (scale 1, alpha 1: every output is an
  integer both packages compute exactly), clean and with the JAX
  package's noise. The noise is the JAX side's noisy MAC minus its clean
  MAC under the same key, handed to the port as `out_noise`;
- `encode_params_for_pim`'s `*_enc` cells on identical weights.

Allclose, with the reason at each test:
- `ternarize`'s threshold and alpha (a float32 mean over a different
  reduction order);
- model logits with `pim_ctx` on weights and precoded cells carried
  across by `convert.params_from_arrays`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import PIMSpec as JPIMSpec
from repro.core import pim as jpim
from repro.core.context import PIMContext as JPIMContext
from repro.models import decode_step as jdecode_step
from repro.models import encode_params_for_pim as jencode_params
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.configs.base import PIMSpec
from repro_torch.convert import params_from_arrays
from repro_torch.core import PIMContext, get_code, prepare_weights
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import (decode_step, encode_params_for_pim, forward,
                                init_caches, init_params, loss_fn, prefill)
from _torch_threads import torch_threads_per_worker  # noqa: F401

REDUCED = dict(n_groups=2, d_model=128, n_heads=4, d_ff=256)


def _spec(**kw):
    kw = dict(enabled=True, code_name="wl40_r08", mode="correct",
              n_iters=4) | kw
    return JPIMSpec(**kw), PIMSpec(**kw)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# PIMContext
# ---------------------------------------------------------------------------


def test_ternarize_matches_reference(rng):
    """Ternary weights and alpha. Both compute t = 0.7 * mean|W| in
    float32 but reduce in different orders, so t may differ by an ulp:
    entries within 2^-20 relative of t are left out of the comparison,
    and alpha (a mean over the kept entries, also reduced in another
    order) is compared at rtol 2^-20."""
    W = rng.standard_normal((96, 72)).astype(np.float32)
    jq, ja = JPIMContext.ternarize(jnp.asarray(W))
    tq, ta = PIMContext.ternarize(torch.as_tensor(W))
    t = 0.7 * np.abs(W).mean(dtype=np.float64)
    far = np.abs(np.abs(W) - t) > t * 2 ** -20
    np.testing.assert_array_equal(tq.numpy()[far], np.asarray(jq)[far])
    assert set(np.unique(tq.numpy())) == {-1, 0, 1}
    np.testing.assert_allclose(float(ta), float(ja), rtol=2 ** -20)


def test_quantize_acts_matches_reference(rng):
    """One scale over the whole input (max is exact in any order), then
    round-half-even: exact."""
    x = (rng.standard_normal((3, 5, 40)) * 2).astype(np.float32)
    jx, js = JPIMContext(_spec()[0]).quantize_acts(jnp.asarray(x))
    tx, ts = PIMContext(_spec()[1]).quantize_acts(torch.as_tensor(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert float(ts) == float(js)
    assert ts.dim() == 0                        # global, not per row


def _integer_case(rng, rows=24, n_in=48, n_out=70):
    """Integer activations whose max |x| is 7 (scale 1) and ternary
    weights holding every level (alpha 1): the protected matmul's output
    is its integer output."""
    x = rng.integers(-7, 8, (rows, n_in)).astype(np.float32)
    x[0, 0] = 7
    W = rng.integers(-1, 2, (n_in, n_out)).astype(np.float32)
    return x, W


@pytest.mark.parametrize("mode", ["off", "detect", "correct",
                                  "correct_budget"])
def test_pim_context_integer_path_matches_reference(mode, rng):
    jspec, tspec = _spec(mode=mode, correct_budget=4)
    x, W = _integer_case(rng)
    jctx, tctx = JPIMContext(jspec), PIMContext(tspec)
    want = np.asarray(jctx.matmul(jnp.asarray(x), jnp.asarray(W), "a"))
    got = tctx.matmul(torch.as_tensor(x), torch.as_tensor(W), "a")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x @ W)    # no faults: exact
    assert tctx.stats()["calls"] == 1


@pytest.mark.parametrize("mode", ["off", "correct", "correct_budget"])
def test_pim_context_reference_noise_matches_exactly(mode, rng):
    """The JAX context faulted under a key against the port's clean
    context given that key's noise: the same outputs, corrected or not.
    At 0.3% of outputs hit, wl40_r08 corrects more than it breaks (at 1%
    both packages' decoders miscorrect more words than they fix)."""
    jspec, tspec = _spec(mode=mode, correct_budget=6)
    x, W = _integer_case(rng)
    key = jax.random.PRNGKey(3)
    jctx = JPIMContext(jspec).with_faults(key, 3e-3)
    want = np.asarray(jctx.matmul(jnp.asarray(x), jnp.asarray(W), "a"))
    W_enc = np.asarray(prepare_weights(torch.as_tensor(W, dtype=torch.int32),
                                       get_code("wl40_r08")))
    xq = jnp.asarray(x, jnp.int32)
    noise = (np.asarray(jpim.pim_mac(xq, jnp.asarray(W_enc), jctx._fault_cfg,
                                     key=key))
             - np.asarray(jpim.pim_mac(xq, jnp.asarray(W_enc),
                                       jctx.pim_cfg)))
    assert np.abs(noise).sum() > 0
    tctx = PIMContext(tspec)
    got = tctx.matmul(torch.as_tensor(x), torch.as_tensor(W), "a",
                      out_noise=torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    raw = PIMContext(_spec(mode="off")[1]).matmul(
        torch.as_tensor(x), torch.as_tensor(W), "a",
        out_noise=torch.as_tensor(noise))
    n_raw = int((raw.numpy() != x @ W).sum())
    assert n_raw > 0
    if mode != "off":
        assert tctx.stats()["detected_words"] > 0
        assert (got.numpy() != x @ W).sum() < n_raw   # corrections landed


def test_pim_context_faults_fixed_per_context(rng):
    """Every call of a faulted context draws from its seed anew: equal
    shapes, equal faults; another seed, other faults; the base context
    stays clean."""
    _, tspec = _spec(mode="off")
    base = PIMContext(tspec)
    x = torch.as_tensor(rng.normal(size=(2, 4, 16)).astype(np.float32))
    W = torch.as_tensor(rng.normal(size=(16, 32)).astype(np.float32))
    ctx = base.with_faults(0, 0.05)
    y1, y2 = ctx.matmul(x, W, "a"), ctx.matmul(x, W, "a")
    assert torch.equal(y1, y2)
    assert not torch.equal(base.with_faults(1, 0.05).matmul(x, W, "a"), y1)
    assert not torch.equal(base.matmul(x, W, "a"), y1)
    assert base.stats() == {"calls": 1, "words": 8, "detected_words": 0,
                            "uncorrected_words": 0}
    assert ctx.stats()["calls"] == 2


@pytest.mark.parametrize("fold", [1, 2, 3, 64])
def test_pim_context_stats_sum_every_call(rng, fold, monkeypatch):
    """The counts folded every `fold` calls and by `stats()` equal the
    per-call sums of the results' flags, read between calls too."""
    _, tspec = _spec(mode="correct")
    monkeypatch.setattr(PIMContext, "FOLD", fold)
    ctx = PIMContext(tspec).with_faults(0, 0.02)
    W = torch.as_tensor(rng.normal(size=(16, 32)).astype(np.float32))
    want = dict(calls=0, words=0, detected_words=0, uncorrected_words=0)
    seen = []
    real = ctx._count

    def spy(res):
        seen.append(res)
        real(res)
    monkeypatch.setattr(ctx, "_count", spy)
    for rows in (1, 3, 2, 5, 4):
        x = torch.as_tensor(rng.normal(size=(rows, 16)).astype(np.float32))
        ctx.matmul(x, W, "a")
        res = seen[-1]
        want["calls"] += 1
        want["words"] += res.detected.numel()
        want["detected_words"] += int(res.detected.sum())
        want["uncorrected_words"] += int(res.uncorrected.sum())
        if rows == 2:
            assert ctx.stats() == want
    assert ctx.stats() == want
    assert want["detected_words"] > 0


def test_pim_context_rejects_wide_activation_levels():
    with pytest.raises(ValueError, match="act_levels"):
        PIMContext(_spec()[1], act_levels=200)


# the JAX package's own PIMContext cases (tests/test_protected.py)


def test_prepare_weights_pads(rng):
    code = get_code("wl40_r08")
    W = torch.as_tensor(rng.integers(-1, 2, (8, code.k + 5)))
    assert prepare_weights(W, code).shape[1] == 2 * code.n


def test_pim_context_matmul_close_to_float(rng):
    ctx = PIMContext(_spec()[1])
    x = torch.as_tensor(rng.normal(size=(4, 10, 24)).astype(np.float32))
    W = torch.as_tensor(rng.normal(size=(24, 48)).astype(np.float32))
    y = ctx.matmul(x, W, "mlp_down")
    assert y.shape == (4, 10, 48) and y.dtype == torch.float32
    ref = x.numpy() @ W.numpy()
    corr = np.corrcoef(y.numpy().ravel(), ref.ravel())[0, 1]
    assert corr > 0.75, corr       # ternary+int quantization keeps structure


def test_pim_context_fault_injection_deterministic(rng):
    ctx = PIMContext(_spec(mode="off")[1]).with_faults(0, 0.05)
    x = torch.as_tensor(rng.normal(size=(2, 4, 16)).astype(np.float32))
    W = torch.as_tensor(rng.normal(size=(16, 32)).astype(np.float32))
    assert torch.equal(ctx.matmul(x, W, "a"), ctx.matmul(x, W, "a"))


# ---------------------------------------------------------------------------
# the model: precoded weights, prefill, decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """Reduced paper-pim-2b (wl320_r08 on mlp_down and attn_o), its JAX
    parameters precoded by the JAX package and carried across."""
    jcfg = jget_config("paper_pim").reduced(**REDUCED)
    cfg = get_config("paper_pim").reduced(**REDUCED)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jencode_params(jinit_params(jax.random.PRNGKey(0), jcfg), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_arrays(tree, cfg, device="cpu")


def test_encode_params_for_pim_matches_reference(model):
    """The port's own encode of the carried fp weights gives the JAX
    package's int8 cells exactly (and its alphas to the float32 mean's
    reduction order, see test_ternarize_matches_reference)."""
    jcfg, jparams, cfg, carried = model
    assert {k: [tuple(t.shape) for t in v]
            for k, v in carried.pim_leaves().items()} == {
        "groups/pos0/attn/wo_alpha": [()] * 2,
        "groups/pos0/attn/wo_enc": [(128, 320)] * 2,
        "groups/pos0/mlp/w_down_alpha": [()] * 2,
        "groups/pos0/mlp/w_down_enc": [(256, 320)] * 2}
    tree = jax.tree.map(np.asarray, jparams)
    fresh = params_from_arrays(
        {**tree, "groups": {"pos0": {
            sub: {k: v for k, v in leaf.items() if not k.endswith(
                ("_enc", "_alpha"))} if isinstance(leaf, dict) else leaf
            for sub, leaf in tree["groups"]["pos0"].items()}}},
        cfg, device="cpu")
    assert fresh.pim_leaves() == {}
    n0 = LAUNCHES["gf_matmul"]
    encode_params_for_pim(fresh, cfg)
    assert LAUNCHES["gf_matmul"] == n0             # CPU tensors: plain
    grp = jparams["groups"]["pos0"]
    leaves = fresh.pim_leaves()
    for path, want in (("mlp/w_down", grp["mlp"]), ("attn/wo", grp["attn"])):
        name = path.split("/")[1]
        got = torch.stack(leaves[f"groups/pos0/{path}_enc"])
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want[f"{name}_enc"]))
        np.testing.assert_allclose(
            torch.stack(leaves[f"groups/pos0/{path}_alpha"]).numpy(),
            np.asarray(want[f"{name}_alpha"]), rtol=2 ** -20)
    assert sum(p.numel() for p in fresh.parameters()) == \
        sum(p.numel() for leaf in fresh.leaves().values() for p in leaf)


# logits: both packages compute the unprotected layers in bf16, but XLA's
# CPU build and PyTorch round the bf16 matmuls and the SiLU at slightly
# different places (one bf16 ulp, tests/test_torch_serving.py). A protected
# projection then quantizes its whole bf16 input to +-7 levels with one
# scale: an ulp on an input that sits on a rounding boundary, or on the
# input's max (the scale), moves integer activations by one level, and one
# level of seven moves that row's outputs by a few percent. Measured over
# four prompts: median gap 0.006-0.010, largest 0.06-0.094, every logit
# position touched; the protected logits differ from the unprotected
# model's by a median of 0.08 and up to 0.53. So the bound is 2^-3 on
# the largest gap and 2^-5 on the median.
LOGITS_ATOL, LOGITS_MEDIAN = 2 ** -3, 2 ** -5


def _close(got, want):
    d = np.abs(_np(got) - _np(want))
    assert d.max() <= LOGITS_ATOL and np.median(d) <= LOGITS_MEDIAN, \
        (d.max(), np.median(d))


def test_protected_prefill_and_decode_match_jax(model, rng):
    """prefill + 3 decode steps with `pim_ctx` on the precoded cells, on
    dense caches: logits within the bounds above of the JAX package's, and
    the protected path really taken (the logits differ from the
    unprotected model's by more than that)."""
    jcfg, jparams, cfg, params = model
    B, S, steps = 2, 8, 3
    prompt = rng.integers(0, cfg.vocab_size, (B, S))
    toks = rng.integers(0, cfg.vocab_size, (steps, B, 1))
    jctx, tctx = JPIMContext(jcfg.pim), PIMContext(cfg.pim)
    jl, jc = jprefill(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                      pim_ctx=jctx)
    tl, tc = prefill(params, cfg, torch.as_tensor(prompt), pim_ctx=tctx)
    _close(tl, jl)
    plain, _ = prefill(params, cfg, torch.as_tensor(prompt))
    assert float((plain - tl).abs().median()) > 2 * LOGITS_MEDIAN

    jc = jax.tree.map(lambda x: jnp.pad(
        x, [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]), jc)
    caches = init_caches(cfg, B, S + steps, device="cpu")
    for pos, e in tc.items():
        for name, val in e.items():
            caches[pos][name][:, :, :S] = val
    for i in range(steps):
        jl, jc = jdecode_step(jparams, jcfg, jc,
                              jnp.asarray(toks[i], jnp.int32),
                              jnp.asarray(S + i), pim_ctx=jctx)
        tl, caches = decode_step(params, cfg, caches,
                                 torch.as_tensor(toks[i]), S + i,
                                 pim_ctx=tctx)
        _close(tl, jl)
    # 2 layers x 2 projections, in the prefill and each decode step
    assert tctx.stats()["calls"] == 4 * (1 + steps)
    assert tctx.stats()["uncorrected_words"] == 0


def test_forward_with_pim_ctx_is_inference_only(model, rng):
    """`forward` with `pim_ctx` equals the prefill's logits; under grad
    (a training step) it raises, naming the roadmap item."""
    _, _, cfg, params = model
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 6)))
    ctx = PIMContext(cfg.pim)
    with torch.no_grad():
        lg = forward(params, cfg, toks, pim_ctx=ctx)
    want, _ = prefill(params, cfg, toks, pim_ctx=ctx)
    assert torch.equal(lg, want)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        loss_fn(params, cfg, batch, pim_ctx=ctx)


def test_protected_kv_decode_with_pim_ctx(model, rng):
    """`pim_ctx` through the protected KV caches: a faulted context in
    mode "correct" serves the clean context's logits exactly, with no
    uncorrected word, and the same faults unprotected do not."""
    from repro_torch.models import ProtectedKVConfig
    _, _, cfg, params = model
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)))
    pkv = ProtectedKVConfig(code_name="wl40_r08", page_tokens=4)

    def run(ctx):
        lg, caches = prefill(params, cfg, prompt, pim_ctx=ctx,
                             protected_kv=pkv)
        out = [lg]
        tok = lg[:, -1:].argmax(dim=-1)
        for i in range(3):
            lg, caches = decode_step(params, cfg, caches, tok, 8 + i,
                                     pim_ctx=ctx)
            out.append(lg)
            tok = lg.argmax(dim=-1)
        return torch.cat(out, dim=1)

    clean = run(PIMContext(cfg.pim))
    faulted = PIMContext(cfg.pim).with_faults(5, 2e-3)
    assert torch.equal(run(faulted), clean)
    st = faulted.stats()
    assert st["detected_words"] > 0 and st["uncorrected_words"] == 0
    off = dataclasses.replace(cfg.pim, mode="off")
    assert not torch.equal(run(PIMContext(off).with_faults(5, 2e-3)), clean)


# ---------------------------------------------------------------------------
# the serving command line (the JAX package's tests/test_system.py serve
# tests)
# ---------------------------------------------------------------------------


def test_serving_generates_and_protection_changes_nothing_clean():
    base = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--device", "cpu"]
    toks_raw = serve.main(base)
    toks_prot = serve.main(base + ["--protect"])
    toks_pre = serve.main(base + ["--protect", "--precoded"])
    assert toks_raw.shape == toks_prot.shape == (2, 4)
    assert isinstance(toks_prot, np.ndarray)
    np.testing.assert_array_equal(toks_pre, toks_prot)


def test_protected_serving_under_faults_matches_clean_more_often():
    """NB-LDPC-corrected generation under the paper's fault model agrees
    with fault-free generation (Fig. 6(c) at serving level)."""
    args = ["--reduced", "--batch", "4", "--prompt-len", "8", "--gen", "6",
            "--protect", "--device", "cpu"]
    clean = serve.main(args)
    noisy = serve.main(args + ["--fault-rate", "0.002"])
    assert (clean == noisy).mean() >= 0.5


def test_serve_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--protect"])


def test_init_params_has_no_pim_buffers_until_precoded():
    cfg = get_config("paper_pim").reduced(**REDUCED)
    params = init_params(cfg, 0, device="cpu")
    assert params.pim_leaves() == {}
    assert "w_down_enc" not in dict(params.named_parameters())
    encode_params_for_pim(params, cfg)
    assert len(params.pim_leaves()) == 4
    assert all(not k.endswith(("_enc", "_alpha")) for k in params.leaves())
