"""Port parity: the fused protected paged attention.

`repro_torch.kernels.paged_attention.attend_protected_plain` (what the
wrapper runs on CPU tensors, and what the CUDA kernel is held against on
the card) against the JAX package's `ops.attend_protected` on identical
operands: GF pages, scales, valid counts, hot page and query made once
(K/V and queries drawn with numpy, pages quantized and encoded by the JAX
package's `ProtectedKVLayer`, corruption injected there and corrected by
its scan-gated read) and handed to both.

Tolerances:
- against the JAX oracle (`use_policy("ref")`, `ref.attend_protected_ref`):
  one bf16 ulp (rtol 2**-7, atol 2**-10). Both round the dequantized pages
  and the QKᵀ logits to bf16 at the same places; on the CPU they agree
  bit for bit, the ulp leaves room for the sum order of a bf16 product;
- against the Pallas kernel in interpret mode: atol = rtol = 2e-2, the
  JAX package's own tolerance for that kernel (it keeps K/V and logits in
  fp32, the oracle rounds them to bf16).

The JAX wrapper pads the page axis to a power of two (`np_bucket`); the
port is given only the real pages, so each case also checks that dropping
the padding changes nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_code
from repro.kernels import ops, use_policy
from repro.memory import asymmetric_adjacent
from repro.memory import paged as jpaged
from repro.models.kv import ProtectedKVConfig, ProtectedKVLayer
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.paged_attention import (attend_protected,
                                                 attend_protected_plain,
                                                 dequant_gf_page)
from _torch_threads import torch_threads_per_worker  # noqa: F401

ULP = dict(rtol=2 ** -7, atol=2 ** -10)


def _t(x, dtype=None):
    """A JAX or numpy array -> a CPU tensor (bf16 through float32)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


def _layer(code_name, *, batch=2, hkv=2, dh=8, page_tokens=4, n_pages=2,
           hot=3, seed=0, edge=False):
    """A JAX ProtectedKVLayer holding `n_pages` frozen pages and `hot` hot
    tokens of numpy-made K/V."""
    rng = np.random.default_rng(seed)
    t = n_pages * page_tokens + hot
    k = rng.standard_normal((batch, t, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((batch, t, hkv, dh)).astype(np.float32)
    if edge:
        # absmax saturation and exact-zero tokens: the int8 round/clip edges
        k[:, 0], v[:, 0] = 512.0, -512.0
        k[:, 1], v[:, 1] = 0.0, 0.0
    layer = ProtectedKVLayer(
        ProtectedKVConfig(code_name=code_name, page_tokens=page_tokens),
        batch, hkv, dh)
    layer.append(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    return layer


def _operands(layer, *, hq_per_kv=2, sq=1, seed=7):
    """The JAX layer's fused operands (bucket-padded) and a query."""
    kp, vp, ks, vs, valid = layer._fused_inputs()
    q = _bf16(np.random.default_rng(seed),
              (layer.batch, sq, layer.hkv * hq_per_kv, layer.dh))
    hot_valid = jnp.full((layer.batch,), layer.hot_len, jnp.int32)
    code = layer.k_store.code
    kw = dict(p=code.p, k_info=code.k, page_shape=layer.page_shape)
    return (q, kp, vp, ks, vs, valid, layer.hot_k, layer.hot_v,
            hot_valid), len(layer._metas), kw


def _jax(ops_args, policy, **kw):
    with use_policy(policy):
        return np.asarray(ops.attend_protected(*ops_args, **kw)
                          ).astype(np.float32)


def _port(ops_args, n_pages, **kw):
    """attend_protected_plain on the same operands as CPU tensors, pages
    cut to the real ones and stored as int8 cells (the port's storage
    type). The wrapper, given CPU tensors, returns the same."""
    q, kp, vp, ks, vs, valid, hk, hv, hval = ops_args
    pages = [_t(x)[:n_pages] for x in (kp, vp, ks, vs, valid)]
    pages[0], pages[1] = pages[0].to(torch.int8), pages[1].to(torch.int8)
    args = (_t(q), *pages, _t(hk), _t(hv), _t(hval))
    out = attend_protected_plain(*args, **kw)
    assert out.dtype == torch.bfloat16
    assert torch.equal(attend_protected(*args, **kw), out)
    return out.float().numpy()


@pytest.mark.parametrize("code_name", ["wl40_r08", "wl160_r08"])
@pytest.mark.parametrize("case", ["clean", "corrected", "quant_edges"])
def test_plain_matches_jax_oracle(code_name, case):
    layer = _layer(code_name, seed=1 if case == "corrected" else 0,
                   edge=case == "quant_edges")
    if case == "corrected":
        code = get_code(code_name)
        assert layer.inject(asymmetric_adjacent(code.p, 0.002, 0.002),
                            key=3) > 0
    args, n_pages, kw = _operands(layer)
    if case == "corrected":
        assert layer.stats()["detected"] > 0
    want = _jax(args, "ref", with_hot=True, **kw)
    n0 = LAUNCHES["attend_protected"]
    got = _port(args, n_pages, with_hot=True, **kw)
    assert LAUNCHES["attend_protected"] == n0     # CPU: no kernel launch
    np.testing.assert_allclose(got, want, **ULP)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("hot", [0, 3])
def test_plain_softcap_and_hot(softcap, hot):
    """Soft-capped logits, and the step right after a freeze (hot_len 0:
    the hot update is skipped, `with_hot=False`)."""
    layer = _layer("wl40_r08", hot=hot)
    args, n_pages, kw = _operands(layer)
    kw.update(softcap=softcap, with_hot=hot > 0)
    np.testing.assert_allclose(_port(args, n_pages, **kw),
                               _jax(args, "ref", **kw), **ULP)


def test_plain_hot_only_no_pages():
    """NP = 0: the JAX wrapper pads one zero page, the port passes none."""
    layer = _layer("wl40_r08", n_pages=0, hot=3)
    args, n_pages, kw = _operands(layer, hq_per_kv=4, sq=2)
    assert n_pages == 0 and args[1].shape[0] == 1
    np.testing.assert_allclose(_port(args, 0, with_hot=True, **kw),
                               _jax(args, "ref", with_hot=True, **kw), **ULP)


def test_plain_needs_a_page():
    layer = _layer("wl40_r08", n_pages=0, hot=3)
    args, _, kw = _operands(layer)
    with pytest.raises(ValueError, match="at least one KV page"):
        _port(args, 0, with_hot=False, **kw)


def _per_slot_operands(rng, *, B=3, NP=3, T=4, hkv=2, dh=8, code_name):
    """S = B sub-pages per page step, page_shape (1, T, Hkv, D): each
    slot's pages quantized and encoded on its own, ragged valid counts
    with empty rows (valid 0) on some steps, and a ragged hot page."""
    code = get_code(code_name)
    page_shape = (1, T, hkv, dh)
    W = jpaged.words_for_tensor(page_shape, code.p, code.k)
    pages = {"k": np.zeros((NP, B, W, code.n), np.int32)}
    pages["v"] = np.zeros_like(pages["k"])
    scales = {"k": np.zeros((NP, B), np.float32)}
    scales["v"] = np.zeros_like(scales["k"])
    P = jnp.asarray(code.P, jnp.int32)
    assert code.k * (code.p - 1) ** 2 < 2 ** 31   # int32 accumulator bound
    for name in ("k", "v"):
        for j in range(NP):
            for s in range(B):
                x = _bf16(rng, page_shape, scale=2.0)
                words, meta = jpaged.quantize_tensor(x, code.p, code.k)
                enc = ops.encode_words(words, P, code.p)
                pages[name][j, s] = np.asarray(enc)
                scales[name][j, s] = float(meta.scale)
    valid = rng.integers(0, T + 1, (NP, B)).astype(np.int32)
    valid[0, 1] = 0
    hot_valid = rng.integers(1, T + 1, B).astype(np.int32)
    q = _bf16(rng, (B, 1, hkv * 2, dh))
    hot_k, hot_v = _bf16(rng, (B, T, hkv, dh)), _bf16(rng, (B, T, hkv, dh))
    args = (q, jnp.asarray(pages["k"]), jnp.asarray(pages["v"]),
            jnp.asarray(scales["k"]), jnp.asarray(scales["v"]),
            jnp.asarray(valid), hot_k, hot_v, jnp.asarray(hot_valid))
    return args, dict(p=code.p, k_info=code.k, page_shape=page_shape)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_plain_per_slot_subpages(softcap):
    args, kw = _per_slot_operands(np.random.default_rng(5),
                                  code_name="wl160_r08")
    kw.update(softcap=softcap, with_hot=True)
    np.testing.assert_allclose(_port(args, args[1].shape[0], **kw),
                               _jax(args, "ref", **kw), **ULP)


@pytest.mark.parametrize("case", ["layer", "per_slot"])
def test_plain_against_pallas_interpret(case):
    """The Pallas kernel, interpreted on the CPU, at the JAX package's own
    tolerance for it."""
    if case == "layer":
        layer = _layer("wl40_r08", hot=2)
        args, n_pages, kw = _operands(layer)
    else:
        args, kw = _per_slot_operands(np.random.default_rng(6),
                                      code_name="wl40_r08")
        n_pages = args[1].shape[0]
    kw.update(softcap=30.0, with_hot=True)
    np.testing.assert_allclose(_port(args, n_pages, **kw),
                               _jax(args, "interpret", **kw),
                               atol=2e-2, rtol=2e-2)


def test_dequant_gf_page_matches_store_dequantize():
    """The page dequant equals the JAX package's dequantize_tensor."""
    layer = _layer("wl160_r08", n_pages=1, hot=0)
    code = layer.k_store.code
    words = layer.k_store.page(0)
    meta = layer._metas[0][0]
    want = np.asarray(jpaged.dequantize_tensor(words[:, :code.k], meta,
                                               code.p)).astype(np.float32)
    got = dequant_gf_page(_t(words).to(torch.int8), _t(meta.scale),
                          p=code.p, k_info=code.k,
                          page_shape=layer.page_shape)
    np.testing.assert_array_equal(got.float().numpy(), want)
