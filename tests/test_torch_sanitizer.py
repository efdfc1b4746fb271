"""Port parity: the runtime sanitizer (`repro_torch.analysis`) against the
JAX package's `repro.analysis` sanitizer, on the CPU.

- The cases of `tests/test_sanitizer.py` mirrored on the port: the GF and
  attention entry points pass corrupted inputs through silently when the
  sanitizer is off and raise `SanitizerError` when it is on; clean inputs
  pass with unchanged results. The JAX file's
  `test_checks_skip_tracers_under_jit` has no counterpart: the port runs
  every entry point eagerly, so there is no traced value for a check to
  step around.
- Messages: on the same numpy inputs, the port raises where the JAX
  sanitizer raises, with the JAX text; `checkify` appends
  " (`check` failed)" to its own, which the port does not.
- `REPRO_SANITIZE=1` arms the ambient at import (one short subprocess).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import SanitizerError as JSanitizerError
from repro.analysis import check_finite as jcheck_finite
from repro.analysis import check_gf_symbols as jcheck_gf_symbols
from repro.analysis import check_quant_scales as jcheck_quant_scales
from repro.analysis import use_sanitizer as juse_sanitizer
from repro_torch.analysis import (SanitizerError, check_finite,
                                  check_gf_symbols, check_quant_scales,
                                  sanitizer_enabled, use_sanitizer)
from repro_torch.core import get_code
from repro_torch.core.decode import decode_integers
from repro_torch.kernels.gf_matmul import gf_matmul, scan_syndromes
from repro_torch.models import ProtectedKVConfig, ProtectedKVLayer
from _torch_threads import torch_threads_per_worker  # noqa: F401

CHECKIFY_SUFFIX = " (`check` failed)"


@pytest.fixture(autouse=True)
def _sanitizer_off():
    """Pin both ambients off, so the silent/raising pairs stay
    deterministic under REPRO_SANITIZE=1."""
    with use_sanitizer(False), juse_sanitizer(False):
        yield


@pytest.fixture
def code():
    return get_code("wl32_r08")


def _words(code, batch=3):
    """All-zero words are valid codewords for every registry code."""
    return torch.zeros((batch, code.n), dtype=torch.int32)


def _ht(code):
    return code.tensor("H.T", torch.device("cpu"), torch.int32)


def _bf16(rng, shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _layer(code_name="wl32_r08", *, batch=1, hkv=1, dh=8, page_tokens=4,
           n_pages=1, hot=2):
    pkv = ProtectedKVConfig(code_name=code_name, page_tokens=page_tokens,
                            fused=True)
    layer = ProtectedKVLayer(pkv, batch, hkv, dh, device="cpu")
    t = n_pages * page_tokens + hot
    rng = np.random.default_rng(0)
    layer.append(_bf16(rng, (batch, t, hkv, dh)),
                 _bf16(rng, (batch, t, hkv, dh)))
    assert layer.hot_len == hot
    return layer


def _q(layer, seed=7):
    return _bf16(np.random.default_rng(seed),
                 (layer.batch, 1, 2 * layer.hkv, layer.dh))


# -- ambient ------------------------------------------------------------------


def test_default_off_and_context_restores():
    assert not sanitizer_enabled()
    with use_sanitizer():
        assert sanitizer_enabled()
        with use_sanitizer(False):
            assert not sanitizer_enabled()
        assert sanitizer_enabled()
    assert not sanitizer_enabled()


def test_restores_on_exception():
    with pytest.raises(RuntimeError):
        with use_sanitizer():
            raise RuntimeError("boom")
    assert not sanitizer_enabled()


def test_sanitizer_error_is_a_runtime_error():
    assert issubclass(SanitizerError, RuntimeError)


# -- injected out-of-range GF symbol: silent without, raises with -------------


def test_scan_syndromes_out_of_range_symbol(code):
    assert code.n * (code.p - 1) ** 2 < 2 ** 31
    y = _words(code)
    y[0, 0] = code.p + 3
    ht = _ht(code)

    flags = scan_syndromes(y, ht, code.p)          # silent: a flag bit
    assert flags.shape == (3,)

    with use_sanitizer():
        with pytest.raises(SanitizerError, match="GF symbol"):
            scan_syndromes(y, ht, code.p)
        scan_syndromes(_words(code), ht, code.p)   # clean words pass


def test_decode_tolerates_drifted_levels(code):
    """Received levels drift outside [0, p) (the MLC failure model); the
    sanitizer checks what the decoder produces, so a drifted input decodes
    cleanly under it, above the field and below 0 alike."""
    y = _words(code)
    y[1, 2] = code.p                               # drifted one level up
    y[2, 3] = -1                                   # and one below 0
    with use_sanitizer():
        _y, res = decode_integers(code, y, n_iters=4)
    sym = res.symbols.numpy()
    assert ((sym >= 0) & (sym < code.p)).all()
    assert torch.isfinite(res.llv_totals).all()


def test_gf_matmul_out_of_range_symbol():
    p = 5
    a = torch.zeros((4, 8), dtype=torch.int32)
    a[0, 0] = p + 2
    b = torch.zeros((8, 4), dtype=torch.int32)

    out = gf_matmul(a, b, p)                       # silent: wraps mod p
    assert out.shape == (4, 4)

    with use_sanitizer():
        with pytest.raises(SanitizerError, match="gf_matmul lhs"):
            gf_matmul(a, b, p)
        with pytest.raises(SanitizerError, match="gf_matmul rhs"):
            gf_matmul(b.T.contiguous(), a.T.contiguous(), p)
        gf_matmul(torch.zeros((4, 8), dtype=torch.int32), b, p)


# -- NaN attention accumulator: silent NaN output without, raises with --------


def test_attend_nan_accumulator_caught():
    layer = _layer()
    # a poisoned hot token flows through the online softmax into the
    # output without any exception
    layer.hot_k[0, 0] = float("nan")
    q = _q(layer)

    out = layer.attend(q).float()
    assert torch.isnan(out).any(), "expected silent NaN propagation"

    with use_sanitizer():
        with pytest.raises(SanitizerError,
                           match="attend_protected output"):
            layer.attend(q)


def test_attend_nan_query_caught():
    layer = _layer()
    q = _q(layer)
    q[0, 0, 0, 0] = float("nan")

    layer.attend(q)                                # silent

    with use_sanitizer():
        with pytest.raises(SanitizerError, match="query"):
            layer.attend(q)


def test_attend_bad_pages_and_scales_caught():
    """Out-of-field page cells and negative scales, straight into the
    wrapper (the layer never builds them)."""
    layer = _layer()
    kp, vp, ks, vs, valid = layer._fused_inputs()
    code = layer.k_store.code
    q = _q(layer)
    hot_valid = torch.full((layer.batch,), layer.hot_len, dtype=torch.int32)

    def call(kp=kp, vp=vp, ks=ks, vs=vs):
        from repro_torch.kernels.paged_attention import attend_protected
        return attend_protected(
            q, kp, vp, ks, vs, valid, layer.hot_k, layer.hot_v, hot_valid,
            p=code.p, k_info=code.k, page_shape=layer.page_shape)

    bad = vp.clone()
    bad[0, 0, 0, 0] = code.p
    call(vp=bad)                                    # silent
    with use_sanitizer():
        with pytest.raises(SanitizerError, match="V pages"):
            call(vp=bad)
        with pytest.raises(SanitizerError, match="K scales"):
            call(ks=-ks)
        call()


def test_attend_clean_passes_under_sanitizer():
    layer = _layer()
    q = _q(layer)
    ref = layer.attend(q)
    with use_sanitizer():
        out = layer.attend(q)
    assert torch.equal(out, ref)


# -- quantization scales ------------------------------------------------------


def test_quant_scales_checks():
    with use_sanitizer():
        check_quant_scales(torch.tensor([0.0, 1.5, 2.0]))   # 0 = padded
        with pytest.raises(SanitizerError, match="scale"):
            check_quant_scales(torch.tensor([1.0, -0.5]))
        with pytest.raises(SanitizerError):
            check_quant_scales(torch.tensor([1.0, float("inf")]))


# -- check primitives: disabled / no-op / skip semantics ----------------------


def test_checks_are_noops_when_disabled():
    check_gf_symbols(torch.tensor([99]), 5)
    check_finite(torch.tensor([float("nan")]))
    check_quant_scales(torch.tensor([-1.0]))


def test_check_finite_ignores_integer_tensors():
    with use_sanitizer():
        check_finite(torch.tensor([1, 2, 3], dtype=torch.int32))


def test_checks_skip_empty_tensors():
    with use_sanitizer():
        check_gf_symbols(torch.zeros((0, 4), dtype=torch.int32), 5)
        check_finite(torch.zeros((0,), dtype=torch.float32))
        check_quant_scales(torch.zeros((0,), dtype=torch.float32))


# -- message parity with the JAX sanitizer ------------------------------------

INF, NAN = float("inf"), float("nan")
MESSAGE_CASES = [
    ("gf", np.array([[0, 3], [1, 2]], np.int8), 3, "scan_syndromes words"),
    ("gf", np.array([-2, 1, 4], np.int32), 5, "gf_matmul lhs"),
    ("gf", np.array([0, 1, 4], np.int32), 5, "clean"),
    ("finite", np.array([NAN, INF, 1.0, NAN], np.float32), None,
     "attend_protected query"),
    ("finite", np.array([NAN, -INF], np.float32), None, "out"),
    ("finite", np.array([1.0, 2.0], np.float32), None, "clean"),
    ("finite", np.array([1, 2], np.int32), None, "ints"),
    ("scales", np.array([1.0, -0.5], np.float32), None, "K scales"),
    ("scales", np.array([1.0, INF], np.float32), None, "V scales"),
    ("scales", np.array([1.0, NAN], np.float32), None, "nan"),
    ("scales", np.array([0.1, -1e-8], np.float32), None, "tiny"),
    ("scales", np.array([0.0, 0.5], np.float32), None, "clean"),
]


def _raise_text(fn, err):
    try:
        fn()
    except err as e:
        return str(e)
    return None


@pytest.mark.parametrize("kind,arr,p,what", MESSAGE_CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in MESSAGE_CASES])
def test_messages_match_jax(kind, arr, p, what):
    port = {"gf": lambda a: check_gf_symbols(a, p, what),
            "finite": lambda a: check_finite(a, what),
            "scales": lambda a: check_quant_scales(a, what)}[kind]
    ref = {"gf": lambda a: jcheck_gf_symbols(a, p, what),
           "finite": lambda a: jcheck_finite(a, what),
           "scales": lambda a: jcheck_quant_scales(a, what)}[kind]
    with use_sanitizer(), juse_sanitizer():
        got = _raise_text(lambda: port(torch.from_numpy(arr)),
                          SanitizerError)
        want = _raise_text(lambda: ref(jnp.asarray(arr)), JSanitizerError)
    if want is None:
        assert got is None
    else:
        assert want.endswith(CHECKIFY_SUFFIX)
        assert got == want[:-len(CHECKIFY_SUFFIX)]


# -- REPRO_SANITIZE=1 ---------------------------------------------------------


def test_env_switch_arms_at_import():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, REPRO_SANITIZE="1",
               PYTHONPATH=os.path.abspath(src))
    prog = ("from repro_torch.analysis.sanitizer import "
            "sanitizer_enabled, check_gf_symbols, SanitizerError\n"
            "import torch\n"
            "assert sanitizer_enabled()\n"
            "try:\n"
            "    check_gf_symbols(torch.tensor([7]), 5, 'env')\n"
            "except SanitizerError as e:\n"
            "    print(e)\n")
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "sanitizer[env]: GF symbol outside [0, 5): min=7, max=7")
