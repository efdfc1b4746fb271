"""Port parity: `repro_torch.core.decode_integers` against the JAX
package's `decode_integers` on identical corrupted words (drawn with
numpy). Symbols, corrected words, detect_fail and per-codeword iterations
are exact; the LLV totals are bit-for-bit equal too, since the port sums
in the reference's order and fuses the damped sum the way its CPU build
does (`repro_torch.core.decode._damp`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode_integers as jdecode
from repro.core import decode_stream as jstream
from repro.core import get_code as jget
from repro.core import np_encode_words
from repro_torch.core import decode_integers as tdecode
from repro_torch.core import decode_stream as tstream
from repro_torch.core import get_code as tget
from _torch_threads import torch_threads_per_worker  # noqa: F401


def _received(code, rng, B, rate):
    y = np_encode_words(rng.integers(0, code.p, (B, code.k)), code)
    hit = rng.random(y.shape) < rate
    y[hit] += rng.choice([-1, 1], hit.sum())       # levels drift past [0, p)
    return y


def _assert_same(jres, tres):
    (jy, jr), (ty, tr) = jres, tres
    assert np.array_equal(np.asarray(jy), ty.numpy())
    assert np.array_equal(np.asarray(jr.symbols), tr.symbols.numpy())
    assert np.array_equal(np.asarray(jr.detect_fail), tr.detect_fail.numpy())
    assert np.array_equal(np.asarray(jr.iterations), tr.iterations.numpy())
    jt, tt = np.asarray(jr.llv_totals), tr.llv_totals.numpy()
    assert np.array_equal(jt, tt)


@pytest.mark.parametrize("name", ["wl40_r08", "wl160_r08", "wl160_r08_gf5"])
@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("damping", [0.0, 0.3])
def test_decode_integers_matches_reference(name, early_exit, damping):
    rng = np.random.default_rng(7)
    jc, tc = jget(name), tget(name)
    y = _received(jc, rng, 48, 0.02)
    kw = dict(n_iters=6, early_exit=early_exit, damping=damping)
    jres = jdecode(jc, jnp.asarray(y, jnp.int32), **kw)
    tres = tdecode(tc, torch.as_tensor(y, dtype=torch.int32), **kw)
    _assert_same(jres, tres)
    assert (np.asarray(jres[0]) != y).any()       # the decoder did work


@pytest.mark.parametrize("llv_mode", ["manhattan", "gaussian"])
def test_decode_llv_modes_and_scale(llv_mode):
    rng = np.random.default_rng(3)
    jc, tc = jget("wl40_r08"), tget("wl40_r08")
    y = _received(jc, rng, 32, 0.03)
    kw = dict(n_iters=5, llv_mode=llv_mode, llv_scale=2.5, early_exit=True)
    _assert_same(jdecode(jc, jnp.asarray(y, jnp.int32), **kw),
                 tdecode(tc, y, device="cpu", **kw))


def test_clean_words_stop_after_one_iteration():
    rng = np.random.default_rng(0)
    tc = tget("wl40_r08")
    y = np_encode_words(rng.integers(0, 3, (8, tc.k)), tc)
    y_corr, res = tdecode(tc, y, device="cpu", n_iters=10, early_exit=True)
    assert (res.iterations == 1).all() and not res.detect_fail.any()
    assert np.array_equal(y_corr.numpy(), y)


def test_decode_stream_matches_reference():
    rng = np.random.default_rng(5)
    jc, tc = jget("wl40_r08"), tget("wl40_r08")
    y = _received(jc, rng, 70, 0.02)
    jout = list(jstream(jc, jnp.asarray(y, jnp.int32), chunk_size=32,
                        n_iters=5))
    tout = list(tstream(tc, torch.as_tensor(y), chunk_size=32, n_iters=5))
    assert [int(t[0].shape[0]) for t in tout] == [32, 32, 6]
    for jres, tres in zip(jout, tout, strict=True):
        _assert_same(jres, tres)
