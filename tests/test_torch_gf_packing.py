"""Port parity: the GF(p) element helpers of `core.gf` (`gf_add`,
`gf_sub`, `gf_mul`, `gf_neg`, `perm_table`, `to_field`) and the host byte
packing of `memory.packing` (`symbolize_bytes`, `desymbolize_bytes`,
exported from `repro_torch.memory`) exactly against the JAX package's, on
ints, numpy arrays and torch tensors drawn from numpy and hypothesis
seeds (`tests/_hyp.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import gf as jgf
from repro.core.codes import REGISTRY
from repro.memory import desymbolize_bytes as jdesymbolize_bytes
from repro.memory import symbolize_bytes as jsymbolize_bytes
from repro_torch import memory
from repro_torch.core import gf as tgf
from repro_torch.memory import packing
from _torch_threads import torch_threads_per_worker  # noqa: F401

PRIMES = [2, 3, 5, 7, 11, 257]
ALPHABETS = sorted({p for (_n, _k, p, _dv) in REGISTRY.values()})
BINARY = ("gf_add", "gf_sub", "gf_mul")


@given(st.sampled_from(PRIMES), st.integers(-300, 300),
       st.integers(-300, 300))
@settings(max_examples=60, deadline=None)
def test_gf_element_ops_on_ints_match_reference(p, a, b):
    for name in BINARY:
        assert getattr(tgf, name)(a, b, p) == getattr(jgf, name)(a, b, p)
    assert tgf.gf_neg(a, p) == jgf.gf_neg(a, p)
    assert tgf.to_field(a, p) == jgf.to_field(a, p)


@pytest.mark.parametrize("p", PRIMES)
@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=10**6))
def test_gf_element_ops_on_arrays_match_reference(p, seed):
    """numpy arrays and torch tensors (int64 and int32) against the JAX
    functions on jax arrays: equal elements, the field's range."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-5 * p, 5 * p, (7, 5))
    b = rng.integers(-5 * p, 5 * p, (7, 5))
    for name in BINARY:
        want = np.asarray(getattr(jgf, name)(jnp.asarray(a), jnp.asarray(b),
                                             p))
        assert np.array_equal(getattr(tgf, name)(a, b, p), want)
        for dt in (torch.int64, torch.int32):
            got = getattr(tgf, name)(torch.as_tensor(a, dtype=dt),
                                     torch.as_tensor(b, dtype=dt), p)
            assert got.dtype == dt and np.array_equal(got.numpy(), want)
    for name in ("gf_neg", "to_field"):
        want = np.asarray(getattr(jgf, name)(jnp.asarray(a), p))
        assert np.array_equal(getattr(tgf, name)(a, p), want)
        got = getattr(tgf, name)(torch.as_tensor(a), p)
        assert np.array_equal(got.numpy(), want)
        assert want.min() >= 0 and want.max() < p


@pytest.mark.parametrize("p", [2, 3, 5, 7, 11, 127])
def test_perm_table_matches_reference(p):
    got, want = tgf.perm_table(p), jgf.perm_table(p)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    for h in range(1, p):                   # each row a permutation
        assert sorted(got[h].tolist()) == list(range(p))


def test_helpers_are_exported():
    for name in ("gf_add", "gf_sub", "gf_mul", "gf_neg", "perm_table",
                 "to_field"):
        assert name in tgf.__all__ and name in jgf.__all__
    for name in ("symbolize_bytes", "desymbolize_bytes"):
        assert getattr(memory, name) is getattr(packing, name)
        assert name in memory.__all__ and name in packing.__all__


@pytest.mark.parametrize("p", ALPHABETS)
@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=10**6))
def test_symbolize_bytes_matches_reference(p, seed):
    """bytes and uint8 arrays -> the JAX package's digits exactly, and
    back to the same bytes."""
    rng = np.random.default_rng(seed)
    nbytes = int(rng.integers(0, 300))
    arr = rng.integers(0, 256, nbytes, dtype=np.uint8)
    raw = arr.tobytes()
    want = jsymbolize_bytes(raw, p)
    for src in (raw, arr):
        got = memory.symbolize_bytes(src, p)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert memory.desymbolize_bytes(want, nbytes, p) == \
        jdesymbolize_bytes(want, nbytes, p) == raw
    # the host digits are the device pair's (`symbolize_u8`)
    dev = packing.symbolize_u8(torch.as_tensor(arr), p)
    assert np.array_equal(dev.numpy().reshape(-1), want)


@pytest.mark.parametrize("p", ALPHABETS)
@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=10**6))
def test_desymbolize_bytes_degrades_as_reference(p, seed):
    """Digits outside the field (uncorrected symbols) and a stream longer
    than the bytes asked for: the JAX package's bytes exactly."""
    rng = np.random.default_rng(seed)
    D = packing.digits_per_byte(p)
    nbytes = int(rng.integers(0, 200))
    junk = rng.integers(-3, p + 4, (nbytes + 3) * D)
    got = memory.desymbolize_bytes(junk, nbytes, p)
    assert got == jdesymbolize_bytes(junk, nbytes, p)
    assert len(got) == nbytes
