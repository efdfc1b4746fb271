"""Port parity: code construction and GF(p) helpers of `repro_torch`
against the JAX package, and the array carry-across of `convert`."""
import numpy as np
import pytest
import torch

from repro.core import codes as jcodes
from repro.core import gf as jgf
from repro_torch.convert import CODE_FIELDS, code_from_arrays
from repro_torch.core import codes as tcodes
from repro_torch.core import gf as tgf
from _torch_threads import torch_threads_per_worker  # noqa: F401

SMALL = ["wl32_r08", "wl40_r08", "wl64_r08", "wl80_r08", "wl128_r08",
         "wl160_r08", "wl160_r08_gf5", "wl160_r08_gf7", "wl256_r08",
         "chip256_r08", "wl320_r08"]


def test_registry_is_the_reference_registry():
    assert tcodes.REGISTRY == jcodes.REGISTRY


@pytest.mark.parametrize("name", SMALL)
def test_construction_matches_reference(name):
    jc, tc = jcodes.get_code(name), tcodes.get_code(name)
    for f in CODE_FIELDS:
        a, b = getattr(jc, f), getattr(tc, f)
        assert np.array_equal(a, b), f
        assert np.asarray(a).dtype == np.asarray(b).dtype, f


@pytest.mark.parametrize("name", ["wl40_r08", "wl160_r08_gf5"])
def test_vn_edge_table_matches_reference(name):
    from repro.core.decode import _vn_edge_table
    jc, tc = jcodes.get_code(name), tcodes.get_code(name)
    assert np.array_equal(_vn_edge_table(jc), tc.vn_edges)


@pytest.mark.parametrize("name", ["wl40_r08", "wl160_r08", "wl160_r08_gf7"])
def test_code_from_arrays_round_trips(name):
    jc = jcodes.get_code(name)
    tc = code_from_arrays({f: getattr(jc, f) for f in CODE_FIELDS})
    for f in CODE_FIELDS:
        assert np.array_equal(getattr(tc, f), getattr(jc, f)), f
    assert tc.c == jc.c and tc.n_edges == jc.n_edges


def test_code_from_arrays_rejects_bad_input():
    jc = jcodes.get_code("wl40_r08")
    d = {f: getattr(jc, f) for f in CODE_FIELDS}
    with pytest.raises(KeyError, match="lack"):
        code_from_arrays({k: v for k, v in d.items() if k != "H"})
    with pytest.raises(ValueError, match="do not fit"):
        code_from_arrays({**d, "k": d["k"] - 1})


def test_code_tensor_cache_and_transpose():
    tc = tcodes.get_code("wl40_r08")
    ht = tc.tensor("H.T", "cpu", torch.int8)
    assert ht.dtype == torch.int8 and ht.is_contiguous()
    assert np.array_equal(ht.numpy(), tc.H.T)
    assert tc.tensor("H.T", "cpu", torch.int8) is ht


@pytest.mark.parametrize("p", [2, 3, 5, 7])
def test_gf_tables_match_reference(p):
    assert np.array_equal(tgf.mul_table(p), jgf.mul_table(p))
    assert np.array_equal(tgf.inv_table(p), jgf.inv_table(p))


@pytest.mark.parametrize("p", [3, 5, 7])
def test_centered_lift_torch_matches_reference(p):
    k = np.arange(-2 * p, 2 * p)
    ref = np.asarray(jgf.centered_lift(k, p))
    assert np.array_equal(tgf.centered_lift(torch.as_tensor(k), p).numpy(),
                          ref)
    assert np.array_equal(tgf.centered_lift(k, p), ref)


def test_gf_linear_algebra_matches_reference(rng):
    p = 5
    A = rng.integers(0, p, (6, 6))
    while jgf.gf_rank(A, p) < 6:
        A = rng.integers(0, p, (6, 6))
    assert np.array_equal(tgf.gf_mat_inv(A, p), jgf.gf_mat_inv(A, p))
    r1, piv1 = tgf.gf_rref(A[:4], p)
    r2, piv2 = jgf.gf_rref(A[:4], p)
    assert np.array_equal(r1, r2) and piv1 == piv2
