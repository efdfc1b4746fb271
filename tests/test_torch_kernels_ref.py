"""Port parity: the plain PyTorch version beside each CUDA kernel against
the JAX package's Pallas kernel (run in interpret mode) and its jnp
oracle, on the same numpy inputs. Integer kernels are exact, FBP is
bitwise. On a CPU tensor every kernel wrapper runs its plain version and
counts no launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as jdecode
from repro.core import encode as jencode
from repro.core import llv as jllv
from repro.core.codes import get_code as jget
from repro.kernels import ops, ref
from repro.kernels.backend import use_policy
from repro_torch.core import encode as tencode
from repro_torch.core import llv as tllv
from repro_torch.core.codes import get_code as tget
from repro_torch.kernels import LAUNCHES, build, fbp, gf_matmul, pim_mac
from _torch_threads import torch_threads_per_worker  # noqa: F401

T = torch.as_tensor


# --------------------------------------------------------------------------
# GF(p) product and scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [3, 5, 7])
@pytest.mark.parametrize("shape", [(1, 5, 1), (37, 40, 8), (64, 160, 32),
                                   (37, 819, 205)])       # wl1024_r08's k
def test_gf_matmul_plain_matches_pallas_and_oracle(p, shape, rng):
    M, K, N = shape
    assert K * (p - 1) ** 2 < 2 ** 31
    # drifted and negative operands: the mod must floor, not truncate
    a = rng.integers(-2 * p, 2 * p, (M, K))
    b = rng.integers(0, p, (K, N))
    with use_policy("interpret"):
        want = np.asarray(ops.gf_matmul(jnp.asarray(a), jnp.asarray(b), p))
    assert np.array_equal(np.asarray(ref.gf_matmul_ref(a, b, p)), want)
    got = gf_matmul.gf_matmul_plain(T(a), T(b), p)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version, int8 operands too
    a8 = T(a, dtype=torch.int8)
    assert np.array_equal(gf_matmul.gf_matmul(a8, T(b), p).numpy(), want)


@pytest.mark.parametrize("name", ["wl40_r08", "wl160_r08", "wl160_r08_gf5"])
def test_scan_plain_matches_pallas_and_oracle(name, rng):
    code = jget(name)
    K, p = code.n, code.p
    assert K * (p - 1) ** 2 < 2 ** 31
    u = rng.integers(0, p, (96, code.k))
    y = jencode.np_encode_words(u, code)
    hit = rng.random(y.shape) < 0.01
    y[hit] += rng.choice([-1, 1], hit.sum())       # levels drift to -1, p
    ht = code.H.T
    with use_policy("interpret"):
        want = np.asarray(ops.scan_syndromes(jnp.asarray(y, jnp.int32),
                                             jnp.asarray(ht, jnp.int32), p))
    assert np.array_equal(np.asarray(ref.scan_syndromes_ref(y, ht, p)), want)
    assert 0 < want.sum() < want.size
    got = gf_matmul.scan_syndromes(T(y, dtype=torch.int8),
                                   T(ht, dtype=torch.int8), p)
    assert got.dtype == torch.bool and got.shape == (96,)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["wl40_r08", "wl160_r08_gf7"])
def test_encode_and_syndrome_match_reference(name, rng):
    jc, tc = jget(name), tget(name)
    assert jc.k * (jc.p - 1) ** 2 < 2 ** 31
    u = rng.integers(0, jc.p, (50, jc.k))
    with use_policy("interpret"):
        want = np.asarray(ops.encode_words(jnp.asarray(u), jnp.asarray(jc.P),
                                           jc.p))
    assert np.array_equal(np.asarray(ref.encode_words_ref(u, jc.P, jc.p)),
                          want)
    assert np.array_equal(jencode.np_encode_words(u, jc), want)
    got = tencode.encode_words(T(u, dtype=torch.int8), tc)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tencode.np_encode_words(u, tc), want)
    y = want.copy()
    y[::3, 1] += 1
    assert np.array_equal(
        tencode.syndrome(T(y), tc).numpy(),
        np.asarray(jencode.syndrome(jnp.asarray(y), jc)))


def test_encode_weight_matrix_matches_reference(rng):
    jc, tc = jget("wl40_r08"), tget("wl40_r08")
    W = rng.integers(-1, 2, (24, 3 * jc.k))
    want = np.asarray(jencode.encode_weight_matrix(jnp.asarray(W), jc))
    for dtype in (torch.int8, torch.int64):
        got = tencode.encode_weight_matrix(T(W, dtype=dtype), tc)
        assert got.dtype == dtype
        assert np.array_equal(got.numpy(), want)


def test_gf_wrappers_refuse_accumulator_overflow():
    big = torch.zeros((2, 2 ** 27), dtype=torch.int8)
    with pytest.raises(ValueError, match="bound"):
        gf_matmul._check_shapes("gf_matmul", big, big.T, 5)


def test_gf257_encode_syndrome_and_scan_match_reference(rng):
    """GF(257): symbols past int8. The port's encode gives codewords with
    zero exact syndromes, equal to the JAX package's on the same numpy
    words; its syndromes equal the reference's, and its scan flags exactly
    the corrupted words, as the reference's exact host scan does. All go
    through the exact route (no int8 operand)."""
    from repro.core import build_code as jbuild
    from repro.memory import MemoryController as JController
    from repro.kernels.backend import policy_from_scan_backend
    from repro_torch.core import build_code as tbuild
    from repro_torch.memory import MemoryController
    jc, tc = jbuild(64, 48, p=257, dv=4), tbuild(64, 48, p=257, dv=4)
    assert np.array_equal(jc.H, tc.H) and np.array_equal(jc.P, tc.P)
    assert gf_matmul.field_route(tc.k, tc.p) == "exact"
    u = rng.integers(0, tc.p, (8, tc.k))
    want = jencode.np_encode_words(u, jc)
    assert want.max() > 127
    for dtype in (torch.int16, torch.int64):
        got = tencode.encode_words(T(u, dtype=dtype), tc)
        assert got.dtype == dtype
        assert np.array_equal(got.numpy(), want)
    got = tencode.encode_words(T(u), tc)
    assert not tencode.syndrome(got, tc).any()
    y = want.copy()
    y[2:7, 5] = (y[2:7, 5] + 1) % tc.p
    assert np.array_equal(
        tencode.syndrome(T(y), tc).numpy(),
        np.asarray(jencode.syndrome(jnp.asarray(y), jc)))
    host = JController(policy=policy_from_scan_backend("host"),
                       use_sharded=False)
    flags = MemoryController(device="cpu")._scan(tc, T(y)).numpy()
    assert np.array_equal(flags, host._scan_syndromes(jc, y))
    assert flags.tolist() == [False, False] + [True] * 5 + [False]


def test_int8_operand_refuses_fields_past_int8():
    """GF(257) symbols do not fit int8: the kernels' operand helper and
    the code's int8 tensors raise instead of wrapping."""
    x = torch.arange(300).reshape(3, 100)
    with pytest.raises(ValueError, match="GF\\(257\\)"):
        build.int8_operand(x, 257)
    with pytest.raises(ValueError, match="GF\\(257\\)"):
        build.int8_operand(x.to(torch.int8), 257)
    assert build.int8_operand(x, 128).max() == 127
    from repro_torch.core import build_code as tbuild
    code = tbuild(64, 48, p=257, dv=4)
    with pytest.raises(ValueError, match="outside torch.int8"):
        code.tensor("H.T", "cpu", torch.int8)
    assert code.tensor("H.T", "cpu", torch.int16).max() > 127


@pytest.mark.parametrize("p,K,route", [(3, 1024, "kernel"),
                                       (127, 4096, "kernel"),
                                       (128, 131071, "kernel"),
                                       (7, 131072, "exact"),
                                       (131, 64, "exact"),
                                       (257, 8, "exact"),
                                       (65, 2 ** 21, "exact")])
def test_field_route(p, K, route):
    assert gf_matmul.field_route(K, p) == route


@pytest.mark.parametrize("flag", [True, False])
def test_exact_matmul_keeps_the_tf32_setting(flag):
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        a = torch.arange(12).reshape(3, 4)
        for bound in (10, 2 ** 30):
            got = build.exact_matmul(a, a.T, bound)
            assert torch.equal(got, a @ a.T)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# --------------------------------------------------------------------------
# PIM MAC
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R", [0, 4, 6, 16])
@pytest.mark.parametrize("adc", [0, 1, 6])
def test_pim_mac_plain_matches_pallas_and_oracle(R, adc, rng):
    B, K, N = 9, 48, 20
    x = rng.integers(-7, 8, (B, K))              # negative MAC outputs too
    w = rng.integers(-1, 2, (K, N))
    kw = dict(row_parallelism=R, adc_levels=adc)
    want = np.asarray(ref.pim_mac_ref(x, w, **kw))
    if adc != 1:
        # at adc_levels=1 (half = 0) the Pallas kernel skips the clip while
        # the oracle and core/pim.py clip every partial to 0; the port
        # follows the oracle
        with use_policy("interpret"):
            pallas = ops.pim_mac(jnp.asarray(x), jnp.asarray(w), **kw)
        assert np.array_equal(np.asarray(pallas), want)
        assert (want < 0).any()
    got = pim_mac.pim_mac(T(x, dtype=torch.int8), T(w, dtype=torch.int8),
                          **kw)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("K,R", [(48, 6), (50, 16), (45, 45), (64, 64),
                                 (144, 48), (96, 96)])
def test_pim_group_layout_keeps_the_clipped_mac(K, R, rng):
    """The kernel's operand layout (groups padded to a multiple of 32 rows,
    whole k32 steps of its s8 wgmma) leaves the clipped MAC unchanged."""
    x = T(rng.integers(-7, 8, (5, K)), dtype=torch.int8)
    w = T(rng.integers(-1, 2, (K, 7)), dtype=torch.int8)
    xl, wl, R32 = pim_mac.group_layout(x, w, R)
    assert R32 % 32 == 0 and R <= R32 < R + 32
    assert xl.shape[1] % R32 == 0 and wl.shape[0] == xl.shape[1]
    for adc in (0, 4):
        assert torch.equal(
            pim_mac.pim_mac_plain(xl, wl, row_parallelism=R32,
                                  adc_levels=adc),
            pim_mac.pim_mac_plain(x, w, row_parallelism=R, adc_levels=adc))


@pytest.mark.parametrize("K,N", [(100, 90), (128, 2560), (6, 1), (32, 17)])
def test_pim_tma_layout_keeps_the_mac(K, N, rng):
    """The kernel's tensor-copy layout (K and w's columns padded to
    multiples of 16) leaves the MAC of the first N columns unchanged."""
    x = T(rng.integers(-7, 8, (5, K)), dtype=torch.int8)
    w = T(rng.integers(-1, 2, (K, N)), dtype=torch.int8)
    xl, wl = pim_mac.tma_layout(x, w)
    assert xl.shape[1] % 16 == 0 and wl.shape[1] % 16 == 0
    assert wl.shape[0] == xl.shape[1] and wl.is_contiguous()
    if K % 16 == 0 and N % 16 == 0:
        assert xl.data_ptr() == x.data_ptr()      # aligned: no copy
    for adc in (0, 4):
        kw = dict(row_parallelism=0, adc_levels=adc)
        assert torch.equal(pim_mac.pim_mac_plain(xl, wl, **kw)[:, :N],
                           pim_mac.pim_mac_plain(x, w, **kw))


@pytest.mark.parametrize("B,N,K,unit", [
    (256, 2560, 8192, 128), (256, 2048, 2048, 128), (70, 90, 100, 128),
    (1, 1, 0, 128), (4096, 4096, 8192, 128), (33, 200, 320, 384)])
def test_pim_k_split_covers_k_in_whole_units(B, N, K, unit):
    """The kernel's K ranges: whole units that cover K, in a split no
    costlier than one range per output tile."""
    slots = 132
    kper = pim_mac.k_split(B, N, K, unit, slots)
    assert kper % unit == 0 and kper > 0
    ranges = max(1, -(-K // kper))
    assert ranges * kper >= K and (ranges - 1) * kper < max(K, 1)
    tiles = -(-B // pim_mac.TILE_M) * -(-N // pim_mac.TILE_N)
    units = max(1, -(-K // unit))
    cost = pim_mac._split_cost(tiles, units, -(-units // (kper // unit)),
                               slots)
    assert cost <= pim_mac._split_cost(tiles, units, 1, slots)


# --------------------------------------------------------------------------
# FBP
# --------------------------------------------------------------------------

def _messages(rng, N, dc, p):
    m = (rng.standard_normal((N, dc, p)) * 4).astype(np.float32)
    m -= m.max(axis=-1, keepdims=True)
    pad = rng.random((N, dc)) < 0.2                # identity-padded slots
    m[pad] = jllv.NEG_INF
    m[pad, 0] = 0.0
    return m


@pytest.mark.parametrize("p,dc", [(p, dc) for p in (2, 3, 5, 7)
                                  for dc in (1, 2, 3, 6)] + [(3, 16), (5, 16)])
def test_fbp_plain_is_bitwise_the_pallas_kernel(p, dc, rng):
    m = _messages(rng, 40, dc, p)
    with use_policy("interpret"):
        want = np.asarray(ops.fbp_cn(jnp.asarray(m), p))
    assert np.array_equal(np.asarray(ref.fbp_cn_ref(jnp.asarray(m), p)), want)
    got = fbp.fbp_cn(T(m), p)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("p", [3, 5])
def test_maxplus_conv_matches_reference(p, rng):
    a = rng.standard_normal((7, 4, p)).astype(np.float32)
    b = rng.standard_normal((7, 4, p)).astype(np.float32)
    want = np.asarray(jdecode.maxplus_conv(jnp.asarray(a), jnp.asarray(b), p))
    assert np.array_equal(fbp.maxplus_conv(T(a), T(b), p).numpy(), want)


def test_fbp_batched_layout(rng):
    m = _messages(rng, 6 * 5, 4, 3).reshape(6, 5, 4, 3)
    out = fbp.fbp_cn_batched(T(m), 3)
    assert torch.equal(out.reshape(30, 4, 3), fbp.fbp_cn(T(m).reshape(30, 4, 3),
                                                          3))


# --------------------------------------------------------------------------
# LLV init and reinterpretation (the signed-% hazard)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("mode", ["manhattan", "gaussian"])
def test_llv_matches_reference(p, mode, rng):
    y = rng.integers(-3 * p, 3 * p, (6, 11))
    want = np.asarray(jllv.init_llv(jnp.asarray(y), p, mode=mode))
    got = tllv.init_llv(T(y), p, mode=mode)
    assert np.array_equal(got.numpy(), want)
    yf = (rng.standard_normal((6, 11)) * 5).astype(np.float32)
    assert np.array_equal(
        tllv.circular_distance(T(yf), p).numpy(),
        np.asarray(jllv.circular_distance(jnp.asarray(yf), p)))
    dec = rng.integers(0, p, y.shape)
    assert np.array_equal(
        tllv.reinterpret(T(y), T(dec), p).numpy(),
        np.asarray(jllv.reinterpret(jnp.asarray(y), jnp.asarray(dec), p)))


def test_cpu_wrappers_count_no_launch():
    before = dict(LAUNCHES)
    x = torch.zeros((4, 8), dtype=torch.int8)
    gf_matmul.gf_matmul(x, x.T.contiguous(), 3)
    gf_matmul.scan_syndromes(x, x.T.contiguous(), 3)
    pim_mac.pim_mac(x, x.T.contiguous())
    fbp.fbp_cn(torch.zeros((2, 3, 3)), 3)
    assert dict(LAUNCHES) == before


def test_route_refuses_mixed_devices():
    a = torch.zeros(2, 2)
    b = torch.zeros(2, 2, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        build.route("gf_matmul", a, b)
    with pytest.raises(ValueError, match="no kernel"):
        build.route("gf_matmul", b)
