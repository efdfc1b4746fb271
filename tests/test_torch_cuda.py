"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same inputs (exact for the integer kernels, bitwise for
FBP, a few bf16 ulps for attend_protected and the flash forward, 5e-3 of
the largest gradient for the flash backward), the launch counters, and
the decoder, a small protected-KV decode and two reduced training steps
on the card against their CPU runs. The wgmma flash kernels also at the
edges of their tiles, bitwise repeatable, with HGMMA in their SASS, and
beside a bf16-P control that shows their split P is needed; the s8 wgmma
PIM MAC exactly at the PIM shape and at its edges, with IGMMA in its SASS;
the s8 wgmma encode exactly at ragged shapes, every field, the int32 edge,
unaligned words and every tile and grid, with IGMMA in its SASS; FBP at
every field and dc, ragged row blocks, both strides and bitwise
repeatable; GF(257) operands refused by the int8 kernels and flagged
exactly on the exact route; the runtime sanitizer on CUDA tensors,
`span(sync=...)` waiting for the card, and the RAS estimator and the tiny
engine's telemetry fed from the card as from the CPU; `attend_protected`
at head dim 128, an MoE layer's routing, dispatch and combine (bitwise
repeatable) and the mamba scan on the card against the CPU (and bitwise
the same with TF32 allowed); a data-parallel (FSDP) step over two shards,
on one card or on two, against the unsharded trainer; a tensor-parallel
step over a (1, 4) mesh on one card against the unsharded trainer and
the same mesh on the CPU, its flash launches carrying each position's
heads.
Marked
`cuda`: skipped without a GPU. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import decode_integers, get_code, np_encode_words
from repro_torch.kernels import LAUNCHES, fbp, gf_matmul, pim_mac

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [
    (1, 1, 1), (67, 130, 5), (300, 1024, 205),
    # the decoder's check (at most 256 words) and a ragged tail of it; a
    # page of the paged store (wl160_r08, 1,536 words); n = 40 (K not a
    # multiple of 16); C = 343 (wl512_r033, past one 256-check tile)
    (256, 1024, 205), (67, 1024, 205), (1536, 160, 32), (300, 40, 8),
    (300, 512, 343)])
@pytest.mark.parametrize("p", [2, 3, 5, 7])
def test_gf_kernels_match_plain(dev, shape, p, rng):
    M, K, N = shape
    a = torch.as_tensor(rng.integers(-3, p + 3, (M, K)), dtype=torch.int8,
                        device=dev)
    b = torch.as_tensor(rng.integers(0, p, (K, N)), dtype=torch.int8,
                        device=dev)
    n0 = LAUNCHES["gf_matmul"], LAUNCHES["scan_syndromes"]
    assert torch.equal(gf_matmul.gf_matmul(a, b, p),
                       gf_matmul.gf_matmul_plain(a, b, p))
    assert torch.equal(gf_matmul.scan_syndromes(a, b, p),
                       gf_matmul.scan_syndromes_plain(a, b, p))
    assert (LAUNCHES["gf_matmul"], LAUNCHES["scan_syndromes"]) == \
        (n0[0] + 1, n0[1] + 1)


SCAN_CODES = [
    # code, words, share of words with one corrupted cell
    ("wl1024_r08", 256, 0.1), ("wl1024_r08", 67, 0.1),
    ("wl1024_r08", 4096, 0.1), ("wl160_r08", 1536, 0.01),
    ("wl40_r08", 300, 0.2), ("wl512_r033", 300, 0.2),
    ("wl160_r08_gf5", 500, 0.2), ("wl160_r08_gf7", 500, 0.2),
    ("wl32_r08", 1, 1.0)]


@pytest.mark.parametrize("name,words,share", SCAN_CODES)
def test_scan_flags_exactly_the_corrupted_words(dev, name, words, share,
                                                rng):
    """Stored codewords of each code shape the paths scan, some corrupted
    in one cell, through the code's own cached Hᵀ: the kernel flags
    exactly the corrupted words and equals its plain version."""
    code = get_code(name)
    y = np_encode_words(rng.integers(0, code.p, (words, code.k)), code)
    bad = rng.random(words) < share
    cols = rng.integers(0, code.n, words)
    y[bad, cols[bad]] = (y[bad, cols[bad]] + 1) % code.p
    y = torch.as_tensor(y, dtype=torch.int8, device=dev)
    ht = code.tensor("H.T", dev, torch.int8)
    n0 = LAUNCHES["scan_syndromes"]
    got = gf_matmul.scan_syndromes(y, ht, code.p)
    assert LAUNCHES["scan_syndromes"] == n0 + 1
    assert got.cpu().tolist() == bad.tolist()
    assert torch.equal(got, gf_matmul.scan_syndromes_plain(y, ht, code.p))
    # the K-major H is built once per Hᵀ tensor
    assert gf_matmul.kmajor_h(ht, code.p) is gf_matmul.kmajor_h(ht, code.p)


@pytest.mark.parametrize("tile", gf_matmul.SCAN_TILES)
@pytest.mark.parametrize("grid", [1, 3, 1000])
@pytest.mark.parametrize("p", [2, 127])
@pytest.mark.parametrize("chunked", [False, True])
def test_scan_tiles_and_grids_match_plain(dev, tile, grid, p, chunked, rng):
    """Every check tile of the scan kernel, with one persistent CTA
    walking every tile, a few, or one a tile: ragged words, checks within
    one tile (each CTA stores its flags) or past it (the flags are zeroed
    and each chunk stores its ones), K not a whole stage, words over the
    whole int8 range."""
    M, K, C = 390, 300, 261 if chunked else tile - 3
    y = torch.as_tensor(rng.integers(-128, 128, (M, K)), dtype=torch.int8,
                        device=dev)
    ht = torch.as_tensor(rng.integers(0, p, (K, C)), dtype=torch.int8,
                         device=dev)
    y[::3] = 0                                   # some rows divisible
    got = gf_matmul.scan_launch(y, gf_matmul.kmajor_h(ht, p), p, tile, grid)
    assert torch.equal(got, gf_matmul.scan_syndromes_plain(y, ht, p))


@pytest.mark.parametrize("N", [1, 32, 205, 343])
@pytest.mark.parametrize("K", [1, 40, 130, 819])
@pytest.mark.parametrize("M", [1, 67, 4096])
def test_gf_matmul_matches_plain_at_ragged_shapes(dev, M, K, N, rng):
    """The encode kernel at one word, a ragged tile and a 4096-word page,
    K from one byte to wl1024_r08's k (rows 819 bytes apart, no multiple
    of 16), N from one column to past one tile (wl512_r033's 343):
    exactly the plain version, one launch."""
    p = 7
    a = torch.as_tensor(rng.integers(-3, p + 3, (M, K)), dtype=torch.int8,
                        device=dev)
    b = torch.as_tensor(rng.integers(0, p, (K, N)), dtype=torch.int8,
                        device=dev)
    n0 = LAUNCHES["gf_matmul"]
    got = gf_matmul.gf_matmul(a, b, p)
    assert LAUNCHES["gf_matmul"] == n0 + 1
    assert torch.equal(got, gf_matmul.gf_matmul_plain(a, b, p))


@pytest.mark.parametrize("p", [2, 3, 5, 7, 127])
@pytest.mark.parametrize("offset", [0, 3])
def test_gf_matmul_fields_and_unaligned_words(dev, p, offset, rng):
    """Operands in [-3, p + 3) (the floored mod of negative sums) at each
    field, with the words an offset view whose rows start at no 16-byte
    boundary."""
    M, K, N = 300, 819, 205
    flat = torch.as_tensor(rng.integers(-3, p + 3, M * K + offset),
                           dtype=torch.int8, device=dev)
    a = flat[offset:].view(M, K)
    assert a.is_contiguous() and a.data_ptr() % 16 == offset % 16
    b = torch.as_tensor(rng.integers(-3, p + 3, (K, N)), dtype=torch.int8,
                        device=dev)
    assert torch.equal(gf_matmul.gf_matmul(a, b, p),
                       gf_matmul.gf_matmul_plain(a, b, p))


def test_gf_matmul_at_the_int32_edge(dev, rng):
    """K near INT8_K_MAX with every word -128 and every entry p - 1 = 126
    (sums near -2^31) and some rows over the whole int8 range: the floored
    residues stay exact."""
    p, K = 127, gf_matmul.INT8_K_MAX - 5
    a = torch.full((20, K), -128, dtype=torch.int8, device=dev)
    a[1::2, :7] = torch.as_tensor(rng.integers(-128, 128, (10, 7)),
                                  dtype=torch.int8, device=dev)
    b = torch.full((K, 10), p - 1, dtype=torch.int8, device=dev)
    b[:, 3] = 0
    b[:5, 4] = -128
    assert torch.equal(gf_matmul.gf_matmul(a, b, p),
                       gf_matmul.gf_matmul_plain(a, b, p))


@pytest.mark.parametrize("tile", gf_matmul.GF_TILES)
@pytest.mark.parametrize("grid", [1, 3, 1000])
@pytest.mark.parametrize("chunked", [False, True])
def test_gf_matmul_tiles_and_grids_match_plain(dev, tile, grid, chunked,
                                               rng):
    """Every column tile of the encode kernel, with one persistent CTA
    walking every tile, a few, or one a tile: ragged words, columns within
    one tile (stored through shared memory) or past it (stored directly),
    K not a whole stage, words over the whole int8 range."""
    p = 127
    M, K, N = 390, 300, 261 if chunked else tile - 3
    a = torch.as_tensor(rng.integers(-128, 128, (M, K)), dtype=torch.int8,
                        device=dev)
    b = torch.as_tensor(rng.integers(0, p, (K, N)), dtype=torch.int8,
                        device=dev)
    got = gf_matmul.gf_launch(a, gf_matmul.kmajor_h(b, p), p, tile, grid)
    assert torch.equal(got, gf_matmul.gf_matmul_plain(a, b, p))


def test_scan_at_the_int32_edge(dev, rng):
    """K near INT8_K_MAX with every word -128 and every check entry
    p - 1 = 126: sums near -2^31, divisibility still exact."""
    p, K = 127, gf_matmul.INT8_K_MAX - 5
    y = torch.full((20, K), -128, dtype=torch.int8, device=dev)
    y[1::2, :7] = torch.as_tensor(rng.integers(-128, 128, (10, 7)),
                                  dtype=torch.int8, device=dev)
    ht = torch.full((K, 10), p - 1, dtype=torch.int8, device=dev)
    ht[:, 3] = 0
    got = gf_matmul.scan_syndromes(y, ht, p)
    assert torch.equal(got, gf_matmul.scan_syndromes_plain(y, ht, p))


@pytest.mark.parametrize("M,K,N,R,adc,full", [
    (70, 100, 90, 0, 0, False), (70, 256, 90, 64, 6, False),
    (70, 90, 90, 6, 1, False), (70, 128, 90, 16, 4, False),
    # the PIM shape (paper-pim-2b mlp_down over 256 rows, R 64)
    (256, 8192, 2560, 64, 0, False), (256, 8192, 2560, 64, 6, False),
    # groups that are not whole k32 steps, ragged M and N
    (33, 300, 200, 6, 6, False), (65, 512, 129, 16, 2, False),
    (130, 480, 257, 48, 6, False), (1, 96, 1, 48, 4, False),
    # x and w over the whole int8 range at K near INT8_K_MAX
    (80, pim_mac.INT8_K_MAX - 3, 40, 0, 0, True),
    (20, 63 * 2048 - 5, 24, 2048, 200, True)])
def test_pim_mac_kernel_matches_plain(dev, M, K, N, R, adc, full, rng):
    """The s8 wgmma MAC equals its plain version exactly, with and
    without the clip, at the PIM shape (where the wrapper splits K over
    the grid), with groups padded to whole k32 steps, at ragged edges and
    at the int32 accumulator's edge."""
    lo, hi = (-128, 128) if full else (-7, 8)
    x = torch.as_tensor(rng.integers(lo, hi, (M, K)), dtype=torch.int8,
                        device=dev)
    lo, hi = (-128, 128) if full else (-1, 2)
    w = torch.as_tensor(rng.integers(lo, hi, (K, N)), dtype=torch.int8,
                        device=dev)
    kw = dict(row_parallelism=R, adc_levels=adc)
    n0 = LAUNCHES["pim_mac"]
    got = pim_mac.pim_mac(x, w, **kw)
    assert LAUNCHES["pim_mac"] == n0 + 1
    assert torch.equal(got, pim_mac.pim_mac_plain(x, w, **kw))


@pytest.mark.parametrize("p", [2, 3, 5, 7])
@pytest.mark.parametrize("dc", [1, 2, 5, 16, 26, 32])
def test_fbp_kernel_is_bitwise_plain(dev, p, dc, rng):
    m = (rng.standard_normal((1000, dc, p)) * 4).astype(np.float32)
    m -= m.max(axis=-1, keepdims=True)
    m = torch.as_tensor(m, device=dev)
    got, want = fbp.fbp_cn(m, p), fbp.fbp_cn_plain(m, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("p,dc", [(2, 1), (3, 5), (3, 16), (5, 26),
                                  (7, 31), (7, 32)])
@pytest.mark.parametrize("N", [1, 3, 117, 52_481])
def test_fbp_kernel_ragged_blocks_and_repeatable(dev, p, dc, N, rng):
    """One row, rows under one 16-byte word, a block and one row more (the
    ragged last block's words past its last whole 16 bytes), and many
    blocks a CTA, at even and odd row widths: bitwise the plain version,
    and two calls bitwise equal."""
    m = (rng.standard_normal((N, dc, p)) * 4).astype(np.float32)
    m -= m.max(axis=-1, keepdims=True)
    m = torch.as_tensor(m, device=dev)
    n0 = LAUNCHES["fbp_cn"]
    got, again = fbp.fbp_cn(m, p), fbp.fbp_cn(m, p)
    assert LAUNCHES["fbp_cn"] == n0 + 2
    want = fbp.fbp_cn_plain(m, p).view(torch.int32)
    assert torch.equal(got.view(torch.int32), want)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


def test_decode_on_card_matches_cpu(dev, rng):
    code = get_code("wl160_r08")
    y = np_encode_words(rng.integers(0, 3, (300, code.k)), code)
    hit = rng.random(y.shape) < 0.02
    y[hit] += rng.choice([-1, 1], hit.sum())
    kw = dict(n_iters=8, damping=0.3, early_exit=True)
    cpu = decode_integers(code, y, device="cpu", **kw)
    gpu = decode_integers(code, y, device=dev, **kw)
    assert torch.equal(cpu[0], gpu[0].cpu())
    for a, b in zip(cpu[1], gpu[1], strict=True):
        assert torch.equal(a, b.cpu())


def test_gf_kernels_refuse_fields_past_int8(dev, rng):
    """GF(257) symbols on the card: the kernel wrappers raise instead of
    wrapping them through int8, and the routed exact path (the controller's
    scan, the encode) flags exactly the corrupted words."""
    from repro_torch.core import build_code, encode_words
    from repro_torch.memory import MemoryController
    code = build_code(64, 48, p=257, dv=4)
    u = torch.as_tensor(rng.integers(0, code.p, (8, code.k)), device=dev)
    n0 = dict(LAUNCHES)
    enc = encode_words(u, code)
    with pytest.raises(ValueError, match="GF\\(257\\)"):
        gf_matmul.gf_matmul(u, code.tensor("P", dev, torch.int16), code.p)
    with pytest.raises(ValueError, match="GF\\(257\\)"):
        gf_matmul.scan_syndromes(enc.to(torch.int16),
                                 code.tensor("H.T", dev, torch.int16), code.p)
    ctl = MemoryController(device=dev)
    assert ctl._scan_route(code) == "exact"
    assert not ctl._scan(code, enc).any()
    enc[2:5, 7] = (enc[2:5, 7] + 1) % code.p
    assert ctl._scan(code, enc).cpu().tolist() == [False] * 2 + [True] * 3 \
        + [False] * 3
    assert dict(LAUNCHES) == n0           # no kernel took a GF(257) operand


def test_kernel_wrappers_refuse_wrong_inputs(dev):
    x = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int8"):
        pim_mac.pim_mac(x, x.T)
    with pytest.raises(TypeError, match="float32"):
        fbp.fbp_cn(torch.zeros((2, 3, 3), dtype=torch.float64, device=dev), 3)
    with pytest.raises(ValueError, match="p=11"):
        fbp.fbp_cn(torch.zeros((2, 3, 11), device=dev), 11)


# ---------------------------------------------------------------------------
# attend_protected: the CUDA kernel against its plain version to a few
# bf16 ulps (rtol 2^-7, atol 2^-10): the kernel rounds K/V and the logits
# to bf16 where the plain version does and sums in fp32 in another order
# ---------------------------------------------------------------------------

ULP = dict(rtol=2 ** -7, atol=2 ** -10)


def _attend_operands(dev, *, B, Sq, Hq, Hkv, D, T, NP, S, code_name, seed,
                     ragged=False):
    from repro_torch.memory.paged import quantize_tensor, words_for_tensor
    from repro_torch.core import encode_words
    code = get_code(code_name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bsub = B // S
    page_shape = (bsub, T, Hkv, D)
    W = words_for_tensor(page_shape, code.p, code.k)
    pages = torch.zeros((2, NP, S, W, code.n), dtype=torch.int8, device=dev)
    scales = torch.zeros((2, NP, S), device=dev)
    for c in range(2):
        for j in range(NP):
            for s in range(S):
                x = torch.randn(page_shape, generator=gen, device=dev) * 2
                words, meta = quantize_tensor(x.to(torch.bfloat16), code.p,
                                              code.k)
                pages[c, j, s] = encode_words(words, code)
                scales[c, j, s] = meta.scale
    if ragged:
        valid = torch.randint(0, T + 1, (NP, B), generator=gen, device=dev,
                              dtype=torch.int32)
        hot_valid = torch.randint(1, T + 1, (B,), generator=gen, device=dev,
                                  dtype=torch.int32)
    else:
        valid = torch.full((NP, B), T, dtype=torch.int32, device=dev)
        hot_valid = torch.full((B,), T // 2, dtype=torch.int32, device=dev)
    bf = dict(device=dev, generator=gen)
    q = torch.randn((B, Sq, Hq, D), **bf).to(torch.bfloat16)
    hot = [torch.randn((B, T, Hkv, D), **bf).to(torch.bfloat16)
           for _ in range(2)]
    args = (q, pages[0].contiguous(), pages[1].contiguous(),
            scales[0].contiguous(), scales[1].contiguous(), valid, *hot,
            hot_valid)
    return args, dict(p=code.p, k_info=code.k, page_shape=page_shape)


ATTEND_SHAPES = [
    # the serving shape (paper-pim-2b, wl160_r08, 16-token pages), small NP
    dict(B=4, Sq=1, Hq=32, Hkv=8, D=64, T=16, NP=3, S=1),
    dict(B=3, Sq=1, Hq=4, Hkv=2, D=8, T=4, NP=5, S=3, ragged=True),  # S=B
    dict(B=2, Sq=3, Hq=8, Hkv=2, D=32, T=8, NP=2, S=1, ragged=True),
    # a query block that needs more than 48 KB of shared memory
    dict(B=1, Sq=4, Hq=64, Hkv=1, D=64, T=16, NP=2, S=1),
]
HOT_ONLY = dict(B=4, Sq=1, Hq=32, Hkv=8, D=64, T=16, NP=0, S=1)


@pytest.mark.parametrize("shape,softcap,with_hot", [
    # a cap of 2 bites on logits of about N(0, 1); 50 barely does
    *((shape, cap, True) for shape in ATTEND_SHAPES
      for cap in (0.0, 50.0, 2.0)),
    *((shape, 0.0, False) for shape in ATTEND_SHAPES),   # right after a freeze
    (HOT_ONLY, 0.0, True), (HOT_ONLY, 50.0, True)])
def test_attend_protected_kernel_matches_plain(dev, shape, softcap,
                                               with_hot):
    from repro_torch.kernels import paged_attention as pa
    args, kw = _attend_operands(dev, code_name="wl160_r08", seed=3, **shape)
    kw.update(softcap=softcap, with_hot=with_hot)
    n0 = LAUNCHES["attend_protected"]
    got = pa.attend_protected(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["attend_protected"] == n0 + 1
    want = pa.attend_protected_plain(*args, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    torch.testing.assert_close(got.float(), want.float(), **ULP)


def _split_operands(dev, NP, *, empty_rows=False, seed=4):
    """The serving shape with NP pages; with `empty_rows`, row 0 has no
    valid token in its first half of pages, row 1 in none of them, and
    row 2 in none of them nor in the hot page."""
    from repro_torch.kernels import paged_attention as pa
    shape = dict(B=4, Sq=1, Hq=32, Hkv=8, D=64, T=16, NP=NP, S=1)
    args, kw = _attend_operands(dev, code_name="wl160_r08", seed=seed,
                                ragged=True, **shape)
    if empty_rows:
        valid, hot_valid = args[5].clone(), args[8].clone()
        valid[:NP // 2, 0] = 0
        valid[:, 1:3] = 0
        hot_valid[2] = 0
        args = (*args[:5], valid, *args[6:8], hot_valid)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return args, kw, pa.attend_plan(NP, 4 * 8, 16, sms)


@pytest.mark.parametrize("NP,empty_rows,with_hot", [
    (1, False, True), (40, False, True), (40, True, True),
    (40, True, False), (41, False, True), (256, False, True)])
def test_attend_protected_page_splits(dev, NP, empty_rows, with_hot):
    """The split-page kernel at one page, over several ranges, at a page
    count whose last range is short (41), at a long context (256 pages,
    4,096 tokens), and with rows that have no valid token in some ranges
    or in all of them (and, without the hot page, none at all)."""
    from repro_torch.kernels import paged_attention as pa
    args, kw, (pg, rp, nsplit) = _split_operands(dev, NP,
                                                 empty_rows=empty_rows)
    if NP >= 40:
        assert 1 < nsplit
    if NP == 41:                         # ranges of unequal page counts
        assert NP % rp
    kw.update(with_hot=with_hot)
    got = pa.attend_protected(*args, **kw)
    want = pa.attend_protected_plain(*args, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **ULP)


def test_attend_protected_is_bitwise_repeatable(dev):
    """Two calls on the same inputs give the same bits: the page ranges
    merge in a fixed order, without atomics."""
    from repro_torch.kernels import paged_attention as pa
    args, kw, _ = _split_operands(dev, 40, empty_rows=True)
    a = pa.attend_protected(*args, **kw)
    b = pa.attend_protected(*args, **kw)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_attend_protected_degrades_on_uncorrected_cells(dev):
    """Cells out of the field (an uncorrectable word read raw) are clipped
    like the plain version clips them, never read out of range."""
    from repro_torch.kernels import paged_attention as pa
    args, kw = _attend_operands(dev, B=2, Sq=1, Hq=4, Hkv=2, D=8, T=4,
                                NP=2, S=1, code_name="wl40_r08", seed=1)
    kp = args[1].clone()
    flat = kp.view(-1)
    idx = torch.arange(0, flat.numel(), 7, device=dev)
    flat[idx] = torch.randint(-128, 128, (idx.numel(),), device=dev,
                              dtype=torch.int8)
    args = (args[0], kp, *args[2:])
    torch.testing.assert_close(pa.attend_protected(*args, **kw).float(),
                               pa.attend_protected_plain(*args, **kw).float(),
                               **ULP)


def test_attend_protected_refuses_wrong_inputs(dev):
    from repro_torch.kernels import paged_attention as pa
    args, kw = _attend_operands(dev, B=2, Sq=1, Hq=4, Hkv=2, D=8, T=4,
                                NP=1, S=1, code_name="wl40_r08", seed=2)
    q, kp, vp, ks, vs, valid, hk, hv, hval = args
    with pytest.raises(TypeError, match="int8"):
        pa.attend_protected(q, kp.to(torch.int32), vp.to(torch.int32), ks,
                            vs, valid, hk, hv, hval, **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        pa.attend_protected(q.float(), kp, vp, ks, vs, valid, hk, hv, hval,
                            **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pa.attend_protected(q.transpose(2, 3).contiguous().transpose(2, 3),
                            kp, vp, ks, vs, valid, hk, hv, hval, **kw)
    with pytest.raises(ValueError, match="several devices"):
        pa.attend_protected(q.cpu(), kp, vp, ks, vs, valid, hk, hv, hval,
                            **kw)
    with pytest.raises(ValueError, match="at least one KV page"):
        pa.attend_protected(q, kp[:0], vp[:0], ks[:0], vs[:0], valid[:0],
                            hk, hv, hval, **kw, with_hot=False)


def test_protected_decode_on_card_matches_cpu(dev):
    """A small protected prefill + decode on the card, through the
    kernels, against the same model's plain CPU run: the same tokens'
    logits (of magnitude 0.1 to 1) agree to a few bf16 ulps and every
    decode step launches attend_protected once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import (ProtectedKVConfig, decode_step,
                                    init_params, prefill)
    cfg = get_config("paper_pim").reduced(n_groups=2, d_model=64,
                                          n_heads=4, n_kv_heads=2, d_ff=128)
    cpu_params = init_params(cfg, 0, device="cpu")
    gpu_params = init_params(cfg, 0, device="cpu").to(dev)
    pkv = ProtectedKVConfig(code_name="wl160_r08", page_tokens=4)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 9)))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (5, 2, 1)))
    outs = []
    for params in (cpu_params, gpu_params):
        d = params.device
        _, caches = prefill(params, cfg, prompt.to(d), protected_kv=pkv)
        steps = []
        for i in range(5):
            n0 = LAUNCHES["attend_protected"]
            lg, caches = decode_step(params, cfg, caches, toks[i].to(d),
                                     9 + i)
            if d.type == "cuda":
                assert LAUNCHES["attend_protected"] == n0 + cfg.n_groups
            steps.append(lg.cpu())
        outs.append(torch.cat(steps, dim=1))
    torch.testing.assert_close(outs[1], outs[0], **ULP)



def _small_layer(device, **knobs):
    """A protected layer on `device` holding two frozen pages and a
    part-full hot page of fixed K/V."""
    from repro_torch.models import ProtectedKVConfig, ProtectedKVLayer
    pkv = ProtectedKVConfig(code_name="wl40_r08", page_tokens=4, **knobs)
    layer = ProtectedKVLayer(pkv, 2, 2, 8, device=device)
    x = torch.randn((2, 10, 2, 8), generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    layer.append(x.to(device), (x * 0.5).to(device))
    return layer


def test_raw_read_on_card_goes_through_the_kernel(dev):
    """The uncorrected ablation reads the raw corrupted cells through
    attend_protected (one launch, no decode) and agrees with the raw read
    of the same cells on the CPU; the streaming plain read refuses card
    tensors."""
    import dataclasses
    from repro_torch.memory import uniform_flip
    q = torch.randn((2, 1, 4, 8), generator=torch.Generator().manual_seed(1))
    q = q.to(torch.bfloat16)
    card = _small_layer(dev, corrected=False)
    card.inject(uniform_flip(3, 0.05), key=0)
    n0 = dict(LAUNCHES)
    got = card.attend(q.to(dev))
    assert LAUNCHES["attend_protected"] == n0["attend_protected"] + 1
    assert LAUNCHES["fbp_cn"] == n0["fbp_cn"]
    cpu = _small_layer("cpu", corrected=False)
    for sc, sg in ((cpu.k_store, card.k_store), (cpu.v_store, card.v_store)):
        for i in range(sg.n_pages):
            sc._set_page(i, sg.page(i).cpu())
    cpu._metas = [tuple(dataclasses.replace(m, scale=m.scale.cpu())
                        for m in pair) for pair in card._metas]
    cpu.invalidate()
    torch.testing.assert_close(got.float().cpu(), cpu.attend(q).float(),
                               **ULP)
    with pytest.raises(ValueError, match="CPU tensors"):
        _small_layer(dev, fused=False).attend(q.to(dev))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# B, Sq, Skv, Hq, Hkv, D, causal, window, softcap: chip_smoke.py's phase 2
# shapes (training, prefill, ragged bidirectional, window, softcap 2),
# then a head dim of 128 and rows that see no key
FLASH_SHAPES = [
    (2, 4096, 4096, 32, 8, 64, True, 0, 0.0),
    (4, 512, 512, 32, 8, 64, True, 0, 0.0),
    (1, 1000, 1200, 32, 8, 64, False, 0, 0.0),
    (2, 1024, 1024, 32, 8, 64, True, 256, 0.0),
    (2, 1024, 1024, 32, 8, 64, True, 0, 2.0),
    (1, 300, 300, 8, 2, 128, True, 0, 0.0),
    (1, 200, 100, 4, 1, 40, False, 16, 0.0),
]
# the edges of the kernels' 64-row tiles and of their zero-padded head
# dims (DM 64 or 128): Sq and Skv of 1, 63, 65, 127 and 129, D of 16, 40,
# 80 and 128, g of 1, 4 and 8, windows narrower than a tile, causal with
# Sq != Skv, and a head dim that is not a multiple of 8 (copied element by
# element instead of in 16-byte chunks)
FLASH_EDGE_SHAPES = [
    (1, 1, 65, 4, 1, 64, False, 0, 0.0),
    (1, 63, 65, 8, 1, 16, True, 0, 0.0),
    (1, 65, 63, 8, 8, 40, True, 0, 0.0),
    (1, 127, 129, 4, 1, 80, False, 0, 0.0),
    (1, 129, 127, 4, 4, 128, True, 0, 0.0),
    (1, 129, 129, 8, 1, 64, True, 8, 0.0),
    (1, 1, 129, 4, 4, 128, False, 40, 2.0),
    (2, 65, 127, 4, 2, 80, True, 16, 0.0),
    (1, 130, 70, 2, 1, 33, True, 0, 0.0),
]
FLASH_BWD_BOUND = 5e-3       # of max |plain|, the JAX package's own bound


def _flash_operands(dev, case, seed=0):
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B * Hq, Sq, D), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B * Hkv, Skv, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(g=Hq // Hkv, scale=1.0 / D ** 0.5, causal=causal,
              window=window, softcap=cap)
    return (q, k, v, do), kw


def _within(got, want, bound):
    scale = float(want.float().abs().max()) + 1e-9
    err = float((got.float() - want.float()).abs().max())
    assert err <= bound * scale, (err, scale)


@pytest.mark.parametrize("case", FLASH_SHAPES + FLASH_EDGE_SHAPES)
def test_flash_kernels_match_plain(dev, case):
    from repro_torch.kernels import flash_attention as fa
    (q, k, v, do), kw = _flash_operands(dev, case)
    n0 = dict(LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert LAUNCHES[name] == n0.get(name, 0) + 1
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), o_p.float(), **ULP)
    # atol for the rows with few keys, whose lse is one score near 0
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    _within(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
            FLASH_BWD_BOUND)
    for got, want in zip((dk, dv), fa.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, **kw), strict=True):
        assert got.dtype == k.dtype and got.shape == k.shape
        _within(got, want, FLASH_BWD_BOUND)


@pytest.mark.parametrize("case", [(1, 1, 1, 4, 1, 64, True, 0, 0.0),
                                  (1, 200, 1, 4, 1, 40, True, 0, 0.0)])
def test_flash_kernels_single_key(dev, case):
    """Skv = 1: every row sees one key, so o is that key's v, and the
    softmax has no gradient: dq and dk are 0 up to the rounding of
    dp - delta (dp = do.v, delta = do.o in another order), which is held
    within FLASH_BWD_BOUND of the call's largest |dv|; o, lse and dv
    against the plain versions as in test_flash_kernels_match_plain."""
    from repro_torch.kernels import flash_attention as fa
    (q, k, v, do), kw = _flash_operands(dev, case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), o_p.float(), **ULP)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)[1]
    _within(dv, dv_p, FLASH_BWD_BOUND)
    scale = float(dv_p.float().abs().max())
    for g in (dq, dk):
        assert float(g.float().abs().max()) <= FLASH_BWD_BOUND * scale


@pytest.mark.parametrize("case", [FLASH_SHAPES[1], FLASH_SHAPES[4],
                                  FLASH_EDGE_SHAPES[7]])
def test_flash_kernels_are_bitwise_repeatable(dev, case):
    """Two calls of flash_fwd, flash_bwd_dq (one CTA per q tile) and
    flash_bwd_dkv (no atomics: each KV tile sums its group in a fixed
    order) give the same bits."""
    from repro_torch.kernels import flash_attention as fa
    (q, k, v, do), kw = _flash_operands(dev, case)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = fa.flash_delta(o, do)
        runs.append((o, lse, fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                     *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)))
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)


def _fwd_bf16_p(q, k, v, *, g, scale, causal, window=0, softcap=0.0):
    """The plain forward with p = exp(s - m) rounded to bf16 before P.V
    (l summed from the fp32 p): what a kernel that fed a bf16 P to the
    tensor cores would compute."""
    from repro_torch.kernels import flash_attention as fa
    rows = torch.arange(q.shape[0], device=q.device) // g
    s = fa._scores(q, k[rows], scale, softcap)
    s = torch.where(fa.flash_mask(q.shape[1], k.shape[1], causal, window,
                                  q.device), s, fa.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(torch.bfloat16).float(), v[rows].float())
    return (o / p.sum(-1, keepdim=True)).to(q.dtype)


def test_flash_fwd_split_p_is_needed_and_present(dev):
    """On the training shape's heads (32/8 of 64, causal) at S 1024, a
    forward whose P is rounded to bf16 leaves the ULP bound (rtol 2^-7,
    atol 2^-10) against flash_fwd_plain, while the kernel, which splits P
    into bf16 hi and lo, stays inside it."""
    from repro_torch.kernels import flash_attention as fa
    (q, k, v, _do), kw = _flash_operands(
        dev, (2, 1024, 1024, 32, 8, 64, True, 0, 0.0))
    want = fa.flash_fwd_plain(q, k, v, **kw)[0].float()

    def ratio(got):
        return float(((got.float() - want).abs() / (
            ULP["atol"] + ULP["rtol"] * want.abs())).max())

    assert ratio(_fwd_bf16_p(q, k, v, **kw)) > 1.0
    assert ratio(fa.flash_fwd(q, k, v, **kw)[0]) <= 1.0


def test_flash_kernels_run_on_the_tensor_cores(dev):
    """The built library's SASS has bf16 HGMMA (wgmma) instructions in both
    instantiations of the forward, dq and the dk/dv kernel, and s8 IGMMA
    ones in both of the PIM MAC's (with and without the clip), in every
    check tile of the syndrome scan and in every column tile of the
    encode."""
    import re
    import shutil
    import subprocess
    from pathlib import Path
    from repro_torch.kernels import build
    lib = build.library()
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        tool = shutil.which("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib._name], check=True,
                          capture_output=True, text=True).stdout
    bodies = re.split(r"\n\s*Function : ", sass)[1:]
    for name, op, count in (("flash_fwd_kernel", "HGMMA.64x", 2),
                            ("flash_bwd_dq_kernel", "HGMMA.64x", 2),
                            ("flash_bwd_dkv_kernel", "HGMMA.64x", 2),
                            ("pim_mac_kernel", "IGMMA.64x", 2),
                            ("scan_syndromes_kernel", "IGMMA.64x",
                             len(gf_matmul.SCAN_TILES)),
                            ("gf_matmul_kernel", "IGMMA.64x",
                             len(gf_matmul.GF_TILES))):
        found = [b for b in bodies if name in b.split("\n", 1)[0]]
        assert len(found) == count, (name, len(found))
        assert all(op in b for b in found), name


def test_flash_attention_backward_matches_plain(dev):
    """`FlashAttention` on (B, S, H, D) operands through autograd against
    the plain forward and backward of the same folded operands."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S, Hq, Hkv, D = 2, 700, 8, 2, 64
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=dev)
            for _ in range(2))
    do = torch.randn((B, S, Hq, D), generator=gen, device=dev)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves, True, 128, 2.0)
    o.backward(do)
    kw = dict(g=Hq // Hkv, scale=1.0 / D ** 0.5, causal=True, window=128,
              softcap=2.0)
    fold = fa._fold
    o_p, lse_p = fa.flash_fwd_plain(fold(q), fold(k), fold(v), **kw)
    torch.testing.assert_close(fold(o.detach()).float(), o_p.float(), **ULP)
    delta = fa.flash_delta(o_p, fold(do))
    dq = fa.flash_bwd_dq_plain(fold(q), fold(k), fold(v), fold(do), lse_p,
                               delta, **kw)
    dk, dv = fa.flash_bwd_dkv_plain(fold(q), fold(k), fold(v), fold(do),
                                    lse_p, delta, **kw)
    for t, want, H in zip(leaves, (dq, dk, dv), (Hq, Hkv, Hkv), strict=True):
        _within(t.grad, fa._unfold(want, B, H), FLASH_BWD_BOUND)


def test_flash_wrappers_refuse_wrong_inputs(dev):
    from repro_torch.kernels import flash_attention as fa
    (q, k, v, do), kw = _flash_operands(dev, FLASH_SHAPES[-1])
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q, k.float(), v, **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q.float(), k.float(), v.float(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     **kw)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((4, 8, 136), dtype=torch.bfloat16, device=dev)
        fa.flash_fwd(big, big[:1], big[:1], **kw)
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_fwd(q.cpu(), k, v, **kw)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_bwd_dq(q, k, v, do, lse.to(torch.bfloat16),
                        fa.flash_delta(o, do), **kw)


def test_training_steps_on_card_match_cpu(dev, tmp_path):
    """Two steps of reduced granite-3-2b under attn_impl="flash" through
    `launch.train.run` on the card and on the CPU from the same weights:
    the losses agree within 1e-2 relative (bf16 matmuls round in their
    own order on each device), and every step on the card launches all
    three flash kernels."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("granite_3_2b").reduced(
        n_groups=2, d_model=128, n_heads=4, d_ff=512), attn_impl="flash")
    start = init_params(cfg, 0, device="cpu")
    kw = dict(steps=2, batch=4, seq=64, lr=5e-3, save_every=100,
              log=lambda m: None)
    cpu = run(cfg, params=copy.deepcopy(start), device="cpu",
              ckpt_dir=str(tmp_path / "cpu"), **kw)
    n0 = dict(LAUNCHES)
    card = run(cfg, params=copy.deepcopy(start), device=dev,
               ckpt_dir=str(tmp_path / "card"), **kw)
    for name, per_step in (("flash_fwd", 4), ("flash_bwd_dq", 2),
                           ("flash_bwd_dkv", 2)):
        assert LAUNCHES[name] - n0.get(name, 0) == per_step * 2, name
    for a, b in zip(cpu, card, strict=True):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-2)


# ---------------------------------------------------------------------------
# PIM-protected serving and the BER campaign on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "correct", "correct_budget"])
def test_pim_context_on_card_matches_cpu(dev, mode, rng):
    """`PIMContext.matmul` on integer activations (max 7: scale 1) and
    ternary weights (alpha 1), with the same output noise on both
    devices: the card (the encode, MAC, scan and FBP kernels) equals the
    CPU's plain run exactly, outputs and counts."""
    from repro_torch.configs.base import PIMSpec
    from repro_torch.core import PIMContext, get_code, prepare_weights
    spec = PIMSpec(enabled=True, code_name="wl320_r08", mode=mode,
                   n_iters=4, correct_budget=8)
    x = rng.integers(-7, 8, (96, 512)).astype(np.float32)
    x[0, 0] = 7
    W = rng.integers(-1, 2, (512, 600)).astype(np.float32)
    n_enc = prepare_weights(torch.as_tensor(W, dtype=torch.int8),
                            get_code("wl320_r08")).shape[1]
    noise = torch.as_tensor(
        (rng.random((96, n_enc)) < 2e-3) * rng.choice([-1, 1], (96, n_enc)),
        dtype=torch.int32)
    out, stats = {}, {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        ctx = PIMContext(spec)
        n0 = dict(LAUNCHES)
        out[name] = ctx.matmul(torch.as_tensor(x, device=d),
                               torch.as_tensor(W, device=d), "a",
                               out_noise=noise.to(d)).cpu()
        stats[name] = ctx.stats()
    ran = {k for k, v in LAUNCHES.items() if v > n0.get(k, 0)}   # the card
    assert torch.equal(out["cuda"], out["cpu"])
    assert stats["cuda"] == stats["cpu"]
    assert {"gf_matmul", "pim_mac"} <= ran
    if mode != "off":
        assert stats["cpu"]["detected_words"] > 0
        assert {"scan_syndromes", "fbp_cn"} <= ran


def test_pim_training_pass_on_card_matches_cpu(dev, monkeypatch):
    """Reduced paper_pim (wl40_r08) computing in float32 (`CDT` of
    `nn.layers` and `models.lm` monkeypatched): `loss_fn` with `pim_ctx`
    and its backward under remat, on the card and on the CPU from the
    same weights. Every gradient is within 1e-4 of its leaf's largest
    value; each protected call's integer output on the card equals the
    CPU run's, and the plain CPU run of the card's own integer operands;
    the encode, MAC and scan kernels ran, twice a call (the forward pass
    and the recomputation), while `stats()` counts each call once."""
    import dataclasses
    import repro_torch.models.lm as tlm
    import repro_torch.nn.layers as tlayers
    from repro_torch.configs import get_config
    from repro_torch.core import PIMContext
    from repro_torch.core import context as tcontext
    from repro_torch.models import init_params, loss_fn
    monkeypatch.setattr(tlayers, "CDT", torch.float32)
    monkeypatch.setattr(tlm, "CDT", torch.float32)
    cfg = get_config("paper_pim").reduced(n_groups=2, d_model=128,
                                          n_heads=4, d_ff=256)
    cfg = dataclasses.replace(cfg, pim=dataclasses.replace(
        cfg.pim, code_name="wl40_r08"))
    assert cfg.remat
    real = tcontext.protected_pim_matmul
    calls = []

    def spy(x, W_enc, *args, **kw):
        res = real(x, W_enc, *args, **kw)
        calls.append((x, W_enc, args, kw, res.y))
        return res
    monkeypatch.setattr(tcontext, "protected_pim_matmul", spy)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    start = init_params(cfg, 0, device="cpu")
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        model = init_params(cfg, 0, device="cpu")
        model.load_state_dict(start.state_dict())
        model.to(d)
        ctx = PIMContext(cfg.pim)
        calls.clear()
        n0 = dict(LAUNCHES)
        batch = {"tokens": torch.as_tensor(toks, device=d)}
        batch["labels"] = batch["tokens"]
        loss = loss_fn(model, cfg, batch, pim_ctx=ctx)
        loss.backward()
        grads = {k: p.grad.float().cpu()
                 for k, p in model.named_parameters()}
        out[name] = (float(loss.detach()), grads, list(calls), ctx.stats(),
                     {k: v - n0.get(k, 0) for k, v in LAUNCHES.items()})
    (cl, cg, ccalls, cst, _), (gl, gg, gcalls, gst, ran) = \
        out["cpu"], out["cuda"]
    assert gl == pytest.approx(cl, rel=1e-5)
    for k, want in cg.items():
        scale = float(want.abs().max())
        assert float((gg[k] - want).abs().max()) <= 1e-4 * scale, k
    assert gst == cst and gst["calls"] == 4
    assert len(gcalls) == len(ccalls) == 8       # forward + recomputation
    for (x, W_enc, args, kw, y), (*_c, cy) in zip(gcalls, ccalls,
                                                   strict=True):
        assert torch.equal(y.cpu(), cy)
        plain = real(x.cpu(), W_enc.cpu(), *args,
                     **{k: v.cpu() if isinstance(v, torch.Tensor) else v
                        for k, v in kw.items()}).y
        assert torch.equal(y.cpu(), plain)
    assert ran.get("pim_mac", 0) == 8, ran
    assert ran.get("gf_matmul", 0) >= 8 and ran.get("scan_syndromes", 0) >= 8


def test_nbldpc_residuals_on_card_match_cpu(dev):
    """The campaign's residuals of identical corrupted words: the card's
    decode (FBP and the scan kernels) equals the CPU's, float for float;
    the card's own draw runs the encode kernel."""
    from repro_torch.core import get_code
    from repro_torch.memory import NBLDPCScheme, asymmetric_adjacent
    code = get_code("wl1024_r08")
    for channel in (None, asymmetric_adjacent(3, 0.7, 0.3)):
        cpu = NBLDPCScheme(code, channel, device="cpu")
        card = NBLDPCScheme(code, channel, device=dev)
        for m in (4, 24, 48):
            cw, y = cpu.draw(m, 64, 1)
            assert card.residuals_of(cw.to(dev), y.to(dev)) == \
                cpu.residuals_of(cw, y)
    n0 = LAUNCHES["gf_matmul"]
    cw, y = card.draw(8, 64, 0)
    assert cw.is_cuda and LAUNCHES["gf_matmul"] == n0 + 1
    assert ((y != cw).sum(dim=1) == 8).all()


def test_plusminusone_corrupt_exact_on_card(dev):
    from repro_torch.memory import PlusMinusOne
    words = torch.randint(0, 3, (256, 1024), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m in (1, 7, 64):
        y = PlusMinusOne(0.0).corrupt_exact(gen, words, m)
        diff = y - words
        assert y.is_cuda and ((diff != 0).sum(dim=1) == m).all()
        assert set(diff.unique().tolist()) == {-1, 0, 1}


# ---------------------------------------------------------------------------
# the shared page pool and the multi-tenant engine on the card
# ---------------------------------------------------------------------------


def test_attend_protected_slot_ignores_other_slots_pages(dev):
    """Per-slot pages (S = B) with the ranges sized for a fixed page
    bound, as the engine sizes them for max_seq: a slot's output is
    bitwise the same when another slot holds more pages (NP grows, the
    slot's own pages past its count are zero pages with scale 0 and valid
    0), because a range's pages then do not depend on NP (`attend_plan`)
    and an empty range merges with weight 0."""
    from repro_torch.kernels import paged_attention as pa
    shape = dict(B=4, Sq=1, Hq=32, Hkv=8, D=64, T=16, S=4)
    args, kw = _attend_operands(dev, code_name="wl160_r08", seed=9, NP=34,
                                **shape)
    kw.update(ref_pages=34)                   # the engine's max_seq 544
    q, kp, vp, ks, vs, valid, hk, hv, hval = args
    own = 11                      # slot 0's pages; the others hold 34
    kp, vp, ks, vs, valid = (t.clone() for t in (kp, vp, ks, vs, valid))
    for t in (kp, vp, ks, vs):
        t[own:, 0] = 0
    valid[own:, 0] = 0
    full = pa.attend_protected(q, kp, vp, ks, vs, valid, hk, hv, hval, **kw)
    alone = pa.attend_protected(q, *(t[:own].contiguous()
                                     for t in (kp, vp, ks, vs, valid)),
                                hk, hv, hval, **kw)
    assert torch.equal(full[0].view(torch.int16),
                       alone[0].view(torch.int16))
    want = pa.attend_protected_plain(q, kp, vp, ks, vs, valid, hk, hv, hval,
                                     **kw)
    torch.testing.assert_close(full.float(), want.float(), **ULP)


def _pool_pair(dev, rng):
    """A wl160_r08 pool on `dev` with two owners' pages, corrupted from
    numpy, and a CPU copy of it."""
    from repro_torch.memory import PooledStore, ProtectedPagePool
    pools = [ProtectedPagePool("wl160_r08", page_words=24, capacity_pages=32,
                               n_iters=8, device=d) for d in (dev, "cpu")]
    words = [rng.integers(0, 3, (m, 128)) for m in (150, 90)]
    for pool in pools:
        for owner, u in enumerate(words):
            PooledStore(pool, owner=owner).append_words(torch.as_tensor(u))
    for pid in pools[0].allocated():
        page = pools[1].page(pid).numpy().astype(np.int64)
        hit = rng.random(page.shape) < 2e-3
        page[hit] = (page[hit] + rng.integers(1, 3, hit.sum())) % 3
        for pool in pools:
            pool.set_page(pid, torch.as_tensor(page, dtype=torch.int8,
                                               device=pool.device))
    return pools


@pytest.mark.parametrize("coalesce", [True, False])
def test_pool_scrub_on_card_matches_cpu(dev, coalesce, rng):
    """The pool's scrub on the card (scan and FBP kernels) repairs exactly
    what its CPU run repairs, with the same reports and attribution."""
    card, cpu = _pool_pair(dev, rng)
    n0 = LAUNCHES["scan_syndromes"], LAUNCHES["fbp_cn"]
    for kw in (dict(max_pages=5), dict(max_pages=5), {}):
        a = card.scrub(coalesce=coalesce, **kw)
        b = cpu.scrub(coalesce=coalesce, **kw)
        assert a == b
    assert LAUNCHES["scan_syndromes"] > n0[0] and LAUNCHES["fbp_cn"] > n0[1]
    assert card.scrub_by_owner == cpu.scrub_by_owner
    assert cpu.stats.scrub_corrected > 0
    for pid in cpu.allocated():
        assert torch.equal(card.page(pid).cpu(), cpu.page(pid))


def _tiny_engine_runs(device, prompts, pool_pages=256, **kw):
    from repro_torch.configs import get_config
    from repro_torch.core import get_code
    from repro_torch.memory import ProtectedPagePool, words_for_tensor
    from repro_torch.models import ProtectedKVConfig, init_params
    from repro_torch.serving import ServingEngine
    cfg = get_config("paper_pim").reduced(n_groups=2, d_model=64, n_heads=4,
                                          n_kv_heads=2, d_ff=128)
    params = init_params(cfg, 0, device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            p.mul_(3.0)
    params = params.to(device)
    code = get_code("wl160_r08")
    pool = ProtectedPagePool(code, capacity_pages=pool_pages, n_iters=8,
                             page_words=words_for_tensor((1, 8, 2, 16),
                                                         code.p, code.k),
                             device=device)
    eng = ServingEngine(params, cfg, pool=pool, max_active=4, max_seq=48,
                        pkv=ProtectedKVConfig("wl160_r08", page_tokens=8,
                                              n_iters=8), **kw)
    for t, p in prompts.items():
        eng.submit(t, p, max_new=8)
    return eng.run(), eng


def test_engine_tokens_on_card_match_cpu(dev):
    """The tiny engine (reduced paper-pim-2b, 4 tenants, 8 tokens each)
    gives the same tokens on the card as on the CPU, its reads through
    attend_protected (once per layer a step) and its freezes through the
    encode kernel; the pool drains."""
    rng = np.random.default_rng(0)
    prompts = {t: rng.integers(0, 512, 12 + 3 * t) for t in range(4)}
    want, _ = _tiny_engine_runs("cpu", prompts)
    n0 = LAUNCHES["attend_protected"], LAUNCHES["gf_matmul"]
    got, eng = _tiny_engine_runs(dev, prompts)
    assert got == want
    assert LAUNCHES["attend_protected"] - n0[0] == 2 * eng.stats()["step"]
    assert LAUNCHES["gf_matmul"] > n0[1]
    assert eng.pool.n_allocated == 0


def test_engine_single_tenant_matches_multi_tenant_on_card(dev):
    """On the card a tenant's tokens do not depend on the other slots:
    each tenant served alone gives its multi-tenant tokens, and so does a
    preempted and resumed run in a small pool."""
    rng = np.random.default_rng(1)
    prompts = {t: rng.integers(0, 512, 9 + 7 * t) for t in range(4)}
    multi, _ = _tiny_engine_runs(dev, prompts)
    for t, p in prompts.items():
        solo, _ = _tiny_engine_runs(dev, {t: p})
        assert solo[t] == multi[t], f"tenant {t} diverged under batching"
    tight, eng = _tiny_engine_runs(dev, prompts, pool_pages=40)
    assert eng.stats()["preemptions"] > 0 and tight == multi


# ---------------------------------------------------------------------------
# telemetry and the sanitizer on the card
# ---------------------------------------------------------------------------


def test_sanitizer_on_card_raises_and_passes_clean(dev, rng):
    """The checks reduce on the card: an out-of-field symbol in the scan's
    words or the encode's lhs, a NaN query, a NaN hot K row (the output
    check) and a negative scale raise `SanitizerError` with the JAX text;
    a clean `attend_protected` gives the unsanitized bits, and a decode of
    levels that drifted below 0 passes."""
    from repro_torch.analysis import SanitizerError, use_sanitizer
    from repro_torch.kernels import paged_attention as pa
    code = get_code("wl1024_r08")
    y = torch.as_tensor(np_encode_words(
        rng.integers(0, code.p, (4096, code.k)), code), dtype=torch.int8,
        device=dev)
    y[17, 5] = code.p
    ht = code.tensor("H.T", dev, torch.int8)
    with use_sanitizer():
        with pytest.raises(SanitizerError) as err:
            gf_matmul.scan_syndromes(y, ht, code.p)
        assert str(err.value) == ("sanitizer[scan_syndromes words]: GF "
                                  "symbol outside [0, 3): min=0, max=3")
        with pytest.raises(SanitizerError, match=r"gf_matmul lhs\]"):
            gf_matmul.gf_matmul(y[:, :code.k],
                                code.tensor("P", dev, torch.int8), code.p)
    shape = dict(B=4, Sq=1, Hq=32, Hkv=8, D=64, T=16, S=1)
    args, kw = _attend_operands(dev, code_name="wl160_r08", seed=3, NP=32,
                                **shape)
    q, kp, vp, ks, vs, valid, hk, hv, hval = args
    ref = pa.attend_protected(*args, **kw)
    with use_sanitizer():
        assert torch.equal(pa.attend_protected(*args, **kw).view(
            torch.int16), ref.view(torch.int16))
        bad_q = q.clone()
        bad_q[1, 0, 3, 7] = float("nan")
        with pytest.raises(SanitizerError, match=r"query\]: non-finite"):
            pa.attend_protected(bad_q, *args[1:], **kw)
        bad_k = hk.clone()
        bad_k[2, 0] = float("nan")
        with pytest.raises(SanitizerError, match=r"output\]: non-finite"):
            pa.attend_protected(q, kp, vp, ks, vs, valid, bad_k, hv, hval,
                                **kw)
        with pytest.raises(SanitizerError, match=r"K scales\]"):
            pa.attend_protected(q, kp, vp, -ks, vs, valid, hk, hv, hval,
                                **kw)
        words = torch.zeros((8, 32), dtype=torch.int32, device=dev)
        words[3, 4] = -1
        _y, res = decode_integers(get_code("wl32_r08"), words, n_iters=4)
        assert res.symbols.is_cuda


def test_span_sync_waits_for_the_card(dev):
    """`span(sync=t)` on a CUDA tensor (here in a structure) returns only
    when the card's queued work is done."""
    from repro_torch import obs
    a = torch.randn((4096, 4096), device=dev)
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        with obs.span("mm", sync=(a, {"x": [a]})):
            b = a @ a
            for _ in range(8):
                b = b @ a
        done = torch.cuda.current_stream(dev).query()
        with obs.span("nosync"):
            c = b @ a
    assert done
    assert [e["name"] for e in tr.spans()] == ["mm", "nosync"]
    torch.cuda.synchronize(dev)
    assert c.shape == a.shape


def test_estimator_fed_from_card_iterations(dev, rng):
    """Decodes and corrected reads on the card feed the estimator the same
    numbers as on the CPU (the iteration vectors are read back once per
    feed)."""
    from repro_torch import obs
    from repro_torch.memory import PagedProtectedStore
    snaps = []
    for device in (dev, "cpu"):
        r = np.random.default_rng(4)
        code = get_code("wl160_r08")
        st = PagedProtectedStore(code, page_words=64, n_iters=8,
                                 device=device)
        st.owner = 1
        st.append_words(torch.as_tensor(r.integers(0, 3, (200, code.k))))
        for i in range(st.n_pages):
            page = st.page(i).cpu().numpy().astype(np.int64)
            hit = r.random(page.shape) < 3e-3
            page[hit] = (page[hit] + r.integers(1, 3, hit.sum())) % 3
            st._pages[i] = torch.as_tensor(page, dtype=torch.int8,
                                           device=device)
        est = obs.ErrorRateEstimator()
        with obs.use_estimator(est):
            for i in range(st.n_pages):
                st.read_page_corrected(i)
            y = torch.as_tensor(np_encode_words(
                r.integers(0, 3, (64, code.k)), code), device=device)
            y[::3, 7] = (y[::3, 7] + 1) % 3
            decode_integers(code, y, n_iters=8, early_exit=True)
        snaps.append(est.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["1"]["decode_words"] > 0
    assert snaps[0][""]["decode_words"] == 64


def test_engine_telemetry_on_card_matches_cpu(dev):
    """The tiny engine with a scrub every 2 steps under all three pillars:
    on the card the same estimator snapshot, counters, gauges and span
    structure as on the CPU, and the same tokens."""
    from repro_torch import obs
    rng = np.random.default_rng(2)
    prompts = {t: rng.integers(0, 512, 10 + 4 * t) for t in range(4)}
    runs = []
    for device in ("cpu", dev):
        reg, tr, est = (obs.MetricsRegistry(), obs.Tracer(),
                        obs.ErrorRateEstimator())
        with obs.use_metrics(reg), obs.use_tracer(tr), \
                obs.use_estimator(est):
            out, eng = _tiny_engine_runs(device, prompts, scrub_every=2,
                                         scrub_max_pages=8)
            eng.publish_metrics()
        snap = {k: v for k, v in reg.snapshot().items()
                if not k.endswith("_seconds")}
        spans = [(e["name"], e["args"]) for e in tr.events()]
        runs.append((out, est.snapshot(), snap, spans))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the MoE, mamba and encoder-decoder stacks' paths on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [(16, 16), (32, 8)])
def test_attend_protected_head_dim_128_matches_plain(dev, heads):
    """The decode reads of olmoe-1b-7b (16/16 heads) and jamba (32/8) at
    head dim 128 over wl160_r08 pages of 16 tokens: a few bf16 ulps from
    the plain version, bitwise repeatable."""
    from repro_torch.kernels import paged_attention as pa
    Hq, Hkv = heads
    args, kw = _attend_operands(dev, code_name="wl160_r08", seed=5, B=4,
                                Sq=1, Hq=Hq, Hkv=Hkv, D=128, T=16, NP=32,
                                S=1)
    got = pa.attend_protected(*args, **kw)
    again = pa.attend_protected(*args, **kw)
    want = pa.attend_protected_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **ULP)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def test_moe_routing_and_combine_on_card_match_cpu(dev, rng):
    """An MoE layer (64 experts, top 8, a capacity that drops) on the card
    and on the CPU from the same weights: the routing and dispatch of the
    same router logits exactly, the layer's output within 4 bf16 ulps of
    the CPU's largest and bitwise repeatable (the combine adds each
    token's slots in a fixed order, without atomics)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.nn import moe
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(
        n_experts=64, d_model=128, d_ff=256), top_k=8, capacity_factor=0.5)
    layer = moe.MoE(cfg, 256, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    card = moe.MoE(cfg, 256, device=dev)
    card.load_state_dict(layer.state_dict())
    x = torch.from_numpy(rng.normal(size=(96, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        logits = moe.router_logits(card, x.to(dev))
        T = x.shape[0]
        got = moe.topk_route(logits, cfg.top_k)
        want = moe.topk_route(logits.cpu(), cfg.top_k)
        plan = moe.dispatch(got[0], 64, moe.capacity(T, cfg))
        plan_cpu = moe.dispatch(want[0], 64, moe.capacity(T, cfg))
        assert not bool(plan_cpu.keep.all())
        for a, b in [*zip(got, want), *zip(plan[:5], plan_cpu[:5])]:
            assert torch.equal(a.cpu(), b)
        y = moe.moe_sorted_ep(card, x.to(dev), cfg)
        y2 = moe.moe_sorted_ep(card, x.to(dev), cfg)
        y_cpu = moe.moe_sorted_ep(layer, x, cfg)
    assert torch.equal(y.view(torch.int16), y2.view(torch.int16))
    _close_in_ulps(y, y_cpu)


def _close_in_ulps(got, want, ulps: int = 4):
    """got (card) within rtol 2^-6 and `ulps` bf16 ulps of the largest
    |want| (CPU) of want."""
    want = want.float()
    atol = ulps * torch.finfo(torch.bfloat16).eps * float(want.abs().max())
    torch.testing.assert_close(got.float().cpu(), want, rtol=2 ** -6,
                               atol=atol)


def test_mamba_scan_on_card_matches_cpu(dev, rng):
    """The chunked scan (a ragged last chunk) and a mamba block's full pass
    and decode step on the card against the CPU, with TF32 off for float32
    matmuls; then the full pass again with TF32 allowed, bitwise the
    same."""
    from repro_torch.configs import get_config
    from repro_torch.nn import mamba as m
    assert not torch.backends.cuda.matmul.allow_tf32
    Bb, L, di, ds = 2, 45, 64, 16
    ins = [rng.normal(size=(Bb, L, di)),
           0.05 + 0.1 * rng.random((Bb, L, di)),
           -0.5 - rng.random((di, ds)), rng.normal(size=(Bb, L, ds)),
           rng.normal(size=(Bb, L, ds)), np.ones(di),
           rng.normal(size=(Bb, di, ds))]
    ins = [torch.from_numpy(a.astype(np.float32)) for a in ins]
    y, h = m.ssm_chunked(*[t.to(dev) for t in ins], 16)
    y_cpu, h_cpu = m.ssm_chunked(*ins, 16)
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h.cpu(), h_cpu, rtol=1e-5, atol=1e-5)

    cfg = get_config("falcon_mamba_7b").reduced(d_model=128)
    block = m.Mamba(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    with torch.no_grad():               # outputs of about 0.02, not 1e-3
        for w in (block.in_proj, block.x_proj, block.dt_proj_w):
            w.mul_(8)
    card = m.Mamba(cfg, device=dev)
    card.load_state_dict(block.state_dict())
    x = torch.from_numpy(rng.normal(size=(2, 33, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        out, st_out = m.mamba_apply(card, x[:, :32].to(dev), cfg)
        out_cpu, st_cpu = m.mamba_apply(block, x[:, :32], cfg)
        step, st = m.mamba_apply(card, x[:, 32:].to(dev), cfg, st_out,
                                 decode=True)
        step_cpu, st_cpu = m.mamba_apply(block, x[:, 32:], cfg, st_cpu,
                                         decode=True)
    for a, b in ((out, out_cpu), (step, step_cpu)):
        _close_in_ulps(a, b)
    torch.testing.assert_close(st.ssm.cpu(), st_cpu.ssm, rtol=1e-2,
                               atol=1e-3 * float(st_cpu.ssm.abs().max()))
    # the dt projection runs in float64: the caller's TF32 flag changes
    # no bit of the block's output or state
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            out_tf32, st_tf32 = m.mamba_apply(card, x[:, :32].to(dev), cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(out_tf32, out)
    assert torch.equal(st_tf32.ssm, st_out.ssm)
    assert torch.equal(st_tf32.conv, st_out.conv)


def test_kernels_launch_on_a_card_that_is_not_current(dev, rng):
    """Each of the eight kernels on operands on `cuda:1` while `cuda:0` is
    current: the launch runs on the operands' card (its stream, its
    shared-memory attributes) and equals the plain version there, one
    launch a kernel; the caller's current card is left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: every launch here is on the "
                    "card that is not current")
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    one = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    a = torch.as_tensor(rng.integers(0, 3, (300, 160)), dtype=torch.int8,
                        device=one)
    b = torch.as_tensor(rng.integers(0, 3, (160, 32)), dtype=torch.int8,
                        device=one)
    m = (rng.standard_normal((1000, 16, 3)) * 4).astype(np.float32)
    m = torch.as_tensor(m - m.max(axis=-1, keepdims=True), device=one)
    x = torch.as_tensor(rng.integers(-7, 8, (70, 256)), dtype=torch.int8,
                        device=one)
    w = torch.as_tensor(rng.integers(-1, 2, (256, 90)), dtype=torch.int8,
                        device=one)
    kw = dict(row_parallelism=64, adc_levels=6)
    # the page operands are encoded (gf_matmul) before the count starts
    args, akw = _attend_operands(one, code_name="wl160_r08", seed=3,
                                 **ATTEND_SHAPES[0])
    (q, k, v, do), fkw = _flash_operands(one, FLASH_SHAPES[1])
    assert torch.cuda.current_device() == 0
    n0 = dict(LAUNCHES)
    assert torch.equal(gf_matmul.gf_matmul(a, b, 3),
                       gf_matmul.gf_matmul_plain(a, b, 3))
    assert torch.equal(gf_matmul.scan_syndromes(a, b, 3),
                       gf_matmul.scan_syndromes_plain(a, b, 3))
    assert torch.equal(fbp.fbp_cn(m, 3).view(torch.int32),
                       fbp.fbp_cn_plain(m, 3).view(torch.int32))
    assert torch.equal(pim_mac.pim_mac(x, w, **kw),
                       pim_mac.pim_mac_plain(x, w, **kw))
    torch.testing.assert_close(pa.attend_protected(*args, **akw).float(),
                               pa.attend_protected_plain(*args, **akw)
                               .float(), **ULP)
    o, lse = fa.flash_fwd(q, k, v, **fkw)
    torch.testing.assert_close(o.float(), fa.flash_fwd_plain(
        q, k, v, **fkw)[0].float(), **ULP)
    delta = fa.flash_delta(o, do)
    _within(fa.flash_bwd_dq(q, k, v, do, lse, delta, **fkw),
            fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **fkw),
            FLASH_BWD_BOUND)
    for got, want in zip(fa.flash_bwd_dkv(q, k, v, do, lse, delta, **fkw),
                         fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                **fkw), strict=True):
        _within(got, want, FLASH_BWD_BOUND)
    torch.cuda.synchronize(one)
    assert torch.cuda.current_device() == 0
    made = {k: LAUNCHES[k] - n0.get(k, 0) for k in KERNELS}
    assert made == dict.fromkeys(KERNELS, 1), made


def test_four_shard_mesh_on_one_card(dev, rng):
    """A mesh that names the card four times: the sharded decode and scan
    equal the unsharded ones bit for bit, with one scan launch a shard,
    and expert-parallel MoE equals the one-device dispatch within 4 bf16
    ulps of its largest output (the grouped products run at other
    shapes)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.nn import moe
    code = get_code("wl160_r08")
    mesh = sharding.Mesh([dev] * 4, ("data",))
    y = np_encode_words(rng.integers(0, 3, (301, code.k)), code)
    hit = rng.random(y.shape) < 0.02
    y[hit] += 1
    y = torch.as_tensor(y, device=dev)
    kw = dict(n_iters=8, damping=0.3, early_exit=True)
    got, want = (sharding.decode_sharded(code, y, mesh=mesh, **kw),
                 decode_integers(code, y, **kw))
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1], strict=True):
        assert torch.equal(a, b)
    levels = torch.remainder(y, 3).to(torch.int8)
    n0 = LAUNCHES["scan_syndromes"]
    flags = sharding.scan_syndromes_sharded(code, levels, mesh=mesh)
    assert LAUNCHES["scan_syndromes"] == n0 + 4
    assert torch.equal(flags, gf_matmul.scan_syndromes(
        levels, code.tensor("H.T", dev, torch.int8), 3))
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(
        n_experts=64, d_model=128, d_ff=256), top_k=8, capacity_factor=1.25)
    layer = moe.MoE(cfg, 256, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    x = torch.from_numpy(rng.normal(size=(2, 48, cfg.d_model)).astype(
        np.float32)).to(dev, torch.bfloat16)
    ep = sharding.Mesh(np.full((1, 4), dev, dtype=object), ("data",
                                                            "model"))
    with torch.no_grad():
        with sharding.use_rules(ep):
            y_ep = moe.moe_apply(layer, x, dataclasses.replace(
                cfg, moe_impl="shard_ep"))
        y_one = moe.moe_sorted_ep(layer, x.reshape(96, -1), cfg)
    _close_in_ulps(y_ep.reshape(96, -1), y_one.cpu())


def test_mesh_over_every_card_matches_unsharded(dev, rng):
    """A mesh over every visible card, one shard a card: a writeback array
    under the controller's default (sharded on two or more cards) equals
    an unsharded one on the same words and flips (the read-back, the
    counts, the scrub and the storage), a sharded scan launching once a
    card; and expert-parallel MoE with two data groups on different
    cards equals each group's one-device dispatch within 4 bf16 ulps of
    its largest output, each group keeping its placement of the experts
    across calls."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.memory import ProtectedMemoryArray, uniform_flip
    from repro_torch.nn import moe
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices: each shard of the mesh lies "
                    "on a card of its own")
    t = torch.randn(2 ** 20, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    arrays = [ProtectedMemoryArray("wl1024_r08", controller="writeback",
                                   device=dev, key=7, **kw)
              for kw in ({}, {"use_sharded": False})]
    ctrl = arrays[0].controller
    assert ctrl.use_sharded and ctrl.mesh.size == n
    assert not arrays[1].controller.use_sharded
    for a in arrays:
        a.write("t", t)
        a.inject(uniform_flip(3, 1e-4))
    enc = [a.stored("t").enc for a in arrays]
    assert torch.equal(enc[0], enc[1])
    want = t.cpu().numpy().view(np.uint8)
    for a in arrays:
        assert np.array_equal(a.read("t").view(np.uint8), want)
    assert arrays[0].stats.correction_counts() == \
        arrays[1].stats.correction_counts()
    assert arrays[0].stats.detected > 0
    for a in arrays:
        a.inject(uniform_flip(3, 1e-4))
    reps = [a.scrub() for a in arrays]
    for key in ("flagged", "corrected", "uncorrectable"):
        assert reps[0][key] == reps[1][key], key
    assert reps[0]["flagged"] > 0 and reps[0]["uncorrectable"] == 0
    assert torch.equal(arrays[0].stored("t").enc, arrays[1].stored("t").enc)
    code = get_code("wl1024_r08")
    n0 = LAUNCHES["scan_syndromes"]
    sharding.scan_syndromes_sharded(code, enc[0], mesh=ctrl.mesh)
    torch.cuda.synchronize()
    assert LAUNCHES["scan_syndromes"] == n0 + n
    # expert parallel: two data groups on different cards where n is even
    groups = 2 if n % 2 == 0 else 1
    ep = sharding.Mesh(np.array([torch.device("cuda", i) for i in range(n)],
                                dtype=object).reshape(groups, -1),
                       ("data", "model"))
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(
        n_experts=64, d_model=128, d_ff=256), top_k=8, capacity_factor=1.25)
    layer = moe.MoE(cfg, 256, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    x = torch.from_numpy(rng.normal(size=(2, 48, cfg.d_model)).astype(
        np.float32)).to(dev, torch.bfloat16)
    shard_ep = dataclasses.replace(cfg, moe_impl="shard_ep")
    with torch.no_grad():
        with sharding.use_rules(ep):
            y_ep = moe.moe_apply(layer, x, shard_ep)
            placed = {devs: hit[1] for devs, hit in layer._placed.items()}
            again = moe.moe_apply(layer, x, shard_ep)
        tok = 96 // groups
        y_one = torch.cat([moe.moe_sorted_ep(
            layer, x.reshape(96, -1)[g * tok:(g + 1) * tok], cfg)
            for g in range(groups)])
    assert len(placed) == groups and torch.equal(again, y_ep)
    assert all(layer._placed[devs][1] is p for devs, p in placed.items())
    _close_in_ulps(y_ep.reshape(96, -1), y_one.cpu())


@pytest.mark.parametrize("cards", [1, 2])
def test_fsdp_step_matches_unsharded(dev, cards, tmp_path):
    """Two data shards, both on one card or one on each of two cards,
    train reduced granite-3-2b (flash) for two steps from the unsharded
    trainer's weights: its losses, grad norms and parameters at
    microbatches = 2 bit for bit (each shard runs what its microbatch
    does, the gradients add in the same order and the norm's float64
    partials round to the same float32 norm), the flash kernels launched
    on each shard, and each slice on its own card."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.launch.cells import CellSettings, rules_for_cell
    from repro_torch.launch.train import run
    from repro_torch.models import init_params
    from repro_torch.models.lm import param_shardings, place_params
    if cards > torch.cuda.device_count():
        pytest.skip("needs two CUDA devices: each data shard of the mesh "
                    "on a card of its own")
    cfg = dataclasses.replace(get_config("granite_3_2b").reduced(
        n_groups=2, d_model=128, n_heads=4, d_ff=512), attn_impl="flash")
    devices = [torch.device("cuda", k % cards) for k in range(2)]
    mesh = sharding.Mesh(np.array([[d] for d in devices], dtype=object),
                         ("data", "model"))
    rules = rules_for_cell(mesh, cfg, ShapeSpec("custom", 64, 4, "train"),
                           CellSettings())
    start = init_params(cfg, 0, device="cpu")
    kw = dict(steps=2, batch=4, seq=64, save_every=100, log=lambda m: None)
    ref_model = copy.deepcopy(start).to(dev)
    ref = run(cfg, params=ref_model, device=dev, microbatches=2,
              ckpt_dir=str(tmp_path / "a"), **kw)
    placed = place_params(copy.deepcopy(start).to(devices[0]),
                          param_shardings(cfg, mesh, rules))
    hist = run(cfg, params=placed, mesh=mesh, rules=rules,
               ckpt_dir=str(tmp_path / "b"), **kw)
    for a, b in zip(ref, hist, strict=True):
        assert (b["loss"], b["grad_norm"]) == (a["loss"], a["grad_norm"])
        for got in b["launches_by_shard"]:
            assert got.get("flash_fwd") == 4 and got.get("flash_bwd_dkv") == 2
    assert {str(t.device) for t in placed.placed["embed"].distinct()} == \
        {str(d) for d in devices}
    for name, p in ref_model.named_parameters():
        assert torch.equal(placed.placed[name].gather(dev), p.detach()), name


def test_tp_step_on_one_card(dev, tmp_path):
    """A (data 1, model 4) mesh on one card trains reduced granite-3-2b
    (flash; 8 heads, 2 KV heads, so the KV projections are replicated)
    two steps: every position launches the flash kernels with 2 query
    heads and the one KV head they read (forward and remat forward a
    layer, one backward), each holds a quarter of every model-split
    leaf, and the losses and grad norms are the unsharded card
    trainer's, and step 0's the same mesh's on the CPU, within
    tests/test_torch_tp.py's bounds (rtol 1e-4 and 2e-3)."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.launch.cells import CellSettings, rules_for_cell
    from repro_torch.launch.train import run
    from repro_torch.models import init_params
    from repro_torch.models.lm import param_shardings, place_params
    cfg = dataclasses.replace(get_config("granite_3_2b").reduced(
        n_groups=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512),
        attn_impl="flash")
    start = init_params(cfg, 0, device="cpu")
    kw = dict(steps=2, batch=2, seq=64, save_every=100, log=lambda m: None)
    ref = run(cfg, params=copy.deepcopy(start).to(dev), device=dev,
              ckpt_dir=str(tmp_path / "ref"), **kw)
    hists = {}
    for where in (dev, torch.device("cpu")):
        mesh = sharding.Mesh(np.array([[where] * 4], dtype=object),
                             ("data", "model"))
        rules = rules_for_cell(mesh, cfg, ShapeSpec("custom", 64, 2,
                                                    "train"), CellSettings())
        placed = place_params(copy.deepcopy(start).to(where),
                              param_shardings(cfg, mesh, rules))
        hists[where.type] = run(cfg, params=placed, mesh=mesh, rules=rules,
                                ckpt_dir=str(tmp_path / where.type), **kw)
        for p in placed.placed.values():
            if sharding.model_dim(p.sharding, p.ndim) is not None:
                assert all(t.numel() * 4 == int(np.prod(p.shape))
                           for t in p.distinct())
    hist = hists["cuda"]
    for a, b in zip(ref, hist, strict=True):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=2e-3)
        assert len(b["launches_by_shard"]) == 4
        for got, heads in zip(b["launches_by_shard"], b["heads_by_shard"],
                              strict=True):
            assert got.get("flash_fwd") == 4 and got.get("flash_bwd_dq") \
                == 2 and got.get("flash_bwd_dkv") == 2, got
            assert {(h[1], h[2]) for h in heads} == {(2, 1)}, heads
    cpu = hists["cpu"][0]
    assert hist[0]["loss"] == pytest.approx(cpu["loss"], rel=1e-4)
    assert hist[0]["grad_norm"] == pytest.approx(cpu["grad_norm"], rel=2e-3)
