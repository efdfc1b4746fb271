"""The host-side plans of the port's scan, encode and attend_protected
kernels, which run on the CPU: the scan's check tile and the encode's
column tile and their persistent grids, the K-major H and Pᵀ kept per Hᵀ
and P tensor, the split attention's pages a step and page ranges, and
the wrappers' device routing."""
import pytest
import torch

from repro_torch.core import get_code
from repro_torch.kernels import build, gf_matmul, paged_attention as pa
from _torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("C", [1, 6, 8, 32, 33, 64, 100, 205, 256, 257, 343])
@pytest.mark.parametrize("M", [1, 67, 256, 4096, 491_641])
def test_scan_plan_covers_every_check(M, C):
    """The narrowest tile at least C (chunks of 256 past it), and a CTA
    per (row tile, chunk) up to one an SM."""
    tile, ctas = gf_matmul.scan_plan(M, C, 132)
    assert tile in gf_matmul.SCAN_TILES
    if C <= 256:
        assert tile >= C
        assert all(t < C for t in gf_matmul.SCAN_TILES if t < tile)
    else:
        assert tile == 256
    tiles = -(-M // gf_matmul.SCAN_ROWS) * -(-C // tile)
    assert ctas == min(tiles, 132)


@pytest.mark.parametrize("N", [1, 8, 32, 33, 64, 100, 205, 256, 257, 343,
                               600])
@pytest.mark.parametrize("M", [1, 67, 256, 1536, 4096, 491_641])
@pytest.mark.parametrize("slots", [132, 16])
def test_gf_plan_covers_every_column(M, N, slots):
    """The encode's column tiles cover every column in the fewest chunks
    the widest tile allows, or, when the rows leave SMs idle, in more
    chunks that still fit one CTA an SM; never more CTAs than tiles or
    SMs."""
    tile, ctas = gf_matmul.gf_plan(M, N, slots)
    assert tile in gf_matmul.GF_TILES
    chunks = -(-N // tile)
    assert tile * chunks >= N
    rows = -(-M // gf_matmul.GF_ROWS)
    fewest = -(-N // gf_matmul.GF_TILES[-1])
    if chunks > fewest:                    # split for few words
        assert rows * chunks <= slots
    else:
        assert all(-(-N // t) > fewest for t in gf_matmul.GF_TILES
                   if t < tile)
    assert ctas == min(rows * chunks, slots)
    assert 1 <= ctas <= min(rows * chunks, slots)


def test_kmajor_h_keeps_one_pt_per_p():
    """The encode's B: Pᵀ (c, k16) from a code's cached P, zero past k,
    one copy while P lives, forgotten with it."""
    code = get_code("wl1024_r08")
    P = code.tensor("P", "cpu", torch.int8)
    bk = gf_matmul.kmajor_h(P, code.p)
    assert bk.shape == (code.c, -(-code.k // 16) * 16)
    assert torch.equal(bk[:, :code.k], P.t()) and not bk[:, code.k:].any()
    assert gf_matmul.kmajor_h(code.tensor("P", "cpu", torch.int8),
                              code.p) is bk
    fresh = P.clone()
    n0 = len(gf_matmul._KMAJOR_H)
    assert torch.equal(gf_matmul.kmajor_h(fresh, code.p), bk)
    assert len(gf_matmul._KMAJOR_H) == n0 + 1
    del fresh
    assert len(gf_matmul._KMAJOR_H) == n0


@pytest.mark.parametrize("name", ["wl40_r08", "wl160_r08", "wl1024_r08"])
def test_kmajor_h_is_h_padded_and_kept(name):
    """H (C, K16) from the code's cached Hᵀ: H itself, K zero-padded to a
    multiple of 16; the same tensor again while Hᵀ is unchanged, rebuilt
    after an in-place write, forgotten with Hᵀ."""
    code = get_code(name)
    ht = code.tensor("H.T", "cpu", torch.int8)
    h = gf_matmul.kmajor_h(ht, code.p)
    K16 = -(-code.n // 16) * 16
    assert h.shape == (code.c, K16) and h.dtype == torch.int8
    assert h.is_contiguous()
    assert torch.equal(h[:, :code.n], ht.t())
    assert not h[:, code.n:].any()
    assert gf_matmul.kmajor_h(ht, code.p) is h
    other = ht.clone()
    other[0, 0] = (int(other[0, 0]) + 1) % code.p
    h2 = gf_matmul.kmajor_h(other, code.p)
    assert torch.equal(h2[:, :code.n], other.t())
    other[0, 0] = ht[0, 0]                  # written in place: rebuilt
    h3 = gf_matmul.kmajor_h(other, code.p)
    assert h3 is not h2 and torch.equal(h3, h)
    key = id(other)
    del other, h2, h3
    assert key not in gf_matmul._KMAJOR_H


@pytest.mark.parametrize("NP", [0, 1, 2, 5, 32, 40, 256, 1000])
@pytest.mark.parametrize("BH,T", [(32, 16), (1, 16), (6, 4), (512, 16),
                                  (8, 64)])
def test_attend_plan_ranges(NP, BH, T):
    """Steps of about 32 tokens; ranges of whole steps, as few pages each
    as let max(NP, ref_pages) pages fill one wave of CTAs and never more
    ranges than one wave holds (the merge's partials stay bounded at any
    NP); ceil(NP / range) ranges, none without pages; and with NP <=
    ref_pages a range's page count that does not depend on NP (a row's
    ranges are the same whatever the other rows hold)."""
    pg = pa.attend_plan(NP, BH, T, 132)[0]
    assert 1 <= pg <= 8 and (pg == 1 or pg * T <= pa.STEP_TOKENS)
    wave = max(1, pa.CTAS_PER_SM * 132 // BH)
    for ref in (0, NP // 2, NP, 2 * NP + 3, 1000):
        got_pg, rp, nsplit = pa.attend_plan(NP, BH, T, 132, ref)
        assert got_pg == pg and rp % pg == 0
        assert nsplit == -(-NP // rp) and nsplit <= wave
        assert NP == 0 or (nsplit - 1) * rp < NP <= nsplit * rp
        steps = max(1, -(-max(NP, ref) // pg))
        assert rp == pg or -(-steps // (rp // pg - 1)) > wave
        if NP <= ref:
            for other in (0, 1, ref):
                assert pa.attend_plan(other, BH, T, 132, ref)[:2] == (pg, rp)


def test_route_names_the_device():
    x = torch.zeros(3)
    assert build.route("k", x, x) == "cpu"
    with pytest.raises(ValueError, match="no kernel for device type"):
        build.route("k", torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        build.route("k", x, torch.zeros(3, device="meta"))
