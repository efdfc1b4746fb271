"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same inputs (exact for the integer kernels, bitwise for
FBP), the launch counters, and the decoder on the card against its CPU
run. Marked `cuda`: skipped without a GPU. Run on a GPU machine with

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


@pytest.mark.parametrize("shape", [(1, 1, 1), (67, 130, 5), (300, 1024, 205)])
@pytest.mark.parametrize("p", [3, 7])
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


@pytest.mark.parametrize("K,R,adc", [(100, 0, 0), (256, 64, 6), (90, 6, 1),
                                     (128, 16, 4)])
def test_pim_mac_kernel_matches_plain(dev, K, R, adc, rng):
    x = torch.as_tensor(rng.integers(-7, 8, (70, K)), dtype=torch.int8,
                        device=dev)
    w = torch.as_tensor(rng.integers(-1, 2, (K, 90)), dtype=torch.int8,
                        device=dev)
    kw = dict(row_parallelism=R, adc_levels=adc)
    assert torch.equal(pim_mac.pim_mac(x, w, **kw),
                       pim_mac.pim_mac_plain(x, w, **kw))


@pytest.mark.parametrize("p", [2, 3, 5, 7])
@pytest.mark.parametrize("dc", [1, 2, 5, 16, 26])
def test_fbp_kernel_is_bitwise_plain(dev, p, dc, rng):
    m = (rng.standard_normal((1000, dc, p)) * 4).astype(np.float32)
    m -= m.max(axis=-1, keepdims=True)
    m = torch.as_tensor(m, device=dev)
    got, want = fbp.fbp_cn(m, p), fbp.fbp_cn_plain(m, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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


def test_kernel_wrappers_refuse_wrong_inputs(dev):
    x = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int8"):
        pim_mac.pim_mac(x, x.T)
    with pytest.raises(TypeError, match="float32"):
        fbp.fbp_cn(torch.zeros((2, 3, 3), dtype=torch.float64, device=dev), 3)
    with pytest.raises(ValueError, match="p=11"):
        fbp.fbp_cn(torch.zeros((2, 3, 11), device=dev), 11)
