"""Port parity: the flash attention plain versions and `FlashAttention`
against the JAX package's flash kernels on the CPU (interpreted: the
kernel policy's default off a TPU).

Inputs are drawn with numpy from a seed and fed to both packages. The
cases are `tests/test_flash_attention.py`'s six, plus causal attention
with Sq != Skv (no diagonal offset), a window that leaves rows with no
key (o = 0, the `alive` guard), and the JAX wrapper's `kv_len` tail
against the port's unpadded ragged edge. Tolerances:

- fp32: o and lse to rtol 1e-5 (atol 1e-6 for values near 0); gradients
  to 1e-5 of the largest |gradient|. Both sides compute in fp32 and
  differ only in the order of the sums.
- bf16 inputs: o to a few bf16 ulps (rtol 2**-7, atol 2**-10): both
  round the same fp32 result, and a one-ulp flip is the most the order of
  the sums can cause. Gradients within 5e-3 of the largest |gradient|,
  the JAX package's own bound for its kernel against its oracle: the JAX
  wrapper rounds each q head's dk/dv to bf16 before it sums the GQA
  group, the port sums in fp32 and rounds once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels.ops import flash_attention as jflash
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import flash_attention as fa
from _torch_threads import torch_threads_per_worker  # noqa: F401

CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, softcap
    (1, 16, 16, 2, 2, 8, True, 0, 0.0),
    (2, 32, 32, 4, 2, 16, True, 0, 0.0),       # GQA
    (1, 64, 64, 4, 4, 8, True, 16, 0.0),       # sliding window
    (2, 32, 48, 4, 2, 8, False, 0, 0.0),       # cross / bidirectional
    (1, 32, 32, 2, 2, 8, True, 0, 30.0),       # soft-cap (gemma2)
    (1, 100, 100, 4, 2, 8, True, 0, 0.0),      # ragged
    (1, 24, 40, 4, 1, 8, True, 0, 2.0),        # causal, Sq != Skv, cap 2
    (1, 40, 24, 2, 1, 8, False, 8, 0.0),       # rows past the keys: o = 0
]
FP32 = dict(rtol=1e-5, atol=1e-6)
ULP = dict(rtol=2 ** -7, atol=2 ** -10)


def _operands(rng, case, dtype):
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    x = [rng.normal(size=s).astype(np.float32)
         for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                   (B, Sq, Hq, D))]
    if dtype == "bf16":      # values on the bf16 grid, identical for both
        x = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
             for a in x]
    return x


def _fold(a):
    B, S, H, D = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, D)


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _kw(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    return dict(g=Hq // Hkv, scale=1.0 / (D ** 0.5), causal=causal,
                window=window, softcap=cap)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_fwd_matches_jax_kernel(rng, case, dtype):
    q, k, v, _ = (_fold(a) for a in _operands(rng, case, dtype))
    kw = _kw(case)
    o_j, lse_j = jfa.flash_fwd(_jax(q, dtype), _jax(k, dtype),
                               _jax(v, dtype), **kw)
    n0 = LAUNCHES["flash_fwd"]
    o, lse = fa.flash_fwd(_torch(q, dtype), _torch(k, dtype),
                          _torch(v, dtype), **kw)
    assert LAUNCHES["flash_fwd"] == n0       # CPU tensors: the plain version
    assert o.dtype == _torch(q, dtype).dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(o), _f32(o_j),
                               **(FP32 if dtype == "fp32" else ULP))
    np.testing.assert_allclose(_f32(lse), _f32(lse_j), rtol=1e-5)
    if case[-2] and not case[6]:             # the rows that see no key
        assert not _f32(o)[:, -8:].any()


def test_ragged_edge_plays_the_kv_len_tail(rng):
    """The JAX wrapper pads K/V and masks the pad with `kv_len`; the port
    takes the unpadded K/V and masks its ragged edge: same o and lse."""
    case = (1, 32, 37, 2, 1, 8, False, 0, 0.0)
    q, k, v, _ = (_fold(a) for a in _operands(rng, case, "fp32"))
    pad = ((0, 0), (0, 48 - 37), (0, 0))
    o_j, lse_j = jfa.flash_fwd(jnp.asarray(q), jnp.asarray(np.pad(k, pad)),
                               jnp.asarray(np.pad(v, pad)), kv_len=37,
                               **_kw(case))
    o, lse = fa.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                          **_kw(case))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **FP32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_jax_kernel(rng, case):
    """dq and per-q-head dk/dv of `flash_bwd_plain` against the JAX
    `flash_bwd`; the kernels' wrappers (dq, group-summed dk/dv) against
    the same, summed over each group."""
    q, k, v, do = (_fold(a) for a in _operands(rng, case, "fp32"))
    kw = _kw(case)
    o_j, lse_j = jfa.flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    want = jfa.flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         o_j, lse_j, jnp.asarray(do), **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    to, tlse = torch.tensor(np.asarray(o_j)), torch.tensor(
        np.asarray(lse_j))
    got = fa.flash_bwd_plain(tq, tk, tv, to, tlse, tdo, **kw)
    delta = fa.flash_delta(to, tdo)
    dq = fa.flash_bwd_dq(tq, tk, tv, tdo, tlse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tdo, tlse, delta, **kw)
    g = kw["g"]
    grouped = [np.asarray(want[0])] + [
        np.asarray(w).reshape(-1, g, *w.shape[1:]).sum(1) for w in want[1:]]
    for a, b in zip(list(got) + [dq, dk, dv], list(want) + grouped,
                    strict=True):
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-5)


AUTOGRAD = [(c, "fp32") for c in CASES] + [(CASES[1], "bf16"),
                                          (CASES[4], "bf16")]


@pytest.mark.parametrize("case,dtype", AUTOGRAD)
def test_autograd_matches_custom_vjp(rng, case, dtype):
    """`FlashAttention` forward and its q/k/v gradients (of sum(o · do))
    against `ops.flash_attention` and `jax.grad` through its custom_vjp."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    q, k, v, do = _operands(rng, case, dtype)

    def f(q, k, v):
        o = jflash(q, k, v, causal, window, cap, None, None)
        return (o.astype(jnp.float32) * jnp.asarray(do)).sum(), o

    (_, o_j), g_j = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal, window, cap)
    (o.float() * torch.from_numpy(do)).sum().backward()
    assert o.shape == (B, Sq, Hq, D) and o.dtype == tq.dtype
    np.testing.assert_allclose(_f32(o.detach()), _f32(o_j),
                               **(FP32 if dtype == "fp32" else ULP))
    bound = 1e-5 if dtype == "fp32" else 5e-3
    for t, gj in zip((tq, tk, tv), g_j, strict=True):
        assert t.grad.dtype == t.dtype
        b = _f32(gj)
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(_f32(t.grad) / scale, b / scale,
                                   atol=bound)
