"""Port parity: the Mamba block (`repro_torch.nn.mamba`) against the JAX
package's `repro.nn.mamba` and a float64 sequential oracle.

The cases of tests/test_mamba.py run on the port, and the port is held
against the JAX functions on identical numpy inputs (weights from the
JAX package's `init_mamba`). Tolerances:

- the chunked scan against the float64 sequential oracle: rtol and atol
  2e-4, as the JAX test (float32 sums in another order);
- the chunked scan against the JAX package's `_ssm_chunked` (which pads
  to whole chunks; the port scans the ragged last chunk as it is): y and
  the final state within rtol 1e-5, atol 1e-6 (float32, the same
  pairwise recursion; the exponentials and sums round differently);
- the causal conv: exact against the JAX function (the same taps, in
  the same order, in float32);
- the whole block against `mamba_apply` (bf16 projections): atol 2**-8
  on outputs of |y| up to about 0.02 (measured: 3e-5), full pass and
  decode steps; the SSM state (|h| up to about 3e-4) within rtol 1e-2,
  atol 1e-7 of the JAX state (measured: 3e-11), the conv tail exact
  (bf16 inputs carried unchanged).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.nn import mamba as jm
from repro_torch.configs import get_config
from repro_torch.nn import mamba as m
from _torch_threads import torch_threads_per_worker  # noqa: F401

OUT_ATOL = 2 ** -8
SSM_TOL = dict(rtol=1e-2, atol=1e-7)
japply = jax.jit(jm.mamba_apply, static_argnums=2,
                 static_argnames=("decode",))



def _ssm_sequential(u, delta, A, B, C, D, h0):
    """Step-by-step float64 oracle for the selective scan."""
    Bb, L, di = u.shape
    h = np.asarray(h0, np.float64)
    ys = []
    for t in range(L):
        dA = np.exp(np.asarray(delta[:, t], np.float64)[..., None] *
                    np.asarray(A, np.float64))
        dBu = (np.asarray(delta[:, t] * u[:, t], np.float64)[..., None]
               * np.asarray(B[:, t], np.float64)[:, None, :])
        h = dA * h + dBu
        ys.append(np.einsum("bds,bs->bd", h, np.asarray(C[:, t], np.float64)))
    y = np.stack(ys, 1) + np.asarray(u, np.float64) * np.asarray(D, np.float64)
    return y, h


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _block(seed=0):
    """Reduced falcon-mamba: the JAX package's `init_mamba` weights (the
    projections scaled up so the scan's terms are not all near 0) and the
    port's `Mamba` holding them."""
    jcfg = jget_config("falcon_mamba_7b").reduced()
    cfg = get_config("falcon_mamba_7b").reduced()
    jp = jm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    jp = {k: (v * 8 if k in ("in_proj", "x_proj", "dt_proj_w") else v)
          for k, v in jp.items()}
    block = m.Mamba(cfg, device="cpu")
    with torch.no_grad():
        for name, param in block.named_parameters():
            param.copy_(torch.tensor(np.asarray(jp[name])))
    return jcfg, jp, cfg, block


@pytest.mark.parametrize("L,chunk", [(8, 4), (16, 16), (24, 8), (7, 16),
                                     (21, 8)])
def test_chunked_scan_matches_sequential(rng, L, chunk):
    Bb, di, ds = 2, 8, 4
    u = rng.normal(size=(Bb, L, di)).astype(np.float32)
    delta = (0.1 + 0.2 * rng.random((Bb, L, di))).astype(np.float32)
    A = (-0.5 - rng.random((di, ds))).astype(np.float32)
    B = rng.normal(size=(Bb, L, ds)).astype(np.float32)
    C = rng.normal(size=(Bb, L, ds)).astype(np.float32)
    D = np.ones((di,), np.float32)
    h0 = rng.normal(size=(Bb, di, ds)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (u, delta, A, B, C, D, h0)]
    y, h = m.ssm_chunked(*args, min(chunk, L))
    y_ref, h_ref = _ssm_sequential(u, delta, A, B, C, D, h0)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=2e-4, atol=2e-4)
    # the JAX package pads to whole chunks; the port does not
    Lp = -(-L // chunk) * chunk if L > chunk else L
    def pad(t):
        return jnp.pad(t, ((0, 0), (0, Lp - L)) + ((0, 0),) * (t.ndim - 2))

    jy, jh = jm._ssm_chunked(pad(u), pad(delta), A, pad(B), pad(C), D, h0,
                             min(chunk, Lp))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, :L], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)


def test_decode_step_continues_full_scan(rng):
    """Running L steps one by one must equal the full-sequence scan."""
    cfg = get_config("falcon_mamba_7b").reduced()
    block = m.Mamba(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    B, L = 2, 6
    x = torch.from_numpy(rng.normal(size=(B, L, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        y_full, st_full = m.mamba_apply(block, x, cfg)
        st = m.init_mamba_state(cfg, B)
        ys = []
        for t in range(L):
            y_t, st = m.mamba_apply(block, x[:, t:t + 1], cfg, state=st,
                                    decode=True)
            ys.append(y_t)
    np.testing.assert_allclose(_np(y_full), _np(torch.cat(ys, 1)),
                               rtol=0.15, atol=0.05)
    np.testing.assert_allclose(_np(st_full.ssm), _np(st.ssm), rtol=0.1,
                               atol=0.05)
    assert torch.equal(st_full.conv, st.conv)


def test_causal_conv_tail_carry(rng):
    K, di, B, L = 4, 6, 2, 10
    x = rng.normal(size=(B, L, di)).astype(np.float32)
    w = rng.normal(size=(K, di)).astype(np.float32)
    b = np.zeros((di,), np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    full, _ = m.causal_conv(tx, tw, tb)
    y1, tail = m.causal_conv(tx[:, :6], tw, tb)
    y2, _ = m.causal_conv(tx[:, 6:], tw, tb, tail)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    jfull, jtail = jm._causal_conv_full(x[:, :6], w, b)
    assert np.array_equal(y1.numpy(), np.asarray(jfull))
    assert np.array_equal(tail.numpy(), np.asarray(jtail))


@pytest.mark.parametrize("L", [16, 21])
def test_mamba_apply_matches_jax(rng, L):
    """The block's full pass (chunk 8: whole and ragged last chunks) and
    three decode steps after it, against the JAX package."""
    jcfg, jp, cfg, block = _block()
    jcfg = dataclasses.replace(jcfg, mamba_chunk=8)
    cfg = dataclasses.replace(cfg, mamba_chunk=8)
    x = rng.normal(size=(2, L + 3, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jy, jst = japply(jp, jx[:, :L], jcfg)
    with torch.no_grad():
        y, st = m.mamba_apply(block, tx[:, :L], cfg)
    assert float(np.abs(np.asarray(jy, np.float32)).max()) > 1e-3
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(_np(st.ssm), _np(jst.ssm), **SSM_TOL)
    assert np.array_equal(_np(st.conv), _np(jst.conv))
    for t in range(L, L + 3):
        jy, jst = japply(jp, jx[:, t:t + 1], jcfg, state=jst, decode=True)
        with torch.no_grad():
            y, st = m.mamba_apply(block, tx[:, t:t + 1], cfg, state=st,
                                  decode=True)
        np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(_np(st.ssm), _np(jst.ssm), **SSM_TOL)
