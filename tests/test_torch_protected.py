"""Port parity: PIM mode. `protected_pim_matmul` and its budgeted variant
of `repro_torch` against the JAX package on the same inputs. The noise is
drawn once by the reference's own `flip_weights` / `perturb_output` under
a fixed key and handed to the port as flipped weights and an additive
output tensor; `y`, `detected` and `uncorrected` must be exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_code as jget
from repro.core import pim as jpim
from repro.core import protected as jprot
from repro_torch.core import get_code as tget
from repro_torch.core import pim as tpim
from repro_torch.core import protected as tprot
from _torch_threads import torch_threads_per_worker  # noqa: F401


def _case(name, adc, rng, n_in=64, blocks=3, B=8):
    jc = jget(name)
    W = rng.integers(-1, 2, (n_in, blocks * jc.k - 5))   # needs padding
    x = rng.integers(-7, 8, (B, n_in))
    kw = dict(row_parallelism=16, adc_levels=adc, weight_flip_rate=0.004,
              output_error_rate=0.02, p=jc.p)
    return jc, tget(name), W, x, jpim.PIMConfig(**kw), tpim.PIMConfig(**kw)


def _reference_noise(key, W_enc, B, jcfg):
    """The noise the reference's pim_mac draws from `key`, drawn apart."""
    kw, ko = jax.random.split(key)
    Wf = jpim.flip_weights(kw, W_enc, jcfg)
    E = jpim.perturb_output(ko, jnp.zeros((B, W_enc.shape[1]), jnp.int32),
                            jcfg)
    return torch.as_tensor(np.array(Wf)), torch.as_tensor(np.array(E))


def _assert_same(jres, tres):
    for f in ("y", "detected", "uncorrected"):
        assert np.array_equal(np.asarray(getattr(jres, f)),
                              getattr(tres, f).numpy()), f


@pytest.mark.parametrize("name", ["wl40_r08", "wl160_r08_gf5"])
@pytest.mark.parametrize("mode", ["off", "detect", "correct"])
@pytest.mark.parametrize("adc", [0, 6])
def test_protected_pim_matmul_matches_reference(name, mode, adc):
    rng = np.random.default_rng(11)
    jc, tc, W, x, jcfg, tcfg = _case(name, adc, rng)
    prot_kw = dict(mode=mode, n_iters=5, damping=0.3)
    W_enc = jprot.prepare_weights(jnp.asarray(W), jc)
    tW_enc = tprot.prepare_weights(torch.as_tensor(W), tc)
    assert np.array_equal(np.asarray(W_enc), tW_enc.numpy())
    key = jax.random.PRNGKey(4)
    jres = jprot.protected_pim_matmul(jnp.asarray(x), W_enc, jc,
                                      jprot.ProtectionConfig(**prot_kw),
                                      jcfg, key=key)
    Wf, E = _reference_noise(key, W_enc, x.shape[0], jcfg)
    tres = tprot.protected_pim_matmul(torch.as_tensor(x), Wf, tc,
                                      tprot.ProtectionConfig(**prot_kw),
                                      tcfg, out_noise=E)
    _assert_same(jres, tres)
    if mode != "off":
        assert np.asarray(jres.detected).any()


@pytest.mark.parametrize("budget", [2, 64])
def test_budgeted_matches_reference(budget):
    rng = np.random.default_rng(12)
    jc, tc, W, x, jcfg, tcfg = _case("wl40_r08", 0, rng, blocks=4, B=10)
    prot_kw = dict(n_iters=5, damping=0.3)
    W_enc = jprot.prepare_weights(jnp.asarray(W), jc)
    key = jax.random.PRNGKey(9)
    jres = jprot.protected_pim_matmul_budgeted(
        jnp.asarray(x), W_enc, jc, jprot.ProtectionConfig(**prot_kw), jcfg,
        key=key, budget=budget)
    Wf, E = _reference_noise(key, W_enc, x.shape[0], jcfg)
    tres = tprot.protected_pim_matmul_budgeted(
        torch.as_tensor(x), Wf, tc, tprot.ProtectionConfig(**prot_kw), tcfg,
        budget=budget, out_noise=E)
    _assert_same(jres, tres)
    n_flagged = int(np.asarray(jres.detected).sum())
    assert n_flagged > 2                 # the small budget overflows
    if budget == 2:
        assert tres.uncorrected.sum() >= n_flagged - 2


def test_strip_padding_and_correction_lowers_error(rng):
    """Own-noise run of the port: correction brings the output back to
    x @ W where the raw MAC had errors."""
    tc = tget("wl320_r08")
    W = torch.as_tensor(rng.integers(-1, 2, (64, 250)))
    x = torch.as_tensor(rng.integers(-7, 8, (64, 64)))
    cfg = tpim.PIMConfig(row_parallelism=16, output_error_rate=2e-3)
    W_enc = tprot.prepare_weights(W, tc)
    exact = x @ W
    out = {}
    for mode in ("off", "correct"):
        gen = torch.Generator().manual_seed(0)
        r = tprot.protected_pim_matmul(
            x, W_enc, tc, tprot.ProtectionConfig(mode=mode), cfg,
            generator=gen)
        out[mode] = (tprot.strip_padding(r.y, 250) != exact).float().mean()
    assert out["correct"] < out["off"]


@pytest.mark.parametrize("p", [3, 5])
def test_pim_noise_models_rates(p):
    """The port's own noise draws: flips land on another centered symbol
    at the configured rate; output errors are ±mag at theirs."""
    cfg = tpim.PIMConfig(weight_flip_rate=0.1, output_error_rate=0.05,
                         output_error_mag=2, p=p)
    gen = torch.Generator().manual_seed(1)
    W = torch.zeros((200, 200), dtype=torch.int64)
    Wf = tpim.flip_weights(gen, W, cfg)
    flipped = Wf != 0
    assert abs(flipped.float().mean().item() - 0.1) < 0.01
    assert (Wf.abs() <= p // 2).all()
    Y = tpim.perturb_output(gen, torch.zeros((200, 200), dtype=torch.int32),
                            cfg)
    hit = Y != 0
    assert abs(hit.float().mean().item() - 0.05) < 0.01
    assert set(Y[hit].unique().tolist()) == {-2, 2}
