"""Port parity: the baseline ECCs (`repro_torch.core.baselines`), the
channels' exact-m sampler and `PlusMinusOne`, and the BER campaign
(`repro_torch.memory.campaign`) against the JAX package on the CPU.

Exact:
- Hamming SECDED encode/decode, the modulo checksum and successive
  correction on identical inputs;
- `binom_pmf`, `mix_post_ber` and `post_ber_from_profile` (the same
  float64 host math);
- whole residual profiles and campaign rows of the Hamming, modulo-parity
  and unprotected schemes (both draw from numpy with the same seeds);
- `NBLDPCScheme.residuals_of` on the words the JAX package's
  `residuals_at` draws (its draw rebuilt here from the same key), float
  for float.

The port's NB-LDPC scheme draws from torch, not from `jax.random`, so its
own campaign is held to the JAX package's assertions on its own draws
(the mirrors below), not to its numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encode_words as jencode_words
from repro.core import get_code as jget
from repro.core import baselines as jbase
from repro.memory import campaign as jcamp
from repro.memory import PlusMinusOne as JPlusMinusOne
from repro.memory import asymmetric_adjacent as jasym
from repro_torch.core import baselines as tbase
from repro_torch.core import get_code as tget
from repro_torch.memory import campaign as tcamp
from repro_torch.memory import (PlusMinusOne, asymmetric_adjacent,
                                paper_schemes, run_campaign,
                                select_acceptance_row, uniform_flip)
from _torch_threads import torch_threads_per_worker  # noqa: F401

LEVELS = torch.as_tensor(np.random.default_rng(0).integers(0, 3, (32, 80)),
                         dtype=torch.int32)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------


def test_hamming_secded_matches_reference(rng):
    bits = rng.integers(0, 2, (50, 32))
    jw, tw = jbase.HammingSECDED().encode(bits), \
        tbase.HammingSECDED().encode(bits)
    np.testing.assert_array_equal(tw, jw)
    word = jw.copy()
    for i in range(50):                     # 0, 1 or 2 flips per word
        word[i, rng.choice(39, i % 3, replace=False)] ^= 1
    for a, b in zip(tbase.HammingSECDED().decode(word.copy()),
                    jbase.HammingSECDED().decode(word.copy()), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [3, 5])
def test_modulo_parity_matches_reference(q, rng):
    W = rng.integers(-2, 3, (16, 8))
    jm, tm = jbase.ModuloParity(q), tbase.ModuloParity(q)
    We = tm.encode_weights(torch.as_tensor(W))
    np.testing.assert_array_equal(We.numpy(),
                                  np.asarray(jm.encode_weights(jnp.asarray(W))))
    x = rng.integers(-1, 2, (32, 16))
    Y = x @ We.numpy()
    Y[rng.random(Y.shape) < 0.05] += rng.choice([-2, -1, 1, 2])
    np.testing.assert_array_equal(tm.detect(torch.as_tensor(Y)).numpy(),
                                  np.asarray(jm.detect(jnp.asarray(Y))))
    for a, b in zip(tm.correct(torch.as_tensor(Y)),
                    jm.correct(jnp.asarray(Y)), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("max_rereads", [1, 3])
def test_successive_correction_matches_reference(max_rereads, rng):
    W = rng.integers(-1, 2, (16, 10))
    x = rng.integers(-7, 8, (6, 16))
    Y = x @ W
    Y[0, 1] += 1
    Y[2, 5] -= 1
    Y[4, 7] += 2
    tY, tn = tbase.SuccessiveCorrection(max_rereads=max_rereads).correct(
        torch.as_tensor(x), torch.as_tensor(W), torch.as_tensor(Y))
    jY, jn = jbase.SuccessiveCorrection(max_rereads=max_rereads).correct(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(Y))
    np.testing.assert_array_equal(tY.numpy(), np.asarray(jY))
    assert int(tn) == int(jn) == min(3, max_rereads)


# the JAX package's own baseline cases (tests/test_substrate.py), on the
# port's tensors


def test_hamming_secded_corrects_single_detects_double(rng):
    h = tbase.HammingSECDED()
    bits = rng.integers(0, 2, (20, 32))
    word = h.encode(bits)
    w1 = word.copy()
    for i in range(20):
        w1[i, rng.integers(0, w1.shape[1] - 1)] ^= 1
    dec, unc = h.decode(w1)
    assert (dec == bits).all() and not unc.any()
    w2 = word.copy()
    w2[:, 3] ^= 1
    w2[:, 9] ^= 1
    _, unc2 = h.decode(w2)
    assert unc2.all()


def test_modulo_parity_detects(rng):
    mp = tbase.ModuloParity(q=3)
    W = torch.as_tensor(rng.integers(-1, 2, (16, 8)), dtype=torch.int32)
    We = mp.encode_weights(W)
    x = torch.as_tensor(rng.integers(-1, 2, (4, 16)), dtype=torch.int32)
    Y = x @ We
    assert not mp.detect(Y).any()
    Yb = Y.clone()
    Yb[1, 2] += 1
    assert mp.detect(Yb).any()


def test_successive_correction_fixes_up_to_budget(rng):
    sc = tbase.SuccessiveCorrection(max_rereads=3)
    W = torch.as_tensor(rng.integers(-1, 2, (16, 10)), dtype=torch.int32)
    x = torch.as_tensor(rng.integers(-1, 2, (4, 16)), dtype=torch.int32)
    Y = x @ W
    Yb = Y.clone()
    Yb[0, 1] += 1
    Yb[2, 5] -= 1
    Yf, n = sc.correct(x, W, Yb)
    assert torch.equal(Yf, Y)
    assert int(n) == 2


# ---------------------------------------------------------------------------
# channels: the exact-m sampler and the integer channel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ch", [asymmetric_adjacent(3, 0.04, 0.01),
                                uniform_flip(3, 0.05)])
def test_corrupt_exact_changes_exactly_m_cells(ch):
    y = ch.corrupt_exact(torch.Generator().manual_seed(5), LEVELS, 7)
    assert ((y != LEVELS).sum(dim=1) == 7).all()
    assert ch.domain == "level"
    assert y.dtype == LEVELS.dtype and int(y.min()) >= 0 \
        and int(y.max()) < 3


def test_corrupt_exact_values_follow_the_off_diagonal():
    """Adjacent-only errors: a changed cell moves one level; an absorbing
    level with no off-diagonal mass (RetentionDrift's rest level) stays."""
    from repro_torch.memory import RetentionDrift
    y = asymmetric_adjacent(3, 0.04, 0.01).corrupt_exact(
        torch.Generator().manual_seed(1), LEVELS, 20)
    assert ((y - LEVELS).abs() <= 1).all()
    words = torch.zeros((8, 30), dtype=torch.int32)
    z = RetentionDrift(3, rate=1.0, rest_level=0).corrupt_exact(
        torch.Generator().manual_seed(2), words, 5, t=1.0)
    assert torch.equal(z, words)


def test_plusminusone_is_integer_domain():
    ch = PlusMinusOne(0.5)
    assert ch.domain == "integer" and ch.p == 3 and ch.error_rate() == 0.5
    y = torch.zeros((8, 50), dtype=torch.int32)
    out = ch.apply(torch.Generator().manual_seed(0), y)
    assert set(out.unique().tolist()) <= {-1, 0, 1}
    exact = ch.corrupt_exact(torch.Generator().manual_seed(1), y, 4)
    assert (exact.abs().sum(dim=1) == 4).all()


def test_plusminusone_rates():
    """The port's own draws: hits at eps, +1 at `up`."""
    ch = PlusMinusOne(0.2, up=0.8)
    out = ch.apply(torch.Generator().manual_seed(3),
                   torch.zeros((200, 500), dtype=torch.int32))
    hit = out != 0
    assert abs(float(hit.float().mean()) - 0.2) < 0.005
    assert abs(float((out[hit] == 1).float().mean()) - 0.8) < 0.01


# ---------------------------------------------------------------------------
# the semi-analytic mix and the numpy-driven schemes
# ---------------------------------------------------------------------------


def test_mixing_math_is_the_reference(rng):
    for n, eps, m in [(1024, 1e-2, 3), (39, 1e-5, 0), (320, 0.0, 0),
                      (320, 0.0, 2), (33, 3e-2, 33)]:
        assert tcamp.binom_pmf(n, eps, m) == jcamp.binom_pmf(n, eps, m)
    r = np.concatenate([[0.0], rng.random(12) * 1e-2])
    prof_kw = dict(name="x", n_cells=1024, n_info=819, r_word=r,
                   r_info=r[::-1].copy())
    tp, jp = tcamp.ResidualProfile(**prof_kw), jcamp.ResidualProfile(**prof_kw)
    for eps in [3e-2, 1e-2, 1e-3, 1e-5, 0.0]:
        assert tcamp.mix_post_ber(1024, r, eps) == \
            jcamp.mix_post_ber(1024, r, eps)
        for which in ("info", "word"):
            assert tcamp.post_ber_from_profile(tp, eps, which) == \
                jcamp.post_ber_from_profile(jp, eps, which)
    for n, e in [(1024, 3e-2), (39, 1e-5), (33, 0.5)]:
        assert tcamp.default_max_errors(n, e) == \
            jcamp.default_max_errors(n, e)


def _same_profile(a, b):
    assert (a.name, a.n_cells, a.n_info) == (b.name, b.n_cells, b.n_info)
    np.testing.assert_array_equal(a.r_word, b.r_word)
    np.testing.assert_array_equal(a.r_info, b.r_info)
    if b.detected is None:
        assert a.detected is None
    else:
        np.testing.assert_array_equal(a.detected, b.detected)


def test_numpy_schemes_profiles_and_rows_are_the_reference():
    tschemes = [tcamp.HammingSECDEDScheme(), tcamp.ModuloParityScheme(),
                tcamp.UnprotectedScheme()]
    jschemes = [jcamp.HammingSECDEDScheme(), jcamp.ModuloParityScheme(),
                jcamp.UnprotectedScheme()]
    for ts, js in zip(tschemes[:2], jschemes[:2], strict=True):
        _same_profile(
            tcamp.conditional_residual_profile(ts, max_errors=5, trials=64,
                                               seed=3),
            jcamp.conditional_residual_profile(js, max_errors=5, trials=64,
                                               seed=3))
    bers = [2e-2, 1e-2, 1e-3, 1e-4]
    tout = run_campaign(tschemes, bers, hamming_trials=256, seed=1)
    jout = jcamp.run_campaign(jschemes, bers, hamming_trials=256, seed=1)
    assert tout["rows"] == jout["rows"]
    assert tout["profiles"].keys() == jout["profiles"].keys()
    for name in jout["profiles"]:
        _same_profile(tout["profiles"][name], jout["profiles"][name])
    assert select_acceptance_row(tout["rows"]) == \
        jcamp.select_acceptance_row(jout["rows"])


# ---------------------------------------------------------------------------
# NB-LDPC residuals on the JAX package's own words
# ---------------------------------------------------------------------------


def _jax_draw(scheme, m, trials, seed):
    """`repro.memory.campaign.NBLDPCScheme.residuals_at`'s draw, rebuilt."""
    code = scheme.code
    key = jax.random.fold_in(jax.random.PRNGKey(seed), m)
    kw, kc = jax.random.split(key)
    w = jax.random.randint(kw, (trials, code.k), 0, code.p, jnp.int32)
    cw = jencode_words(w, code)
    return np.array(cw), np.array(scheme.channel.corrupt_exact(kc, cw, m))


@pytest.mark.parametrize("name,channel,ms", [
    ("wl80_r08", "pm1", (1, 3, 6, 10)),
    ("wl40_r08", "adjacent", (1, 4, 8)),
])
def test_nbldpc_residuals_of_reference_words(name, channel, ms):
    if channel == "pm1":
        jch, tch = JPlusMinusOne(0.0), PlusMinusOne(0.0)
    else:
        jch, tch = jasym(3, 0.7, 0.3), asymmetric_adjacent(3, 0.7, 0.3)
    js = jcamp.NBLDPCScheme(jget(name), jch, n_iters=8)
    ts = tcamp.NBLDPCScheme(tget(name), tch, n_iters=8, device="cpu")
    assert (ts.name, ts.n_cells, ts.n_info) == (js.name, js.n_cells,
                                                js.n_info)
    trials, seed = 16, 2
    got = []
    for m in ms:
        cw, y = _jax_draw(js, m, trials, seed)
        want = js.residuals_at(m, trials, seed)
        r = ts.residuals_of(cw, y)
        assert r == want, (m, r, want)
        got.append(r[0])
    assert got[-1] > 0.0                        # past the code's strength


def test_nbldpc_scheme_draws_on_its_own_generator():
    """The port's draw: exactly m cells off the clean codewords, the
    same words again from the same (seed, m), other words from another."""
    s = tcamp.NBLDPCScheme(tget("wl40_r08"), device="cpu")
    cw, y = s.draw(5, 8, 0)
    assert cw.shape == y.shape == (8, 40)
    assert ((y != cw).sum(dim=1) == 5).all()
    assert ((y - cw).abs() <= 1).all()
    cw2, y2 = s.draw(5, 8, 0)
    assert torch.equal(cw, cw2) and torch.equal(y, y2)
    assert not torch.equal(s.draw(6, 8, 0)[0], cw)
    with pytest.raises(ValueError, match="alphabet"):
        tcamp.NBLDPCScheme(tget("wl40_r08"), uniform_flip(5, 0.1),
                           device="cpu")


# ---------------------------------------------------------------------------
# the JAX package's campaign checks (tests/test_memory.py), on the port's
# own draws and sizes of the reference
# ---------------------------------------------------------------------------


def test_campaign_reproduces_paper_style_comparison():
    """At a raw BER where Hamming SECDED has saturated, NB-LDPC still
    improves >= 10x over unprotected."""
    code = tget("wl256_r08")
    out = run_campaign(paper_schemes(code, device="cpu"),
                       [2e-2, 1e-2, 1e-3, 1e-4], trials=24,
                       hamming_trials=512, seed=0)
    rows = out["rows"]
    by = {(r["scheme"], r["raw_ber"]): r for r in rows}
    assert by[("hamming_secded", 1e-4)]["improvement"] > 50
    assert by[("hamming_secded", 1e-2)]["improvement"] < 3
    assert by[("modulo_parity", 1e-3)]["improvement"] == pytest.approx(1.0)
    acc = select_acceptance_row(rows)
    assert acc is not None
    assert acc["nbldpc_improvement"] >= 10.0


def test_campaign_runs_level_domain_channels():
    """Any-channel support: the same engine runs an MLC level-transition
    channel instead of the ±1 integer channel."""
    sch = tcamp.NBLDPCScheme(tget("wl80_r08"), asymmetric_adjacent(3, 0.7,
                                                                    0.3),
                             n_iters=8, device="cpu")
    r_word, r_info = sch.residuals_at(1, trials=16, seed=0)
    assert r_word == 0.0                        # single error always fixed
    r_word8, _ = sch.residuals_at(16, trials=16, seed=0)
    assert r_word8 > 0.0                        # way past the strength
