"""Semi-analytic BER campaign engine: the paper's own measurement, the
post-decode bit error rate of NB-LDPC against Hamming SECDED and a modulo
checksum.

Direct Monte-Carlo at raw BER 1e-5 would need ~10^8 decoded symbols to see a
single residual error, so we use the standard semi-analytic decomposition

    post_BER(eps) = sum_m  Binom(n, eps, m) * r(m)

where r(m) = E[fraction of cells still wrong after decoding | exactly m
injected cell errors], estimated by conditional Monte-Carlo per m. This is
exact in expectation, covers every raw BER with ONE set of decode runs, and
matches how the paper's own low-BER points must have been produced (their
Fig. 6 reaches 1.7e-7).

The engine runs **any scheme** (NB-LDPC via the port's decoder, the
`core.baselines` Hamming SECDED and modulo-parity baselines, or an
unprotected reference) against **any channel model** (`memory.channel`): a
scheme owns its cell geometry (`n_cells` stored cells per codeword,
`n_info` of them data) and reports conditional residuals over both the
whole codeword and the info cells — the paper's figures quote *data* BER,
so comparisons use the info-cell residuals.

The mixing (`binom_pmf`, `mix_post_ber`, `post_ber_from_profile`) is
float64 host math, the JAX package's line for line. The numpy-driven
schemes (Hamming, modulo parity, unprotected) draw what the JAX package
draws. `NBLDPCScheme` draws from a `torch.Generator` (the JAX package
draws from `jax.random`), so its profiles agree in distribution; given the
same corrupted words, `NBLDPCScheme.residuals_of` agrees exactly. It
encodes and decodes on the scheme's device: on the card the `gf_matmul`
kernel encodes and the decoder runs `fbp_cn` and the syndrome scan.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence

import numpy as np
import torch

from ..core.baselines import HammingSECDED, ModuloParity
from ..core.construction import LDPCCode
from ..core.decode import decode_integers
from ..core.encode import encode_words
from ..core.gf import symbol_dtype
from ..device import as_tensor, resolve_device
from .channel import Channel, PlusMinusOne

__all__ = [
    "ResidualProfile", "NBLDPCScheme", "HammingSECDEDScheme",
    "ModuloParityScheme", "UnprotectedScheme", "binom_pmf", "mix_post_ber",
    "default_max_errors", "conditional_residual_profile",
    "post_ber_from_profile", "run_campaign", "paper_schemes",
    "select_acceptance_row",
]


# ---------------------------------------------------------------------------
# residual profiles + the binomial mix
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResidualProfile:
    """Conditional residuals r(m) for m = 0..max_errors of one scheme."""

    name: str
    n_cells: int                      # stored cells per codeword (binomial n)
    n_info: int                       # info cells among them
    r_word: np.ndarray                # residual over all n_cells
    r_info: np.ndarray                # residual over the n_info data cells
    detected: np.ndarray | None = None   # detection coverage per m, if any


def binom_pmf(n: int, eps: float, m: int) -> float:
    if eps <= 0:
        return 1.0 if m == 0 else 0.0
    logp = (math.lgamma(n + 1) - math.lgamma(m + 1) - math.lgamma(n - m + 1)
            + m * math.log(eps) + (n - m) * math.log1p(-eps))
    return math.exp(logp)


def mix_post_ber(n_cells: int, r: np.ndarray, eps: float) -> float:
    """Binomial mix of conditional residuals; the probability mass beyond
    max_errors is charged as a decoder-gives-up upper bound (2*eps residual,
    the convention of the JAX package's committed Fig. 6 benches)."""
    total = 0.0
    for m in range(1, len(r)):
        total += binom_pmf(n_cells, eps, m) * r[m]
    tail = 1.0 - sum(binom_pmf(n_cells, eps, m) for m in range(len(r)))
    total += max(tail, 0.0) * eps * 2
    return max(total, 0.0)


def post_ber_from_profile(prof: ResidualProfile, eps: float,
                          which: str = "info") -> float:
    r = prof.r_info if which == "info" else prof.r_word
    return mix_post_ber(prof.n_cells, r, eps)


# ---------------------------------------------------------------------------
# schemes
# ---------------------------------------------------------------------------

class NBLDPCScheme:
    """The paper's scheme: NB-LDPC over GF(p) + the FBP decoder.

    `channel` picks the fault physics: the default `PlusMinusOne` is the
    paper's ±1 integer-error channel (memory cells holding small integers /
    PIM MAC outputs); any level-domain `memory.channel` model plugs in for
    MLC device studies. Residuals are measured over decoded values in the
    channel's own domain. Words are drawn, encoded and decoded on `device`
    (the card unless the caller passes "cpu").
    """

    analytic = False

    def __init__(self, code: LDPCCode, channel: Channel | None = None, *,
                 n_iters: int = 12, damping: float = 0.3,
                 llv_scale: float = 4.0, llv_mode: str = "manhattan",
                 name: str | None = None, device=None):
        self.code = code
        self.channel = channel if channel is not None else PlusMinusOne(
            0.0, p_field=code.p)
        if self.channel.p != code.p:
            raise ValueError(f"channel alphabet {self.channel.p} != code "
                             f"field GF({code.p})")
        self.n_cells = code.n
        self.n_info = code.k
        self.name = name or f"nbldpc_n{code.n}_r{code.rate:.2f}"
        self.device = resolve_device(device)
        self._decode_kw = dict(n_iters=n_iters, damping=damping,
                               llv_scale=llv_scale, llv_mode=llv_mode,
                               early_exit=True)

    def draw(self, m: int, trials: int, seed: int):
        """(clean codewords, corrupted words), each (trials, n): random info
        words encoded, then exactly m cells of each corrupted by the
        channel, from a generator seeded from (seed, m)."""
        gen = torch.Generator(device=self.device).manual_seed(
            (seed << 8) ^ m)
        code = self.code
        w = torch.randint(0, code.p, (trials, code.k), generator=gen,
                          device=self.device).to(symbol_dtype(code.p))
        cw = encode_words(w, code)
        if self.channel.domain == "integer":
            cw = cw.to(torch.int32)          # ±1 leaves [0, p)
        return cw, self.channel.corrupt_exact(gen, cw, m)

    def residuals_of(self, cw, y) -> tuple[float, float]:
        """Decode the corrupted words `y` and compare with the clean
        codewords `cw`: (residual over all cells, over the info cells).
        Tensors stay on their device; arrays go to the scheme's."""
        dev = cw.device if isinstance(cw, torch.Tensor) else self.device
        cw, y = as_tensor(cw, dev), as_tensor(y, dev)
        y_corr, res = decode_integers(self.code, y, observe=False,
                                      **self._decode_kw)
        # level-domain channels store field symbols, so the decoder's hard
        # symbol decisions are the read-back values; the integer channel
        # compares the arithmetic reinterpretation
        got = res.symbols if self.channel.domain == "level" else y_corr
        wrong = got.to(torch.int64) != cw.to(torch.int64)
        n_word = int(wrong.sum())
        n_info = int(wrong[:, :self.code.k].sum())
        return (n_word / wrong.numel(),
                n_info / (wrong.shape[0] * self.code.k))

    def residuals_at(self, m: int, trials: int, seed: int):
        return self.residuals_of(*self.draw(m, trials, seed))


class HammingSECDEDScheme:
    """Memory-mode bit-level baseline: Hamming(39,32)+parity per stored
    word (ASSCC'21-style). Raw BER is per stored *bit* (39 cells/word)."""

    analytic = False

    def __init__(self, n_data: int = 32, name: str = "hamming_secded"):
        self.impl = HammingSECDED(n_data)
        probe = self.impl.encode(np.zeros((1, n_data), np.int64))
        self.n_cells = probe.shape[-1]
        self.n_info = n_data
        self.name = name

    def residuals_at(self, m: int, trials: int, seed: int):
        rng = np.random.default_rng((seed << 8) ^ m)
        bits = rng.integers(0, 2, (trials, self.n_info))
        word = self.impl.encode(bits)
        for b in range(trials):
            idx = rng.choice(self.n_cells, m, replace=False)
            word[b, idx] ^= 1
        data, _unc = self.impl.decode(word)
        r_info = float((data != bits).mean())
        return r_info, r_info       # only data bits are observable downstream


class ModuloParityScheme:
    """Memory-mode modulo-checksum baseline (ESSCIRC'22-style): one mod-q
    checksum cell per k data cells. In memory mode the checksum cannot
    localize the failing cell without interrupting to re-read, so it is
    detect-only here: residuals equal the injected error fraction and the
    profile additionally records detection coverage per m (host tensors)."""

    analytic = False

    def __init__(self, k_data: int = 32, q: int = 3,
                 name: str = "modulo_parity"):
        self.impl = ModuloParity(q)
        self.n_cells = k_data + 1
        self.n_info = k_data
        self.q = q
        self.name = name

    def residuals_at(self, m: int, trials: int, seed: int):
        r = m / self.n_cells       # errors remain; info cells hit pro rata
        return r, r

    def detection_at(self, m: int, trials: int, seed: int) -> float:
        rng = np.random.default_rng((seed << 8) ^ m)
        W = rng.integers(0, self.q, (trials, self.n_info))
        Y = self.impl.encode_weights(torch.as_tensor(W)).numpy().copy()
        for b in range(trials):
            idx = rng.choice(self.n_cells, m, replace=False)
            Y[b, idx] += rng.choice([-1, 1], m)
        return float(self.impl.detect(torch.as_tensor(Y)).numpy().mean())


class UnprotectedScheme:
    """Reference: no code — post-decode BER equals raw BER analytically."""

    analytic = True
    name = "unprotected"
    n_cells = 1
    n_info = 1

    def post_ber(self, eps: float, which: str = "info") -> float:
        return eps


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

def default_max_errors(n_cells: int, eps_max: float) -> int:
    """Cover the binomial bulk at the largest requested raw BER: mean + 6 sd,
    clamped to [4, n_cells]."""
    mu = n_cells * eps_max
    m = math.ceil(mu + 6.0 * math.sqrt(max(mu, 1.0)))
    return int(np.clip(m, 4, n_cells))


def conditional_residual_profile(scheme, *, max_errors: int = 12,
                                 trials: int = 128,
                                 seed: int = 0) -> ResidualProfile:
    r_word = np.zeros(max_errors + 1)
    r_info = np.zeros(max_errors + 1)
    detected = None
    if hasattr(scheme, "detection_at"):
        detected = np.zeros(max_errors + 1)
    for m in range(1, max_errors + 1):
        r_word[m], r_info[m] = scheme.residuals_at(m, trials, seed)
        if detected is not None:
            detected[m] = scheme.detection_at(m, trials, seed)
    return ResidualProfile(scheme.name, scheme.n_cells, scheme.n_info,
                           r_word, r_info, detected)


def run_campaign(schemes: Sequence, raw_bers: Sequence[float], *,
                 max_errors=None, trials: int = 128, seed: int = 0,
                 hamming_trials: int = 2048) -> dict:
    """Run every scheme over every raw BER. Returns
    {"rows": [...], "profiles": {name: ResidualProfile}} where each row is
    {scheme, raw_ber, post_ber (info cells), post_ber_word, improvement}.

    `max_errors` may be None (auto per scheme from the largest raw BER), an
    int, or a {scheme_name: int} dict. Pure-numpy schemes (Hamming) get
    `hamming_trials` conditional trials — they are orders of magnitude
    cheaper than a decode run.
    """
    eps_max = max(raw_bers)
    rows: list[dict] = []
    profiles: dict[str, ResidualProfile] = {}
    for scheme in schemes:
        if scheme.analytic:
            for eps in raw_bers:
                rows.append({"scheme": scheme.name, "raw_ber": eps,
                             "post_ber": scheme.post_ber(eps),
                             "post_ber_word": scheme.post_ber(eps, "word"),
                             "improvement": 1.0})
            continue
        if isinstance(max_errors, dict):
            M = max_errors.get(scheme.name,
                               default_max_errors(scheme.n_cells, eps_max))
        elif max_errors is None:
            M = default_max_errors(scheme.n_cells, eps_max)
        else:
            M = int(max_errors)
        tr = (hamming_trials if isinstance(scheme, (HammingSECDEDScheme,
                                                    ModuloParityScheme))
              else trials)
        prof = conditional_residual_profile(scheme, max_errors=M, trials=tr,
                                            seed=seed)
        profiles[scheme.name] = prof
        # conditional-MC measurement floor: one residual cell across all
        # trials, pmf-weighted — improvements are reported against it
        floor = 1.0 / (tr * prof.n_cells)
        for eps in raw_bers:
            post = post_ber_from_profile(prof, eps, "info")
            rows.append({
                "scheme": scheme.name, "raw_ber": eps,
                "post_ber": post,
                "post_ber_word": post_ber_from_profile(prof, eps, "word"),
                "improvement": eps / max(post, floor * eps),
                "post_ber_floor": floor * eps,
            })
    return {"rows": rows, "profiles": profiles}


def paper_schemes(code: LDPCCode, *, n_iters: int = 12,
                  damping: float = 0.3, device=None) -> list:
    """The paper-style comparison set: NB-LDPC (this work, decoding on
    `device`) vs Hamming SECDED (memory-mode prior) vs modulo checksum
    (detect-only prior) vs unprotected, all under the ±1 cell-error
    channel."""
    return [
        NBLDPCScheme(code, PlusMinusOne(0.0, p_field=code.p),
                     n_iters=n_iters, damping=damping, device=device),
        HammingSECDEDScheme(),
        ModuloParityScheme(k_data=32, q=code.p),
        UnprotectedScheme(),
    ]


def select_acceptance_row(rows: Sequence[dict], *, nbldpc_prefix: str =
                          "nbldpc", hamming_name: str = "hamming_secded",
                          saturation: float = 3.0) -> dict | None:
    """The paper-style headline point: the largest raw BER at which Hamming
    SECDED has saturated (improvement <= `saturation`, i.e. double-bit
    errors dominate and the code has stopped helping) — report the NB-LDPC
    improvement there. Saturation is contiguous toward high raw BER, so the
    boundary (smallest saturated eps) is where the gap is widest. Returns
    None if Hamming never saturates on the grid."""
    ham = {r["raw_ber"]: r for r in rows if r["scheme"] == hamming_name}
    nb = {r["raw_ber"]: r for r in rows
          if r["scheme"].startswith(nbldpc_prefix)}
    saturated = sorted(e for e, r in ham.items()
                       if r["improvement"] <= saturation and e in nb)
    if not saturated:
        return None
    eps = saturated[0]
    return {
        "raw_ber": eps,
        "hamming_improvement": ham[eps]["improvement"],
        "hamming_post_ber": ham[eps]["post_ber"],
        "nbldpc_improvement": nb[eps]["improvement"],
        "nbldpc_post_ber": nb[eps]["post_ber"],
        "saturation_threshold": saturation,
    }
