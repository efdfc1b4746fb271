"""RAS (reliability / availability / serviceability) estimators.

The observability layer's third pillar, the port of the JAX package's
`repro.obs.ras` (standard library only; fed the same observations in the
same batches, its estimates are the same numbers). It turns the raw reliability signals
the stack already produces — per-page syndrome-scan flags and per-codeword
`DecodeResult.iterations` vectors — into *running estimates* that a scrub
scheduler can act on.

Estimated quantities, per region (a region is any string key — a pool
owner/tenant label, a layer name, or the default ""):

- **word flag rate** `f` — EWMA of the fraction of codewords whose
  syndrome scan flagged them dirty. A word is flagged when *any* of its n
  symbols is corrupted, so for an i.i.d. symbol channel
  ``f = 1 - (1 - ber)**n`` and the raw symbol BER is recovered as
  ``ber = 1 - (1 - f)**(1/n) ≈ -ln(1 - f)/n``.
- **decoder stress** — EWMA of FBP iterations used, normalized by the
  iteration cap. Near 0: corrections are easy (few symbol errors per
  word); near 1: words routinely hit the cap, i.e. the code is operating
  near its correction limit and residual errors are imminent. This is the
  early-warning signal the raw BER alone can't give (BER says how often
  words are dirty; stress says how *close to uncorrectable* dirty words
  are).
- **residual-BER proxy** — EWMA rate of `detect_fail` words times an
  upper-bound symbol fraction. Words the decoder failed on are the only
  ones that can leak errors downstream, so this tracks the post-correction
  (data) BER without needing ground truth.

`adaptive_interval()` maps the estimates onto a scrub period: scale a
nominal interval inversely with observed word-flag pressure (clamped), and
tighten further when decoder stress is high. `hot_regions()` ranks regions
by pressure so a sweeper can spend its page budget where flags are
actually landing (`ProtectedPagePool.scrub(prioritize=True)` consumes the
same idea per page).

Ambient installation mirrors `use_metrics`: instrumented layers call
`current().observe_scan(...)` — the default `NULL_ESTIMATOR` drops
everything at the cost of one attribute check.

All estimates are EWMAs with per-update decay ``alpha``; feeding k
observations in one call uses the exact k-step decay ``(1-alpha)**k`` so
batched and one-at-a-time feeding converge identically.
"""
from __future__ import annotations

import contextlib
import math

__all__ = ["ErrorRateEstimator", "RegionEstimate", "NULL_ESTIMATOR",
           "current", "use_estimator"]


class RegionEstimate:
    """Running EWMA state for one region (tenant / layer / pool owner)."""

    __slots__ = ("flag_rate", "stress", "fail_rate", "words_seen",
                 "words_flagged", "decode_words", "decode_fails", "_n_symbols")

    def __init__(self):
        self.flag_rate: float | None = None      # EWMA word flag rate
        self.stress: float | None = None         # EWMA iterations / cap
        self.fail_rate: float | None = None      # EWMA detect_fail rate
        self.words_seen = 0
        self.words_flagged = 0
        self.decode_words = 0
        self.decode_fails = 0
        self._n_symbols: int | None = None

    def _fold(self, prev: float | None, obs: float, alpha: float,
              k: int) -> float:
        if prev is None:
            return obs
        keep = (1.0 - alpha) ** k
        return keep * prev + (1.0 - keep) * obs

    # -- derived quantities --------------------------------------------------

    def raw_ber(self) -> float | None:
        """Per-symbol raw BER inverted from the word flag rate: a word is
        flagged iff >=1 of its n symbols flipped, so for an i.i.d. channel
        ber = 1 - (1 - f)^(1/n)."""
        if self.flag_rate is None or self._n_symbols in (None, 0):
            return None
        f = min(max(self.flag_rate, 0.0), 1.0 - 1e-12)
        return 1.0 - (1.0 - f) ** (1.0 / self._n_symbols)

    def residual_ber_proxy(self) -> float | None:
        """Upper-bound proxy for post-correction data BER: only
        detect_fail words can leak symbol errors, and at the operating
        point a failed word carries at most ~its raw symbol error
        fraction."""
        if self.fail_rate is None:
            return None
        ber = self.raw_ber()
        return self.fail_rate * (ber if ber is not None else 1.0)

    def export(self) -> dict:
        return {
            "flag_rate": self.flag_rate, "stress": self.stress,
            "fail_rate": self.fail_rate, "raw_ber": self.raw_ber(),
            "residual_ber_proxy": self.residual_ber_proxy(),
            "words_seen": self.words_seen,
            "words_flagged": self.words_flagged,
            "decode_words": self.decode_words,
            "decode_fails": self.decode_fails,
        }


class _NullEstimator:
    """Ambient default: drops all observations."""

    enabled = False

    def observe_scan(self, flagged: int, total: int, *,
                     n_symbols: int | None = None,
                     region: str = "") -> None:
        pass

    def observe_decode(self, iterations, n_iters: int, *,
                       detect_fail=None, region: str = "") -> None:
        pass

    def adaptive_interval(self, nominal: int, *, region: str = "") -> int:
        return nominal


NULL_ESTIMATOR = _NullEstimator()


class ErrorRateEstimator:
    """Folds scan flags and decode telemetry into per-region EWMA
    reliability estimates, and maps them onto a scrub schedule.

    alpha: EWMA decay per observed *word* (small alpha = long memory).
    target_flag_rate: the word flag rate the scrub schedule aims to hold;
        above it the adaptive interval shrinks proportionally, below it
        the interval relaxes back toward nominal.
    stress_threshold: normalized decoder-iteration level past which the
        interval is tightened a further 2x (words near the correction
        limit — scrub before they tip into detect_fail).
    """

    enabled = True

    def __init__(self, *, alpha: float = 0.02,
                 target_flag_rate: float = 0.05,
                 stress_threshold: float = 0.7,
                 min_scale: float = 0.1, max_scale: float = 4.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.target_flag_rate = target_flag_rate
        self.stress_threshold = stress_threshold
        self.min_scale = min_scale
        self.max_scale = max_scale
        self._regions: dict[str, RegionEstimate] = {}

    def region(self, region: str = "") -> RegionEstimate:
        est = self._regions.get(region)
        if est is None:
            est = self._regions[region] = RegionEstimate()
        return est

    # -- observation feeds ---------------------------------------------------

    def observe_scan(self, flagged: int, total: int, *,
                     n_symbols: int | None = None,
                     region: str = "") -> None:
        """Feed one syndrome-scan outcome: `flagged` of `total` codewords
        were dirty. `n_symbols` (codeword length n) enables raw-BER
        inversion."""
        total = int(total)
        if total <= 0:
            return
        flagged = int(flagged)
        est = self.region(region)
        if n_symbols:
            est._n_symbols = int(n_symbols)
        est.words_seen += total
        est.words_flagged += flagged
        est.flag_rate = est._fold(est.flag_rate, flagged / total,
                                  self.alpha, total)

    def observe_decode(self, iterations, n_iters: int, *,
                       detect_fail=None, region: str = "") -> None:
        """Feed a decode outcome: `iterations` is a per-codeword iteration
        count (scalar, sequence, numpy array or torch tensor —
        `DecodeResult.iterations` feeds straight in), `n_iters` the
        decoder's cap, `detect_fail` an optional parallel bool vector."""
        vals = _as_float_list(iterations)
        if not vals or n_iters <= 0:
            return
        est = self.region(region)
        k = len(vals)
        est.decode_words += k
        mean_stress = min(sum(vals) / (k * n_iters), 1.0)
        est.stress = est._fold(est.stress, mean_stress, self.alpha, k)
        if detect_fail is not None:
            fails = _as_float_list(detect_fail)
            n_fail = sum(1.0 for v in fails if v)
            est.decode_fails += int(n_fail)
            est.fail_rate = est._fold(est.fail_rate, n_fail / k,
                                      self.alpha, k)

    # -- scheduling ----------------------------------------------------------

    def pressure(self, region: str = "") -> float:
        """Scalar scrub pressure >= 0: observed flag rate over target,
        doubled when decoder stress crosses the threshold. 1.0 = on
        target; >1 = scrub more; <1 = can relax."""
        est = self._regions.get(region)
        if est is None or est.flag_rate is None:
            return 1.0
        pr = est.flag_rate / max(self.target_flag_rate, 1e-12)
        if est.stress is not None and est.stress >= self.stress_threshold:
            pr *= 2.0
        return pr

    def adaptive_interval(self, nominal: int, *, region: str = "") -> int:
        """Scrub period (steps/seconds — caller's unit) scaled inversely
        with pressure and clamped to [min_scale, max_scale] x nominal.
        With no observations yet, returns `nominal` unchanged."""
        nominal = int(nominal)
        if nominal <= 0:
            return nominal
        pr = self.pressure(region)
        scale = 1.0 / max(pr, 1e-12)
        scale = min(max(scale, self.min_scale), self.max_scale)
        return max(1, int(round(nominal * scale)))

    def hot_regions(self, top: int | None = None
                    ) -> list[tuple[str, float]]:
        """Regions ranked by scrub pressure, hottest first."""
        ranked = sorted(((r, self.pressure(r)) for r in self._regions),
                        key=lambda kv: (-kv[1], kv[0]))
        return ranked[:top] if top is not None else ranked

    def snapshot(self) -> dict:
        """{region: estimates} — JSON-stable (None for not-yet-observed)."""
        return {r: est.export()
                for r, est in sorted(self._regions.items())}

    def publish(self, registry, *, layer: str = "ras") -> None:
        """Push current estimates into a `MetricsRegistry` as gauges."""
        if registry is None or not getattr(registry, "enabled", False):
            return
        for region, est in self._regions.items():
            for field in ("flag_rate", "stress", "fail_rate"):
                v = getattr(est, field)
                if v is not None:
                    registry.gauge(f"ras_{field}", layer=layer,
                                   region=region).set(v)
            ber = est.raw_ber()
            if ber is not None:
                registry.gauge("ras_raw_ber", layer=layer,
                               region=region).set(ber)
            res = est.residual_ber_proxy()
            if res is not None:
                registry.gauge("ras_residual_ber_proxy", layer=layer,
                               region=region).set(res)


def _as_float_list(x) -> list[float]:
    """Coerce scalar / sequence / numpy array / torch tensor to a flat float
    list through its `tolist()` (for a CUDA tensor, one host read, paid
    only when an estimator is installed)."""
    if x is None:
        return []
    tolist = getattr(x, "tolist", None)
    if tolist is not None:
        x = tolist()
    if isinstance(x, (int, float, bool)):
        return [float(x)]
    try:
        out: list[float] = []
        for v in x:
            if isinstance(v, (list, tuple)):
                out.extend(float(u) for u in v)
            else:
                out.append(float(v))
        return out
    except TypeError:
        return [float(x)]


def expected_flag_rate(channel_T, n_symbols: int) -> float:
    """Closed-form word flag rate for an i.i.d. `LevelTransition` matrix:
    per-symbol error prob eps = 1 - mean(diag(T)) (uniform level prior),
    word flag rate = 1 - (1 - eps)^n. Test/calibration helper."""
    diag = [channel_T[i][i] for i in range(len(channel_T))]
    eps = 1.0 - sum(float(d) for d in diag) / len(diag)
    return 1.0 - (1.0 - eps) ** n_symbols


def invert_flag_rate(flag_rate: float, n_symbols: int) -> float:
    """ber = 1 - (1-f)^(1/n), the small-f limit of -ln(1-f)/n."""
    f = min(max(flag_rate, 0.0), 1.0 - 1e-12)
    return 1.0 - math.exp(math.log1p(-f) / n_symbols)


# ---------------------------------------------------------------------------
# ambient estimator
# ---------------------------------------------------------------------------

_current = NULL_ESTIMATOR


def current():
    return _current


@contextlib.contextmanager
def use_estimator(estimator: ErrorRateEstimator | None = None):
    """Install `estimator` as the ambient RAS sink for the block (a fresh
    `ErrorRateEstimator` when called with None). Yields the estimator."""
    global _current
    est = ErrorRateEstimator() if estimator is None else estimator
    prev = _current
    _current = est
    try:
        yield est
    finally:
        _current = prev
