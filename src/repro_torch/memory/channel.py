"""Composable MLC memristor channel models (memory mode, paper §3.1/§3.3).

In memory mode the stored cells themselves degrade. Multi-level cells fail
in structured, asymmetric ways the uniform symbol-flip model cannot
express:

- **level-transition errors** — adjacent-level confusion with different
  up/down probabilities (programming variance, conductance overlap);
- **retention drift** — conductance relaxes toward a rest level over time,
  so the error rate grows with storage age `t`;
- **read disturb** — every read nudges cells toward higher conductance, so
  the error rate grows with the read count `n_reads`;
- **stuck-at cells** — a static population of dead cells pinned to one level.

Every model is a frozen dataclass with an `apply(generator, levels, *, t,
n_reads)` method driven by an explicit `torch.Generator` on the levels'
device: same generator state, same faults. The models match the JAX
package's `repro.memory.channel` in distribution, not in bits (the two
random streams differ). Levels live in `[0, p)`. `PlusMinusOne` is the one
*integer-domain* channel (PIM MAC outputs, unbounded integers);
`ProtectedMemoryArray` only accepts level-domain channels.

Matrix-backed channels expose their per-cell level-transition matrix via
`transition(t, n_reads)` — a (p, p) row-stochastic matrix validated at
construction — which the semi-analytic BER campaign uses to draw
conditional error values (`corrupt_exact`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Channel", "LevelTransition", "RetentionDrift", "ReadDisturb",
           "StuckAt", "Compose", "PlusMinusOne", "uniform_flip",
           "asymmetric_adjacent", "validate_transition"]


def validate_transition(T: np.ndarray, atol: float = 1e-6) -> np.ndarray:
    """Validate a level-transition matrix: square, non-negative entries,
    rows summing to 1 (row-stochastic). Returns the matrix as float64."""
    T = np.asarray(T, np.float64)
    if T.ndim != 2 or T.shape[0] != T.shape[1]:
        raise ValueError(f"transition matrix must be square, got {T.shape}")
    if (T < -atol).any():
        raise ValueError("transition matrix has negative entries")
    rows = T.sum(axis=1)
    if not np.allclose(rows, 1.0, atol=atol):
        raise ValueError(f"transition matrix rows must sum to 1, got {rows}")
    return np.clip(T, 0.0, None)


def _sample_rows(generator: torch.Generator, T: np.ndarray,
                 levels: torch.Tensor) -> torch.Tensor:
    """Sample next levels: one draw per cell from T[levels[...]] — the
    count of cdf entries of the cell's row below a uniform draw. The count
    stops at p-1, which guards the row-sum tolerance of
    validate_transition."""
    p = T.shape[0]
    cdf = torch.as_tensor(np.cumsum(T, axis=1), dtype=torch.float32,
                          device=levels.device)
    u = torch.rand(levels.shape, generator=generator, device=levels.device)
    lv = levels.to(torch.int32)
    out = torch.zeros_like(levels)
    for j in range(p - 1):
        out += (u > cdf[:, j][lv]).to(levels.dtype)
    return out


def _positions(generator: torch.Generator, words: torch.Tensor,
               m: int) -> torch.Tensor:
    """(B, m) distinct cell positions per row: the first m of a uniform
    random permutation of each row's n cells."""
    B, n = words.shape
    u = torch.rand((B, n), generator=generator, device=words.device)
    return torch.argsort(u, dim=1)[:, :m]


class Channel:
    """Base class: a stochastic map on stored cell levels."""

    domain = "level"            # "level" (cells in [0,p)) | "integer"

    @property
    def p(self) -> int:
        raise NotImplementedError

    def apply(self, generator: torch.Generator, levels: torch.Tensor, *,
              t: float = 0.0, n_reads: int = 0) -> torch.Tensor:
        """Corrupt `levels` (any shape). Deterministic given the
        generator's state."""
        raise NotImplementedError

    def transition(self, t: float = 0.0, n_reads: int = 0) -> np.ndarray:
        """(p, p) row-stochastic per-cell transition matrix, when the model
        is i.i.d. per cell. Channels without one raise TypeError."""
        raise TypeError(f"{type(self).__name__} has no per-cell transition "
                        "matrix (stateful/correlated channel)")

    def error_rate(self, *, t: float = 0.0, n_reads: int = 0) -> float:
        """Marginal per-cell error probability under a uniform level prior."""
        T = self.transition(t, n_reads)
        return float(1.0 - np.diag(T).mean())

    def corrupt_exact(self, generator: torch.Generator, words: torch.Tensor,
                      m: int, *, t: float = 0.0,
                      n_reads: int = 0) -> torch.Tensor:
        """Corrupt exactly `m` distinct cells per word (rows of `words`),
        drawing wrong values from this channel's conditional-on-error
        distribution: the row-normalised off-diagonal of `transition`
        (a level with no off-diagonal mass, e.g. an absorbing one, stays
        put). This is the sampler behind the semi-analytic BER campaign
        (post_BER = sum_m Binom(n, eps, m) * r(m))."""
        T = self.transition(t, n_reads)
        p = T.shape[0]
        E = T.copy()
        np.fill_diagonal(E, 0.0)
        rowsum = E.sum(axis=1, keepdims=True)
        safe = rowsum > 0
        E = np.where(safe, E / np.where(safe, rowsum, 1.0), np.eye(p))
        pos = _positions(generator, words, m)                    # (B, m)
        new = _sample_rows(generator, E, torch.gather(words, 1, pos))
        return words.scatter(1, pos, new)


@dataclasses.dataclass(frozen=True)
class LevelTransition(Channel):
    """General i.i.d. per-cell channel defined by a (p, p) row-stochastic
    level-transition matrix T: P(read level j | stored level i) = T[i, j]."""

    T: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "T", validate_transition(self.T))

    @property
    def p(self) -> int:
        return self.T.shape[0]

    def transition(self, t: float = 0.0, n_reads: int = 0) -> np.ndarray:
        return self.T

    def apply(self, generator, levels, *, t=0.0, n_reads=0):
        return _sample_rows(generator, self.T, levels)


def uniform_flip(p: int, eps: float) -> LevelTransition:
    """Uniform symbol-flip: with prob eps, replace with a uniformly random
    *other* level."""
    T = np.full((p, p), eps / (p - 1))
    np.fill_diagonal(T, 1.0 - eps)
    return LevelTransition(T)


def asymmetric_adjacent(p: int, eps_up: float, eps_down: float
                        ) -> LevelTransition:
    """Adjacent-level confusion with asymmetric up/down rates — the dominant
    MLC memristor read-error mode. Boundary levels only err inward."""
    T = np.eye(p)
    for i in range(p):
        up = eps_up if i + 1 < p else 0.0
        down = eps_down if i > 0 else 0.0
        T[i, i] = 1.0 - up - down
        if i + 1 < p:
            T[i, i + 1] = up
        if i > 0:
            T[i, i - 1] = down
    return LevelTransition(T)


def _step_toward(p: int, target: int, q: float) -> np.ndarray:
    """Every level moves one step toward `target` with probability q."""
    T = np.eye(p)
    for i in range(p):
        step = int(np.sign(target - i))
        if step:
            T[i, i] = 1.0 - q
            T[i, i + step] = q
    return T


@dataclasses.dataclass(frozen=True)
class RetentionDrift(Channel):
    """Conductance relaxation over storage time: each cell independently
    drifts one level toward `rest_level` with probability 1 - exp(-rate * t).
    Cells already at the rest level are stable (absorbing)."""

    p_levels: int
    rate: float
    rest_level: int = 0

    @property
    def p(self) -> int:
        return self.p_levels

    def transition(self, t: float = 0.0, n_reads: int = 0) -> np.ndarray:
        q = 1.0 - math.exp(-self.rate * max(t, 0.0))
        return _step_toward(self.p_levels, self.rest_level, q)

    def apply(self, generator, levels, *, t=0.0, n_reads=0):
        return _sample_rows(generator, self.transition(t), levels)


@dataclasses.dataclass(frozen=True)
class ReadDisturb(Channel):
    """Read-disturb accumulation: every read nudges a cell one level toward
    `disturb_level` (default: the top level p-1) with per-read probability
    `per_read`; after n reads the cumulative probability is
    1 - (1 - per_read)^n."""

    p_levels: int
    per_read: float
    disturb_level: int | None = None

    @property
    def p(self) -> int:
        return self.p_levels

    def transition(self, t: float = 0.0, n_reads: int = 0) -> np.ndarray:
        target = (self.p_levels - 1 if self.disturb_level is None
                  else self.disturb_level)
        q = 1.0 - (1.0 - self.per_read) ** max(n_reads, 0)
        return _step_toward(self.p_levels, target, q)

    def apply(self, generator, levels, *, t=0.0, n_reads=0):
        return _sample_rows(generator, self.transition(n_reads=n_reads),
                            levels)


@dataclasses.dataclass(frozen=True)
class StuckAt(Channel):
    """A static population of dead cells pinned at `stuck_level`. The stuck
    mask is a function of (seed, array shape, device) only — the *same*
    cells are stuck on every apply, across reads and scrubs."""

    p_levels: int
    fraction: float
    stuck_level: int = 0
    seed: int = 0

    @property
    def p(self) -> int:
        return self.p_levels

    def mask(self, shape, device) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(self.seed)
        return torch.rand(tuple(shape), generator=gen,
                          device=device) < self.fraction

    def error_rate(self, *, t: float = 0.0, n_reads: int = 0) -> float:
        # a stuck cell is only *wrong* when the stored level differs
        return self.fraction * (self.p_levels - 1) / self.p_levels

    def apply(self, generator, levels, *, t=0.0, n_reads=0):
        del generator  # stuck cells are deterministic in (seed, shape)
        stuck = torch.full_like(levels, self.stuck_level)
        return torch.where(self.mask(levels.shape, levels.device), stuck,
                           levels)


@dataclasses.dataclass(frozen=True)
class Compose(Channel):
    """Sequential composition: physics stack (e.g. drift, then read disturb,
    then stuck cells), each stage drawing from the same generator in turn."""

    channels: tuple[Channel, ...]

    def __init__(self, *channels: Channel):
        if not channels:
            raise ValueError("Compose needs at least one channel")
        ps = {c.p for c in channels}
        if len(ps) != 1:
            raise ValueError(f"mixed alphabet sizes in Compose: {ps}")
        object.__setattr__(self, "channels", tuple(channels))

    @property
    def p(self) -> int:
        return self.channels[0].p

    def transition(self, t: float = 0.0, n_reads: int = 0) -> np.ndarray:
        # defined when every stage is i.i.d. per cell: matrix product
        T = np.eye(self.p)
        for c in self.channels:
            T = T @ c.transition(t, n_reads)
        return validate_transition(T)

    def apply(self, generator, levels, *, t=0.0, n_reads=0):
        for c in self.channels:
            levels = c.apply(generator, levels, t=t, n_reads=n_reads)
        return levels


@dataclasses.dataclass(frozen=True)
class PlusMinusOne(Channel):
    """The paper's ±1 *integer-error* channel (PIM-mode MAC outputs and the
    BER-campaign reference channel): each integer is hit with probability
    `eps`; a hit adds +1 with probability `up` else -1. Operates on
    unbounded integers, not cell levels."""

    eps: float
    up: float = 0.5
    p_field: int = 3              # field the protecting code works over

    domain = "integer"

    @property
    def p(self) -> int:
        return self.p_field

    def error_rate(self, *, t: float = 0.0, n_reads: int = 0) -> float:
        return self.eps

    def _signs(self, generator, shape, device) -> torch.Tensor:
        up = torch.rand(shape, generator=generator, device=device) < self.up
        return torch.where(up, 1, -1)

    def apply(self, generator, y, *, t=0.0, n_reads=0):
        hit = torch.rand(y.shape, generator=generator,
                         device=y.device) < self.eps
        sign = self._signs(generator, y.shape, y.device)
        return y + torch.where(hit, sign, 0).to(y.dtype)

    def corrupt_exact(self, generator, words, m, *, t=0.0, n_reads=0):
        pos = _positions(generator, words, m)
        sign = self._signs(generator, pos.shape, words.device)
        cur = torch.gather(words, 1, pos)
        return words.scatter(1, pos, cur + sign.to(words.dtype))
