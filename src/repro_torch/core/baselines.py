"""Baseline PIM ECC schemes the paper compares against (Table 2).

All three operate on the same simulated-PIM substrate as the NB-LDPC scheme
so the BER / efficiency comparisons are apples-to-apples:

- `HammingSECDED` — ASSCC'21 [3]-style: per-32-bit-word Hamming(39,32)+parity
  on *stored* data. Corrects 1 bit / detects 2 per word, memory mode only
  (PIM MAC outputs are not codewords of a binary Hamming code — exactly the
  limitation the paper targets). Host numpy, as in the JAX package.
- `ModuloParity` — ESSCIRC'22 [19]-style: a mod-q checksum column rides
  through the MAC (q=3 default); detects single-column errors in the output
  and corrects ±1 errors by syndrome lookup in one residue: correction is
  limited to the ±1 pattern (MTE=1).
- `SuccessiveCorrection` — DAC'22 [4]-style: detect via checksum columns,
  then *interrupt the dataflow*: re-read the PIM array row-group by
  row-group (digital recompute) to localize and fix errors; corrects up to
  `max_rereads` errors at a dataflow-interruption cost we charge in the
  efficiency model (MTE=3 at the paper's settings).

`ModuloParity` and `SuccessiveCorrection` take torch integer tensors and
run on the tensors' device. Every residue is a floored `torch.remainder`
(the JAX `%`), never the truncating `fmod`, and the re-read's exact product
is integer (`kernels.build.exact_matmul`: int64 on the CPU, a float
product only where it is exact on the card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.build import exact_matmul

# ---------------------------------------------------------------------------
# Hamming (39,32) SECDED — memory mode
# ---------------------------------------------------------------------------


def _hamming_positions(n_data: int = 32):
    """Positions (1-indexed, power-of-two slots are parity) for data bits."""
    pos, i = [], 1
    while len(pos) < n_data:
        i += 1
        if i & (i - 1):
            pos.append(i)
    return np.asarray(pos, np.int64)


@dataclasses.dataclass(frozen=True)
class HammingSECDED:
    n_data: int = 32

    def encode(self, bits: np.ndarray) -> np.ndarray:
        """bits: (..., 32) in {0,1} -> (..., 39) [6 parity | 32 data | 1 all]."""
        pos = _hamming_positions(self.n_data)
        nbits = int(pos.max())
        word = np.zeros(bits.shape[:-1] + (nbits + 1,), np.int64)
        word[..., pos - 1] = bits
        for j in range(6):
            pbit = 1 << j
            mask = ((np.arange(1, nbits + 1) & pbit) > 0)
            word[..., pbit - 1] = word[..., :nbits][..., mask].sum(-1) % 2
        word[..., -1] = word[..., :-1].sum(-1) % 2
        return word

    def decode(self, word: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """-> (corrected data bits, uncorrectable flag)."""
        pos = _hamming_positions(self.n_data)
        nbits = word.shape[-1] - 1
        synd = np.zeros(word.shape[:-1], np.int64)
        for j in range(6):
            pbit = 1 << j
            mask = ((np.arange(1, nbits + 1) & pbit) > 0)
            synd += pbit * (word[..., :nbits][..., mask].sum(-1) % 2)
        parity = word.sum(-1) % 2
        corrected = word.copy()
        err = synd > 0
        idx = np.clip(synd - 1, 0, nbits - 1)
        flat = corrected.reshape(-1, word.shape[-1])
        fe, fi = err.reshape(-1), idx.reshape(-1)
        flat[np.arange(flat.shape[0])[fe], fi[fe]] ^= 1
        corrected = flat.reshape(word.shape)
        # single error: synd>0 & parity=1 (fixed). double: synd>0 & parity=0.
        uncorrectable = (synd > 0) & (parity == 0)
        return corrected[..., pos - 1], uncorrectable


# ---------------------------------------------------------------------------
# Modulo checksum column (rides through the MAC) — detect + ±1 correct
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModuloParity:
    q: int = 3

    def encode_weights(self, W: torch.Tensor) -> torch.Tensor:
        """Append one checksum column: sum of data columns mod q, centered."""
        W = W.to(torch.int32)
        chk = torch.remainder(W.sum(dim=1, keepdim=True, dtype=torch.int32),
                              self.q)
        chk = torch.where(chk > self.q // 2, chk - self.q, chk)
        return torch.cat([W, chk], dim=1)

    def _residue(self, Y: torch.Tensor) -> torch.Tensor:
        Y = Y.to(torch.int32)
        return torch.remainder(Y[..., :-1].sum(-1, dtype=torch.int32)
                               - Y[..., -1], self.q)

    def detect(self, Y: torch.Tensor) -> torch.Tensor:
        """Y: (..., n+1) MAC outputs incl. checksum col -> error flags."""
        return self._residue(Y) != 0

    def correct(self, Y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """±1 single-error correction: if the residue mismatch is ±1 mod q,
        charge it to column 0 (integer outputs cannot localize it; the LUT
        schemes do the same for their supported pattern); everything else
        is "detected, uncorrected". Returns (data, uncorrected)."""
        data = Y[..., :-1].to(torch.int32)
        s = self._residue(Y)
        delta = torch.where(s > self.q // 2, s - self.q, s)      # centered
        fixable = delta.abs() == 1
        corrected = data.clone()
        corrected[..., 0] -= torch.where(fixable, delta, 0)
        return corrected, (s != 0) & ~fixable


# ---------------------------------------------------------------------------
# Successive correction (re-read; interrupts dataflow)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SuccessiveCorrection:
    q: int = 3
    max_rereads: int = 3

    def correct(self, x: torch.Tensor, W_true: torch.Tensor, Y: torch.Tensor,
                row_group: int = 32):
        """Detect residue mismatches column-wise, then recompute the guilty
        columns digitally from the stored weights (the 're-read'): exact fix,
        at the cost of interrupting the PIM dataflow. Returns (Y_fixed,
        n_rereads) — the reread count feeds the efficiency model."""
        bound = x.shape[-1] * int(x.abs().max()) * int(W_true.abs().max()) \
            if x.numel() and W_true.numel() else 0
        exact = exact_matmul(x, W_true, bound).to(torch.int32)
        bad = Y != exact                             # oracle detect via reread
        col_bad = bad.any(dim=0)
        ncols = torch.clamp_max(col_bad.sum(), self.max_rereads)
        rank = torch.cumsum(col_bad.to(torch.int32), 0) - 1
        fix = col_bad & (rank < self.max_rereads)
        Yf = torch.where(fix[None, :], exact, Y.to(torch.int32))
        return Yf, ncols
