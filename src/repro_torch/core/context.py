"""PIMContext — routes model projections through the PIM + NB-LDPC path.

This is the deployment integration of the paper's technique: a target matmul
(e.g. `mlp_down`, `attn_o`) executes as
  1. ternarize weights (differential mapping, paper §3.3) + quantize
     activations to small integers,
  2. NB-LDPC-encode the weight columns (check columns ride along, Fig. 2(b)),
  3. simulated PIM MAC over data+check columns (noise injected when the
     context has faults — Eq. 4),
  4. syndrome detect + iterative FBP correction on the integer outputs
     (Eq. 5, §3.2), drop check columns,
  5. dequantize back to the activation dtype.

On the card steps 2-4 run the port's kernels: `gf_matmul` encodes, the
MAC is `pim_mac`, and the check and the decoder run `scan_syndromes` and
`fbp_cn`.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import PIMSpec
from .codes import get_code
from .pim import PIMConfig
from .protected import (ProtectionConfig, protected_pim_matmul,
                        protected_pim_matmul_budgeted, prepare_weights)


class PIMContext:
    """The protected projections of one deployment (`spec`).

    `key` is an int seed of the fault draws (used once `with_faults` has
    set fault rates). Every `matmul` of a faulted context draws from a new
    generator seeded with it, as the JAX package draws every call from one
    fixed key: two calls of equal shapes get the same faults.

    `spec.use_kernels` has no effect here: on CUDA tensors the decoder
    runs the `fbp_cn` kernel by the device rule (its plain version on CPU
    tensors), which is what the flag selects in the JAX package.

    `stats()` counts the words this context checked, flagged and left
    uncorrected over its `matmul` calls. A call only keeps its flags; they
    are summed on the device every FOLD calls and by `stats()`, so
    counting adds no launch to most calls.
    """

    FOLD = 64                   # calls whose flags are summed together

    def __init__(self, spec: PIMSpec, key: int | None = None,
                 act_levels: int = 7):
        if not 0 < act_levels <= 127:
            raise ValueError(f"act_levels {act_levels} must lie in [1, 127] "
                             "(activations are int8 MAC operands)")
        self.spec = spec
        self.targets = set(spec.targets)
        self.code = get_code(spec.code_name)
        self.key = key
        self.act_levels = act_levels
        self.prot = ProtectionConfig(
            code_name=spec.code_name, mode=spec.mode, n_iters=spec.n_iters,
            damping=spec.damping)
        self.pim_cfg = PIMConfig(
            row_parallelism=spec.row_parallelism, adc_levels=spec.adc_levels,
            p=self.code.p,
            output_error_rate=0.0)  # noise enters via with_faults()
        self._fault_cfg = None      # set by with_faults()
        self._reset_counts()

    def with_faults(self, key: int, output_error_rate: float,
                    weight_flip_rate: float = 0.0) -> PIMContext:
        """Return a context that injects stochastic PIM faults (Fig. 6(c)),
        drawn from the int seed `key`, with counts of its own."""
        other = PIMContext.__new__(PIMContext)
        other.__dict__.update(self.__dict__)
        other.key = int(key)
        other._fault_cfg = dataclasses.replace(
            self.pim_cfg, output_error_rate=output_error_rate,
            weight_flip_rate=weight_flip_rate)
        other._reset_counts()
        return other

    def stats(self) -> dict:
        """{"calls", "words", "detected_words", "uncorrected_words"} over
        this context's `matmul` calls (one host read)."""
        self._fold()
        det, unc = (int(v) for v in self._flagged)
        return {"calls": self._calls, "words": self._words,
                "detected_words": det, "uncorrected_words": unc}

    # -- quantization ------------------------------------------------------

    @staticmethod
    def ternarize(W: torch.Tensor, thresh: float = 0.7):
        """Differential ternary mapping: W -> {-1, 0, +1} * alpha.
        alpha = E|W| over the kept entries (TWN-style). Returns (int32 Wq,
        0-d float32 alpha)."""
        Wf = W.to(torch.float32)
        t = thresh * Wf.abs().mean()
        Wq = torch.where(Wf > t, 1, torch.where(Wf < -t, -1, 0)).to(
            torch.int32)
        kept = Wq != 0
        nz = torch.clamp_min(kept.sum(), 1)
        alpha = (Wf.abs() * kept).sum() / nz
        return Wq, alpha

    def quantize_acts(self, x: torch.Tensor):
        """Symmetric integer quantization of activations to ±act_levels,
        with one scale over the whole input (every row of a batch shares
        it). Returns (int32 xq, 0-d float32 scale)."""
        xf = x.to(torch.float32)
        s = torch.clamp_min(xf.abs().max(), 1e-6) / self.act_levels
        xq = torch.clamp(torch.round(xf / s), -self.act_levels,
                         self.act_levels).to(torch.int32)
        return xq, s

    # -- the protected matmul ---------------------------------------------

    def encode_weight(self, W: torch.Tensor):
        """Deploy-time: ternarize + NB-LDPC-encode. Returns (int8 W_enc,
        fp32 alpha), stored beside the weights so serving never
        re-encodes."""
        Wq, alpha = self.ternarize(W)
        W_enc = prepare_weights(Wq.to(torch.int8), self.code)
        return W_enc.to(torch.int8), alpha.to(torch.float32)

    def matmul(self, x: torch.Tensor, W: torch.Tensor, name: str,
               enc: torch.Tensor | None = None,
               alpha: torch.Tensor | None = None, *,
               out_noise: torch.Tensor | None = None) -> torch.Tensor:
        """x: (..., n_in) activations; W: (n_in, n_out) fp weights.
        Returns (..., n_out) in x.dtype via the protected PIM path, on x's
        device. With `enc`/`alpha` (precoded deployment) the fp weights are
        not touched at all — the PIM array holds the encoded integers.
        `out_noise` (rows, n_enc) is added to the MAC's output as given
        (noise drawn elsewhere, e.g. by the JAX package)."""
        orig_shape = x.shape
        orig_dtype = x.dtype
        n_out = W.shape[1]
        x2 = x.reshape(-1, orig_shape[-1])

        if enc is not None:
            W_enc = enc
            xq, s = self.quantize_acts(x2)
        else:
            Wq, alpha = self.ternarize(W)
            xq, s = self.quantize_acts(x2)
            W_enc = prepare_weights(Wq.to(torch.int8), self.code)

        pim_cfg = self._fault_cfg or self.pim_cfg
        gen = None
        if self._fault_cfg is not None:
            gen = torch.Generator(device=x.device).manual_seed(self.key)
        xq = xq.to(torch.int8)              # |xq| <= act_levels <= 127
        if self.spec.mode == "correct_budget":
            prot = dataclasses.replace(self.prot, mode="correct")
            res = protected_pim_matmul_budgeted(
                xq, W_enc, self.code, prot, pim_cfg, generator=gen,
                budget=self.spec.correct_budget, out_noise=out_noise)
        else:
            res = protected_pim_matmul(xq, W_enc, self.code, self.prot,
                                       pim_cfg, generator=gen,
                                       out_noise=out_noise)
        self._count(res)
        y = res.y[:, :n_out].to(torch.float32) * (s * alpha)
        return y.reshape(orig_shape[:-1] + (n_out,)).to(orig_dtype)

    def _reset_counts(self) -> None:
        self._calls = self._words = 0
        self._flagged = (0, 0)      # detected, uncorrected words folded
        self._pending = []          # (detected, uncorrected) of later calls

    def _count(self, res) -> None:
        self._calls += 1
        self._words += res.detected.numel()
        self._pending.append((res.detected.reshape(-1),
                              res.uncorrected.reshape(-1)))
        if len(self._pending) >= self.FOLD:
            self._fold()

    def _fold(self) -> None:
        if not self._pending:
            return
        det, unc = zip(*self._pending)
        self._pending = []
        self._flagged = (self._flagged[0] + torch.cat(det).sum(),
                         self._flagged[1] + torch.cat(unc).sum())


__all__ = ["PIMContext"]
