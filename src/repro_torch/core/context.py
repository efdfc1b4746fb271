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

import contextlib
import dataclasses
import threading

import torch

from ..configs.base import PIMSpec
from ..distributed.sharding import (Parts, all_gather_rows, data_shard,
                                    max_over, relayout)
from ..kernels import build
from .codes import get_code
from .pim import PIMConfig
from .protected import (ProtectionConfig, protected_pim_matmul,
                        protected_pim_matmul_budgeted,
                        protected_pim_matmul_rows, prepare_weights)


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
    uncorrected over its `matmul` calls (those made `uncounted()` aside).
    A call only keeps its flags; they are summed on the device every FOLD
    calls and by `stats()`, so counting adds no launch to most calls.

    `matmul` is differentiable as `jax.grad` differentiates the JAX
    package's: the ternary and integer steps are rounded and cast to
    integers, so the gradient reaches `x` only through the activation
    scale `s` (one-hot at max|x|, split evenly over ties) and `W` only
    through the ternary scale `alpha` (sign(W) on the kept entries over
    their count). The encode, MAC, check and decode run on integers that
    carry no gradient, and need no backward kernel.

    Under tensor parallelism `matmul` takes `distributed.sharding.Parts`:
    x split along its last dimension and the weight (`enc`, or `W`) by
    rows over the model positions, as `wo` and `w_down` are placed. It
    equals the unsharded call on the same x bit for bit: the scale is
    the largest |x| over every position, each position's MAC sums its
    rows' ADC groups, the int32 partial words are summed exactly with
    each position keeping 1/M of them, which it checks and decodes on
    its own device, and the faults are the unsharded call's draws
    (`core.protected.protected_pim_matmul_rows`); the words' outputs
    are then all-gathered, whole at every position. Its counts are
    those of the unsharded call. Data shards run in lockstep
    (`distributed.sharding.run_shards`) share the scale too, the largest
    |x| of the whole batch, and add their words to one count a call; a
    replica (a shard holding rows an earlier one holds: context
    parallelism's whole batch) adds none, and draws the faults its first
    copy draws.
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
        with self._lock:
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
        s = _shared_max(torch.clamp_min(xf.abs().max(), 1e-6)) \
            / self.act_levels
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
        if isinstance(x, Parts):
            return self._matmul_rows(x, W, enc, alpha, out_noise)
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

    def _matmul_rows(self, x, W, enc, alpha, out_noise):
        """`matmul` over `Parts` (the class docstring): -> y whole."""
        x = relayout(x, x[0].ndim - 1)
        devices = x.devices
        n_out = W[0].shape[1]
        if enc is None:
            # the ternary threshold and scale are the whole weight's: made
            # once on the first position, each position's rows encoded
            W = relayout(W, 0)
            Wq, a = self.ternarize(torch.cat(
                [w.to(devices[0], non_blocking=True) for w in W]))
            encs, row0 = [], 0
            for pos, t in zip(x.positions, x):
                rows = Wq[row0:row0 + t.shape[-1]].to(t.device)
                with build.at_position(pos):
                    encs.append(prepare_weights(rows.to(torch.int8),
                                                self.code))
                row0 += t.shape[-1]
            alphas = [a.to(d) for d in devices]
        else:
            encs = list(relayout(enc, 0))
            alphas = list(relayout(alpha, "whole"))
        x2 = [t.reshape(-1, t.shape[-1]).to(torch.float32) for t in x]
        top = max_over([torch.clamp_min(t.abs().max(), 1e-6) for t in x2])
        if data_shard() is not None:
            top = max_over([_shared_max(top[0]), *top[1:]])
        scales = [m / self.act_levels for m in top]
        xq = [torch.clamp(torch.round(t / s), -self.act_levels,
                          self.act_levels).to(torch.int8)
              for t, s in zip(x2, scales)]
        budget = (self.spec.correct_budget
                  if self.spec.mode == "correct_budget" else None)
        prot = (dataclasses.replace(self.prot, mode="correct")
                if budget is not None else self.prot)
        faulted = self._fault_cfg is not None
        blocks = protected_pim_matmul_rows(
            xq, encs, self.code, prot, self._fault_cfg or self.pim_cfg,
            key=self.key if faulted else None, out_noise=out_noise,
            budget=budget, positions=x.positions)
        B = x2[0].shape[0]
        n_words = B * (encs[0].shape[1] // self.code.n)
        self._add(n_words, *(torch.cat([
            b[f].to(devices[0], non_blocking=True) for b in blocks])
            for f in (1, 2)))
        data = all_gather_rows([b[0] for b in blocks], n_words)
        lead = tuple(x[0].shape[:-1])
        ys = [(d.reshape(B, -1)[:, :n_out].to(torch.float32) * (s * a))
              .reshape(lead + (n_out,)).to(x.dtype)
              for d, s, a in zip(data, scales, alphas)]
        return x.like(ys, "whole", x.dtype)

    @contextlib.contextmanager
    def uncounted(self):
        """`matmul` calls made inside are left out of `stats()`: a remat
        backward recomputes calls that its forward pass counted."""
        counting, self._counting = self._counting, False
        try:
            yield self
        finally:
            self._counting = counting

    def _reset_counts(self) -> None:
        self._counting = True
        self._calls = self._words = 0
        self._flagged = (0, 0)      # detected, uncorrected words folded
        self._pending = []          # (detected, uncorrected) of later calls
        self._lock = threading.Lock()   # data shards count from threads

    def _count(self, res) -> None:
        """One call's `ProtectedResult`."""
        self._add(res.detected.numel(), res.detected, res.uncorrected)

    def _add(self, words: int, detected, uncorrected) -> None:
        """One call's words and flags; data shards in lockstep each add
        theirs, and the first counts the call; replicas add nothing."""
        shard = data_shard()
        if not self._counting or (shard is not None
                                  and shard[0].layout.replica[shard[1]]):
            return
        with self._lock:
            self._calls += shard is None or shard[1] == 0
            self._words += words
            self._pending.append((detected.reshape(-1),
                                  uncorrected.reshape(-1)))
            if len(self._pending) >= self.FOLD:
                self._fold()

    def _fold(self) -> None:
        if not self._pending:
            return
        det, unc = zip(*self._pending)
        self._pending = []
        dev = (self._flagged[0].device if torch.is_tensor(self._flagged[0])
               else det[0].device)
        self._flagged = tuple(
            done + torch.cat([f.to(dev) for f in flags]).sum()
            for done, flags in zip(self._flagged, (det, unc)))


def _shared_max(top: torch.Tensor) -> torch.Tensor:
    """`top`, or the largest over the data shards in lockstep
    (`distributed.sharding.run_shards`): the whole batch's."""
    shard = data_shard()
    return top if shard is None else shard[0].max_over(top)


__all__ = ["PIMContext"]
