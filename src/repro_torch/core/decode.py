"""Vectorized NB-LDPC max-log decoder (paper §3.2).

Flooding-schedule message passing over the Tanner graph of H_C:
  VN i --(coef h)--> CN j carries an LLV vector over GF(p);
  CNs run Forward-Backward Propagation (FBP): cyclic *max-plus* convolutions
  over the group (GF(p), +)  (paper Eq. 7);
  VNs accumulate prior + extrinsic messages and take argmax (paper §3.2.3).

All state is batched: `B` codewords decode simultaneously; shapes are
  prior   (B, n, p)
  msgs_cv (B, c, dc, p)   CN->VN messages in each VN's symbol space
The CN step is `repro_torch.kernels.fbp_cn_batched`: the CUDA FBP kernel on
the card, its plain version on the CPU. The per-iteration syndrome check
goes through the scan kernel the same way, or through the exact product
for fields past int8 (`gf_matmul.field_route`); hard decisions are held
in `symbol_dtype(p)`, int8 while p <= 128.

Early exit (converged mask): with `early_exit=True` codewords whose hard
decisions satisfy every check are *frozen* — their messages and LLV totals
stop updating — and the loop stops as soon as the whole batch has
converged or `n_iters` is reached. That costs one 1-byte host read per
iteration; running all `n_iters` under the same mask would give identical
outputs for about four times the FBP work at the error rates the memory
path sees. `DecodeResult.iterations[b]` is the number of iterations
codeword b consumed (its convergence iteration, or `n_iters`); the
fixed-iteration path fills it with `n_iters`.

Sums are taken in the JAX package's order: the VN total adds the
`dv_max` gathered edge messages left to right, then the prior, and the
damped message is one fused multiply-add (`_damp`), so the outputs match
the reference's CPU run bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..analysis.sanitizer import (check_finite, check_gf_symbols,
                                  sanitizer_enabled)
from ..device import as_tensor
from ..kernels.fbp import fbp_cn_batched, identity_msg, maxplus_conv
from ..kernels.gf_matmul import scan_syndromes_routed
from ..obs import ras as obs_ras
from .construction import LDPCCode
from .gf import symbol_dtype
from .llv import init_llv, normalize_llv, reinterpret

__all__ = ["DecodeResult", "decode_llv", "decode_integers", "maxplus_conv"]


class DecodeResult(NamedTuple):
    symbols: torch.Tensor        # (B, n) hard decisions, symbol_dtype(p)
    llv_totals: torch.Tensor     # (B, n, p) final accumulated LLVs
    detect_fail: torch.Tensor    # (B,) True if final syndrome still nonzero
    iterations: torch.Tensor     # (B,) int32 iterations consumed per codeword


def _edge_consts(code: LDPCCode, device) -> dict:
    mask = code.tensor("cn_mask", device)
    vns = code.tensor("cn_vns", device, torch.int64)
    return dict(
        mask=mask[None, :, :, None],
        safe_vns=torch.where(mask, vns, 0),
        to_contrib=code.tensor("perm_to_contrib", device, torch.int64),
        to_sym=code.tensor("perm_to_sym", device, torch.int64),
        vn_edges=code.tensor("vn_edges", device),
        ident=identity_msg((code.c, code.dc_max), code.p, device=device),
        ht=code.tensor("H.T", device, symbol_dtype(code.p)),
    )


def _one_iteration(code: LDPCCode, consts: dict, prior: torch.Tensor,
                   msgs_cv: torch.Tensor):
    p = code.p
    B = prior.shape[0]
    c, dc = code.c, code.dc_max

    # ---- VN total = prior + sum of incoming CN messages (edge gather) ----
    flat = msgs_cv.reshape(B, c * dc, p)
    flat = torch.cat([flat, flat.new_zeros(B, 1, p)], dim=1)
    gathered = flat[:, consts["vn_edges"]]                # (B, n, dv_max, p)
    s = gathered[:, :, 0]
    for j in range(1, gathered.shape[2]):
        s = s + gathered[:, :, j]
    totals = prior + s                                     # (B, n, p)

    # ---- VN -> CN extrinsic messages (padded slots masked out below) -----
    m_vc = normalize_llv(totals[:, consts["safe_vns"]] - msgs_cv)

    # ---- permute to contribution space (paper Eq. 6) ----------------------
    shape = (B, c, dc, p)
    m_hat = torch.gather(m_vc, -1, consts["to_contrib"].expand(shape))
    m_hat = torch.where(consts["mask"], m_hat, consts["ident"])

    # ---- CN forward-backward propagation ----------------------------------
    ext = fbp_cn_batched(m_hat.contiguous(), p)            # (B, c, dc, p)

    # ---- back to symbol space + normalize ---------------------------------
    msgs_new = torch.gather(ext, -1, consts["to_sym"].expand(shape))
    msgs_new = normalize_llv(msgs_new)
    msgs_new = torch.where(consts["mask"], msgs_new, 0.0)
    return msgs_new, totals


def _damp(new: torch.Tensor, old: torch.Tensor, damping: float):
    """(1-d)·new + d·old as the JAX package's CPU build computes it: XLA
    fuses the sum into one multiply-add, fma(d, old, (1-d)·new), rounded
    once. Here the product is exact in float64 and the sum is rounded to
    float64 and then to float32, which agrees with the single rounding
    except on exact float32 ties."""
    w_old = float(torch.tensor(damping, dtype=torch.float32))
    return (old.double() * w_old + ((1.0 - damping) * new).double()).float()


def decode_llv(code: LDPCCode, prior: torch.Tensor, *, n_iters: int = 10,
               early_exit: bool = False,
               damping: float = 0.0) -> DecodeResult:
    """Iteratively decode from prior LLVs. prior: (B, n, p) float32, on the
    device the decode runs on.

    damping in [0, 1): new messages are blended with the previous iteration's
    (msgs <- (1-d)·new + d·old), a standard stabilizer for max-log NB-LDPC
    flooding schedules on graphs with short cycles.
    """
    consts = _edge_consts(code, prior.device)
    B = prior.shape[0]
    msgs0 = prior.new_zeros(B, code.c, code.dc_max, code.p)

    def hard(totals):                                         # first max
        return torch.argmax(totals, dim=-1).to(symbol_dtype(code.p))

    def synd_fail(totals):
        return scan_syndromes_routed(hard(totals), consts["ht"], code.p)

    def step(msgs):
        new, totals = _one_iteration(code, consts, prior, msgs)
        if damping > 0.0:
            new = _damp(new, msgs, damping)
        return new, totals

    msgs, totals = step(msgs0)
    if not early_exit:
        for _ in range(n_iters - 1):
            msgs, totals = step(msgs)
        return DecodeResult(hard(totals), totals, synd_fail(totals),
                            torch.full((B,), n_iters, dtype=torch.int32,
                                       device=prior.device))

    done = ~synd_fail(totals)
    iters = torch.ones(B, dtype=torch.int32, device=prior.device)
    it = 1
    while it < n_iters and not bool(done.all()):
        new_msgs, new_totals = step(msgs)
        # converged-mask freeze: finished codewords keep their state
        msgs = torch.where(done[:, None, None, None], msgs, new_msgs)
        totals = torch.where(done[:, None, None], totals, new_totals)
        it += 1
        iters = torch.where(done, iters, it)
        done = done | ~synd_fail(totals)
    return DecodeResult(hard(totals), totals, synd_fail(totals), iters)


def decode_integers(code: LDPCCode, y, *, n_iters: int = 10,
                    llv_scale: float = 4.0, llv_mode: str = "manhattan",
                    early_exit: bool = False, damping: float = 0.0,
                    device=None, observe: bool = True):
    """Full arithmetic-code pipeline for received integer words y (B, n):
    LLV init -> iterative decode -> nearest-representative reinterpretation.

    `y` is a tensor (decoded on its own device) or an array (decoded on
    `device`, the card by default). Returns (y_corrected (B, n) in y's
    dtype, DecodeResult).

    Under `use_sanitizer` the outputs are checked (symbols in [0, p),
    finite LLV totals); `y` is not, since received levels may drift out
    of the field. With `observe` (the default) the ambient RAS estimator
    is fed this call's iterations and failures, as the JAX package's
    eager calls feed it. Callers that feed the estimator themselves pass
    `observe=False` (the repair queue, the paged store, the campaign and
    the streamed decodes): their JAX counterparts decode under `jax.jit`,
    where `decode_integers` feeds nothing, so feeding here as well would
    count each word twice.
    """
    y = as_tensor(y, device)
    prior = init_llv(y, code.p, scale=llv_scale, mode=llv_mode)
    res = decode_llv(code, prior, n_iters=n_iters, early_exit=early_exit,
                     damping=damping)
    y_corr = reinterpret(y, res.symbols, code.p)
    if sanitizer_enabled():
        check_gf_symbols(res.symbols, code.p, "decode_integers symbols")
        check_finite(res.llv_totals, "decode_integers llv totals")
    if observe:
        _observe_decode(res, n_iters)
    return y_corr, res


def _observe_decode(res: DecodeResult, n_iters: int) -> None:
    """Feed one decode's iteration and failure vectors to the ambient RAS
    estimator (a host read of each, only when one is installed)."""
    est = obs_ras.current()
    if est.enabled:
        est.observe_decode(res.iterations, n_iters,
                           detect_fail=res.detect_fail)
