"""Protected PIM matmul — the paper's technique as one PyTorch op.

Pipeline (paper Fig. 2(a), §3):
  1. weight columns are partitioned into codeword blocks; check columns are
     generated over GF(p) and stored alongside (encode_weight_matrix),
  2. the PIM MAC computes over data+check columns in one pass (Eq. 4) —
     the dataflow is never interrupted,
  3. syndrome check on the integer MAC output (Eq. 5) detects errors,
  4. the NB-LDPC decoder corrects the residues and the corrected integers are
     re-interpreted (nearest representative, §3.2.3),
  5. check columns are dropped.

On the card steps 2-4 run the port's CUDA kernels: the MAC (pim_mac), the
fused syndrome scan and, inside the decoder, FBP and the scan again. The
signed MAC outputs are reduced mod p with a floored `torch.remainder`
before the scan, so the scan sees levels in [0, p).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import as_tensor
from ..kernels import build
from ..kernels.gf_matmul import scan_syndromes_routed
from .construction import LDPCCode
from .decode import DecodeResult, decode_integers
from .encode import encode_weight_matrix
from .gf import symbol_dtype
from .pim import (PIMConfig, adc_quantize, flip_rows, output_errors,
                  pim_mac, pim_mac_rows)


@dataclasses.dataclass(frozen=True)
class ProtectionConfig:
    code_name: str = "wl320_r08"
    mode: str = "correct"            # "off" | "detect" | "correct"
    n_iters: int = 8
    llv_scale: float = 4.0
    llv_mode: str = "manhattan"
    early_exit: bool = False         # stop once every codeword converged
    damping: float = 0.3             # message damping (beyond-paper stabilizer)


class ProtectedResult(NamedTuple):
    y: torch.Tensor                  # (B, n_out) corrected integer MAC results
    detected: torch.Tensor           # (B, n_blocks) any-error-detected flags
    uncorrected: torch.Tensor        # (B, n_blocks) decoder gave up (detect_fail)


def _flag_words(yb: torch.Tensor, code: LDPCCode) -> torch.Tensor:
    """(W, n) integer MAC words -> (W,) nonzero-syndrome flags."""
    dtype = symbol_dtype(code.p)
    levels = torch.remainder(yb, code.p).to(dtype)
    return scan_syndromes_routed(levels, code.tensor("H.T", yb.device, dtype),
                                 code.p)


def _mac_words(x, W_enc, code, pim_cfg, generator, out_noise, device):
    x = as_tensor(x, device)
    W_enc = as_tensor(W_enc, device if device is not None else x.device)
    if W_enc.shape[1] % code.n:
        raise ValueError(f"W_enc width {W_enc.shape[1]} is not a multiple "
                         f"of n={code.n}")
    nb = W_enc.shape[1] // code.n
    y = pim_mac(x, W_enc, pim_cfg, generator=generator, out_noise=out_noise)
    return y.reshape(x.shape[0] * nb, code.n), x.shape[0], nb


def protected_pim_matmul(x, W_enc, code: LDPCCode, prot: ProtectionConfig,
                         pim_cfg: PIMConfig,
                         generator: torch.Generator | None = None,
                         out_noise: torch.Tensor | None = None, *,
                         device=None) -> ProtectedResult:
    """x: (B, n_in) ints; W_enc: (n_in, nb * code.n) encoded weights.
    Tensors stay on their device; arrays go to `device` (the card by
    default)."""
    yb, B, nb = _mac_words(x, W_enc, code, pim_cfg, generator, out_noise,
                           device)
    if prot.mode == "off":
        z = torch.zeros((B, nb), dtype=torch.bool, device=yb.device)
        return ProtectedResult(yb[:, :code.k].reshape(B, nb * code.k), z, z)

    detected = _flag_words(yb, code).reshape(B, nb)
    if prot.mode == "detect":
        return ProtectedResult(yb[:, :code.k].reshape(B, nb * code.k),
                               detected, detected)

    y_corr, res = decode_integers(
        code, yb, n_iters=prot.n_iters, llv_scale=prot.llv_scale,
        llv_mode=prot.llv_mode, early_exit=prot.early_exit,
        damping=prot.damping)
    data = y_corr[:, :code.k].reshape(B, nb * code.k)
    return ProtectedResult(data, detected, res.detect_fail.reshape(B, nb))


def prepare_weights(W_int, code: LDPCCode, *, device=None) -> torch.Tensor:
    """Pad the output dim to a codeword multiple and encode. Returns W_enc;
    callers must remember original width to strip padding after the matmul."""
    W_int = as_tensor(W_int, device)
    pad = (-W_int.shape[1]) % code.k
    if pad:
        W_int = F.pad(W_int, (0, pad))
    return encode_weight_matrix(W_int, code)


def strip_padding(y: torch.Tensor, n_out: int) -> torch.Tensor:
    return y[..., :n_out]


def protected_pim_matmul_budgeted(x, W_enc, code: LDPCCode,
                                  prot: ProtectionConfig, pim_cfg: PIMConfig,
                                  generator: torch.Generator | None = None,
                                  budget: int = 16,
                                  out_noise: torch.Tensor | None = None, *,
                                  device=None) -> ProtectedResult:
    """Detect-then-correct with a fixed decode budget (serving fast path).

    The syndrome check rides along for free (the paper's no-interruption
    property); the iterative FBP decoder — the expensive part — runs only on
    up to `budget` flagged words per call, gathered into a dense mini-batch
    and scattered back. Overflow beyond the budget is reported in
    `uncorrected`. The selection is a stable descending sort of the 0/1
    flags, so among flagged words the lower index goes first, as in the
    reference's `top_k`.
    """
    yb, B, nb = _mac_words(x, W_enc, code, pim_cfg, generator, out_noise,
                           device)
    flagged = _flag_words(yb, code)                        # (B*nb,)
    detected = flagged.reshape(B, nb)

    k = min(budget, B * nb)
    order = torch.sort(flagged.to(torch.float32), descending=True,
                       stable=True).indices
    idx = order[:k]
    sel = yb[idx]
    sel_corr, res = decode_integers(
        code, sel, n_iters=prot.n_iters, llv_scale=prot.llv_scale,
        llv_mode=prot.llv_mode, damping=prot.damping)
    # only write back genuinely-flagged rows (the selection pads with
    # unflagged ones)
    take = flagged[idx]
    yb = yb.clone()
    yb[idx] = torch.where(take[:, None], sel_corr, sel)

    # a word stays uncorrected when the decoder gave up on it or when the
    # budget never reached it; corrected words are not blamed for an
    # overflow elsewhere in the batch
    word_fail = torch.zeros_like(flagged)
    word_fail[idx] = res.detect_fail & take
    selected = torch.zeros_like(flagged)
    selected[idx] = take
    uncorrected = (word_fail | (flagged & ~selected)).reshape(B, nb)
    data = yb.reshape(B, nb, code.n)[..., :code.k].reshape(B, nb * code.k)
    return ProtectedResult(data, detected, uncorrected)


def _block(t: torch.Tensor, i: int, M: int) -> torch.Tensor:
    """Block i of `split_rows`' M row blocks of t, on t's device."""
    per = -(-t.shape[0] // M)
    part = t[i * per:(i + 1) * per]
    if part.shape[0] < per:
        part = torch.cat([part, part.new_zeros(
            (per - part.shape[0],) + tuple(t.shape[1:]))])
    return part


def _tag(positions, i: int):
    """Tag launches with mesh position `positions[i]`, where given."""
    return (build.at_position(positions[i]) if positions
            else contextlib.nullcontext())


def protected_pim_matmul_rows(xs, encs, code: LDPCCode,
                              prot: ProtectionConfig, pim_cfg: PIMConfig, *,
                              key: int | None = None, out_noise=None,
                              budget: int | None = None,
                              positions=None) -> list:
    """`protected_pim_matmul` row-parallel over M model positions:
    position j holds `xs[j]` (B, K_j) integers on its device and
    `encs[j]`, rows [K_0 + ... + K_{j-1}, ... + K_j) of W_enc (K, nb·n),
    the unsharded call's x and W_enc cut by rows. Each position's MAC
    gives int32 partial words over its rows (ADC groups shared with a
    neighbour summed there, then clipped whole: `core.pim.pim_mac_rows`);
    the partials are summed exactly, each position keeping 1/M of the B·nb
    words (`distributed.sharding.reduce_scatter_rows`), which it checks
    and decodes on its own device. With `key` the faults are the
    unsharded call's under `torch.Generator().manual_seed(key)`: each
    position draws the whole weight's flips and keeps its rows, then the
    whole output's errors and keeps its words; `out_noise` (B, nb·n) is
    added likewise. `budget` decodes at most that many flagged words of
    the whole call, the first in word order
    (`protected_pim_matmul_budgeted`). Returns, a position, (data (w, k)
    int32 of its block of w = ceil(B·nb / M) words, detected, uncorrected
    (its real words,) bool), equal to the unsharded call's on those
    words. `positions` (mesh positions, one a position) tag each
    position's launches (`kernels.build.at_position`)."""
    from ..distributed.sharding import all_gather_rows, reduce_scatter_rows
    devices = [x.device for x in xs]
    tags = [build.at_position(p) for p in positions] if positions \
        else [contextlib.nullcontext() for _ in xs]
    M, B, K = len(xs), xs[0].shape[0], sum(x.shape[1] for x in xs)
    N = encs[0].shape[1]
    if N % code.n:
        raise ValueError(f"W_enc width {N} is not a multiple of n={code.n}")
    nb = N // code.n
    n_words = B * nb
    gens = [None if key is None else
            torch.Generator(device=d).manual_seed(int(key)) for d in devices]
    totals, shared = [], {}
    row0 = 0
    for j, (x, W, gen) in enumerate(zip(xs, encs, gens, strict=True)):
        if gen is not None:
            W = flip_rows(gen, W, pim_cfg, row0, K)
        with _tag(positions, j):
            clipped, partials = pim_mac_rows(x, W, pim_cfg, row0, K)
        totals.append(clipped if clipped is not None else torch.zeros(
            (B, N), dtype=torch.int32, device=x.device))
        for g, part in partials.items():
            shared.setdefault(g, []).append((len(totals) - 1, part))
        row0 += x.shape[1]
    for _g, parts in sorted(shared.items()):
        # a group over several positions: summed where it starts, clipped
        j0, total = parts[0]
        for _j, part in parts[1:]:
            total = total + part.to(total.device, non_blocking=True)
        totals[j0] = totals[j0] + adc_quantize(total, pim_cfg)
    words = reduce_scatter_rows([t.reshape(n_words, code.n) for t in totals],
                                devices)
    per = words[0].shape[0]
    for i, gen in enumerate(gens):
        if gen is not None and pim_cfg.output_error_rate > 0:
            err = output_errors(gen, (B, N), pim_cfg, devices[i])
            words[i] = words[i] + _block(err.reshape(n_words, code.n), i,
                                         M).to(torch.int32)
        if out_noise is not None:
            noise = as_tensor(out_noise, devices[i]).reshape(n_words, code.n)
            words[i] = words[i] + _block(noise, i, M).to(torch.int32)
    real = [max(0, min(per, n_words - i * per)) for i in range(M)]
    if prot.mode == "off":
        return [(w[:, :code.k], *(torch.zeros(r, dtype=torch.bool,
                                              device=w.device),) * 2)
                for w, r in zip(words, real)]
    flags = []
    for i, w in enumerate(words):
        with _tag(positions, i):
            flags.append(_flag_words(w, code))
    if prot.mode == "detect":
        return [(w[:, :code.k], f[:r], f[:r])
                for w, f, r in zip(words, flags, real)]
    kw = dict(n_iters=prot.n_iters, llv_scale=prot.llv_scale,
              llv_mode=prot.llv_mode, damping=prot.damping)
    out = []
    if budget is None:
        for i, (w, f, r) in enumerate(zip(words, flags, real)):
            with _tag(positions, i):
                y_corr, res = decode_integers(code, w,
                                              early_exit=prot.early_exit,
                                              **kw)
            out.append((y_corr[:, :code.k], f[:r], res.detect_fail[:r]))
        return out
    # the budget: the first `budget` flagged words of the whole call, by a
    # stable descending sort of all flags, as the unsharded call selects
    every = all_gather_rows(flags, n_words)
    for i, (w, f, r) in enumerate(zip(words, flags, real)):
        order = torch.sort(every[i].to(torch.float32), descending=True,
                           stable=True).indices[:min(budget, n_words)]
        local = order[(order >= i * per) & (order < i * per + r)] - i * per
        fail = torch.zeros_like(f)
        chosen = torch.zeros_like(f)
        if local.numel():
            sel = w[local]
            with _tag(positions, i):
                sel_corr, res = decode_integers(code, sel, **kw)
            take = f[local]
            w = w.clone()
            w[local] = torch.where(take[:, None], sel_corr, sel)
            fail[local] = res.detect_fail & take
            chosen[local] = take
        out.append((w[:, :code.k], f[:r], (fail | (f & ~chosen))[:r]))
    return out


def np_prod_mesh(mesh) -> int:
    """Total device count of a mesh (the product of its shape's values;
    anything with a `shape` mapping will do)."""
    size = 1
    for v in mesh.shape.values():
        size *= int(v)
    return size


def _chunk_runner(code: LDPCCode, *, mesh, chunk_size: int, **kw):
    """The decode of one chunk, fanned over `mesh` (`distributed.
    sharding.decode_sharded`) when one is given; shared by
    `decode_stream` and `decode_pipelined`. Every chunk is split over the
    mesh, so a `chunk_size` that the device count does not divide
    raises here, at the call."""
    if mesh is None:
        return lambda y: decode_integers(code, y, observe=False, **kw)
    mesh_size = int(np_prod_mesh(mesh))
    if chunk_size % mesh_size != 0:
        raise ValueError(
            f"chunk_size={chunk_size} is not a multiple of the mesh "
            f"size {mesh_size}; every padded chunk is shard_map'd over "
            "the mesh, so pick a chunk_size divisible by the device "
            "count")
    from ..distributed.sharding import (decode_shards, decode_sharded,
                                        gather_decode)
    kw.pop("device")

    def run(y):
        if isinstance(y, tuple):          # row blocks already in place
            return gather_decode(decode_shards(code, y, **kw), y[0].device)
        return decode_sharded(code, y, mesh=mesh, **kw)
    return run


def decode_stream(code: LDPCCode, stream, *, chunk_size: int = 256,
                  n_iters: int = 8, llv_scale: float = 4.0,
                  llv_mode: str = "manhattan", early_exit: bool = True,
                  damping: float = 0.0, device=None, mesh=None):
    """Streaming chunked decode for workloads larger than one batch.

    `stream` is either a single (B, n) integer tensor or array — chunked
    internally into `chunk_size`-word slices — or any iterable of (b_i, n)
    chunks. Yields one `(y_corrected, DecodeResult)` pair per chunk, in
    order. Rows decode independently, so a chunk needs no padding.

    With `mesh` (a `distributed.sharding.Mesh` with a "data" axis) each
    chunk is fanned over the mesh's devices through `decode_sharded`;
    `chunk_size` must then be a multiple of the mesh size, checked at the
    call, not at the first chunk. A chunk may then also be a tuple of row
    blocks that already lie on the mesh's devices (a sharded page): each
    block decodes where it lies, gathered onto the first block's device.
    """
    run = _chunk_runner(code, mesh=mesh, chunk_size=chunk_size,
                        n_iters=n_iters, llv_scale=llv_scale,
                        llv_mode=llv_mode, early_exit=early_exit,
                        damping=damping, device=device)
    if hasattr(stream, "shape"):
        arr = stream
        stream = (arr[i:i + chunk_size]
                  for i in range(0, arr.shape[0], chunk_size))

    def gen():
        for y in stream:
            rows = (sum(b.shape[0] for b in y) if isinstance(y, tuple)
                    else y.shape[0])
            if rows > chunk_size:
                raise ValueError(f"chunk of {rows} words exceeds "
                                 f"chunk_size={chunk_size}")
            yield run(y)
    return gen()


def decode_pipelined(code: LDPCCode, pages, *, depth: int = 1, **kw):
    """Double-buffered paged decode, the corrected-read pipeline behind
    `memory.paged.PagedProtectedStore.decode_stream`.

    `decode_stream` (same arguments, `mesh=` included, and results: one
    `(y_corrected, DecodeResult)` per page, in order), but page i+1's
    decode is dispatched before page i's result is yielded, with `depth`
    pages ahead. On the card this reorders the work and does not overlap
    it: the decoder's early-exit check reads one byte back from the card
    per iteration, so page i+1's decode has finished on the host's side
    before page i is yielded. Overlap needs an asynchronous exit check
    (ROADMAP Queue 2, host-bound paths).
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    stream = decode_stream(code, pages, **kw)

    def gen():
        inflight = collections.deque()
        for res in stream:
            inflight.append(res)
            if len(inflight) > depth:
                yield inflight.popleft()
        yield from inflight
    return gen()


__all__ = ["ProtectionConfig", "ProtectedResult", "protected_pim_matmul",
           "protected_pim_matmul_budgeted", "protected_pim_matmul_rows", "prepare_weights",
           "strip_padding", "decode_stream", "decode_pipelined",
           "np_prod_mesh", "DecodeResult"]
