"""Mixture-of-Experts FFN: the port of the JAX package's `repro.nn.moe`.

One parameter layout, float32 as in the JAX package: `router` (d, E),
`w_gate` / `w_up` (E, d, f) and `w_down` (E, f, d). The products run in
bf16 (`torch.einsum` / `torch.bmm`), as the JAX package's jnp products
do; no kernel of the TPU package computes them. `cfg.moe_impl` picks:

- "dense": the oracle. Every expert processes every token; the combine
  weighs each token's top-k outputs. O(E) compute: tests and tiny
  configs only.
- "sorted_ep": top-k routing, a stable sort of the (token, slot) pairs by
  expert id, a pack into an (E, cap + 1, d) buffer whose row `cap` is
  the scratch row of the slots dropped at capacity, grouped products, an
  unsort and the weighted combine. Dropped slots add zero.
- "shard_ep": expert parallelism, `nn.moe_shard.moe_shard_apply`, under
  an active mesh with a `model` axis (`distributed.sharding.use_rules`):
  the experts split over the `model` axis's devices, one exchange out to
  them and one back. Without such a mesh it runs "sorted_ep", the
  one-device dispatch, which is `_local_moe` at ep = 1. (The JAX
  package's `shard_ep` without a mesh recurses between `moe_apply` and
  `moe_shard_apply`, ROADMAP Queue 3; the port does what that docstring
  says.)

Capacity is `max(1, int(T·K/E·capacity_factor))` for T tokens, as in the
JAX package, so a decode step of a few tokens drops a slot whenever two
of them pick the same expert (ROADMAP Queue 3).

Under the JAX data mesh a training batch's "sorted_ep" dispatch sees
every token of the batch: the capacity is the whole batch's, and one
stable sort puts each slot after the slots of the earlier rows, which
lie on the earlier data shards. The port's data-parallel step runs its
shards in order, each with a `DataSplit`: the capacity of the whole
batch, and per expert the slots the earlier shards routed there, passed
from shard to shard on the devices (E ints a layer), so each shard keeps
and drops the slots the whole batch's dispatch does. A shard's remat
recomputation reuses the offsets of its first pass. ("shard_ep" keeps
the local capacity, as the JAX `shard_map` does.)

Under tensor parallelism (`distributed.sharding.Parts`, the training
pass) the experts split over `model` (the JAX `("expert", "fsdp",
None)` leaves): every position routes the whole (replicated) tokens by
its copy of the router and makes the same dispatch (a `DataSplit`'s
offsets are the first position's, copied), packs the slots of its own
E/M experts, runs them, and the expert rows are all-gathered in model
order for each position's combine ("sorted_ep"; "dense" and "shard_ep"
raise there).

Two rules keep the routing and the combine exact and repeatable:

- top-k takes the K largest logits with ties to the lower expert id, the
  rule of `jax.lax.top_k`, by a stable descending sort; the dispatch
  sorts the slots by a stable sort, as `jnp.argsort`.
- the combine adds each token's K weighted slots one by one in bf16, in
  the sorted (expert id) order, the order of XLA's scatter-add; no
  atomics, so a card run repeats bit for bit.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..distributed.sharding import Parts, constrain, data_shard
from .layers import ACTS, CDT, _param

__all__ = ["MoE", "Dispatch", "DataSplit", "router_logits", "topk_route",
           "route", "dispatch", "combine", "capacity", "moe_dense",
           "moe_sorted_ep", "moe_apply"]


class MoE(nn.Module):
    """The experts and their router (the JAX leaves `router`, `w_gate`,
    `w_up`, `w_down`)."""

    def __init__(self, cfg: ArchConfig, d_ff: int, *, generator=None,
                 device=None):
        super().__init__()
        d, E = cfg.d_model, cfg.n_experts
        self.router = _param((d, E), generator, device)
        self.w_gate = _param((E, d, d_ff), generator, device)
        self.w_up = _param((E, d, d_ff), generator, device)
        self.w_down = _param((E, d_ff, d), generator, device)

    def forward(self, x, cfg: ArchConfig, split=None):
        return moe_apply(self, x, cfg, split)


class Dispatch(NamedTuple):
    """Where the T·K (token, slot) pairs go, in the sorted order."""
    order: torch.Tensor       # (T·K,) flat slot of each sorted position
    sorted_e: torch.Tensor    # (T·K,) its expert id
    tok_of: torch.Tensor      # (T·K,) its token
    keep: torch.Tensor        # (T·K,) bool: within the expert's capacity
    safe_pos: torch.Tensor    # (T·K,) its row in the expert's buffer
                              # (`cap`, the scratch row, when dropped)
    cap: int                  # the buffer's rows before the scratch row


class DataSplit:
    """A batch of `tokens` tokens split over data shards whose passes run
    in shard order (set `shard` before each): the whole batch's dispatch
    for each shard's slots. `offsets` hands a layer, on a shard's first
    pass through it, the slots the earlier shards routed to each expert
    (and records the shard's own for the next); a remat recomputation
    gets the same offsets again. `dropped` collects each first pass's
    count of slots dropped at capacity (0-d tensors on the shards'
    devices). A layer is known by the order in which a shard meets it.
    Shards run in lockstep threads (`distributed.sharding.run_shards`)
    take their index from there (their block of the batch's rows: each
    set of replicas has a `DataSplit` of its own), and each waits at a
    layer for the shards before it."""

    def __init__(self, tokens: int):
        self.tokens = tokens
        self.shard = 0
        self.dropped: list[torch.Tensor] = []
        self._after: dict = {}       # layer -> counts of the shards so far
        self._offsets: dict = {}     # (shard, layer) -> its offsets
        self._done: dict = {}        # layer -> shards that recorded it
        self._seen: dict = {}        # shard -> {id(module): layer}
        self._cond = threading.Condition()

    def offsets(self, layer, counts) -> tuple[torch.Tensor, bool]:
        """(E,) slots of each expert of `layer` before this shard's, on
        counts' device, and whether this is the shard's first pass."""
        group = data_shard()
        k = self.shard if group is None else group[0].layout.row[group[1]]
        with self._cond:
            # a layer is the n-th one the shard meets: shards may run
            # skeletons of their own, so the modules differ, the order not
            seen = self._seen.setdefault(k, {})
            layer = seen.setdefault(id(layer), len(seen))
            key = (k, layer)
            first = key not in self._offsets
            if first:
                while group is not None and self._done.get(layer, 0) < k:
                    if group[0].broken:
                        raise threading.BrokenBarrierError
                    self._cond.wait(0.1)
                before = self._after.get(layer)
                off = torch.zeros_like(counts) if before is None else \
                    before.to(counts.device, non_blocking=True)
                self._offsets[key] = off
                self._after[layer] = off + counts
                self._done[layer] = k + 1
                self._cond.notify_all()
            return self._offsets[key], first


def router_logits(moe: MoE, x2d) -> torch.Tensor:
    """(T, d) bf16 -> (T, E) float32: the bf16 product, cast up. The
    router is replicated onto the tokens' device."""
    return (x2d @ moe.router.to(x2d.device, CDT)).to(torch.float32)


def topk_route(logits, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, E) float32 logits -> (topi (T, k) int64, gate weights (T, k)
    bf16): the k largest in the float total order (-0 below +0), ties to
    the lower expert id (`jax.lax.top_k`'s rule: a stable descending
    sort of the order-preserving integer keys), and the softmax of their
    logits."""
    bits = logits.to(torch.float32).view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)     # float total order
    idx = torch.sort(keys, dim=-1, descending=True, stable=True)[1][:, :k]
    w = torch.softmax(torch.gather(logits, 1, idx), dim=-1)
    return idx, w.to(CDT)


def route(moe: MoE, x2d, cfg: ArchConfig):
    """The JAX package's `_route`: (T, d) -> (topi, w)."""
    return topk_route(router_logits(moe, x2d), cfg.top_k)


def dispatch(topi, n_experts: int, cap: int, offsets=None) -> Dispatch:
    """The sorted_ep plan of (T, K) expert ids at capacity `cap`: a
    stable sort by expert id, each slot's position within its expert,
    and whether it fits. `offsets` (E,): the slots each expert took
    before these (an earlier data shard's), counted against `cap`; the
    buffer then has min(cap, T·K) rows."""
    T, K = topi.shape
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts           # exclusive prefix
    pos_in_e = torch.arange(T * K, device=topi.device) - starts[sorted_e]
    if offsets is None:
        keep = pos_in_e < cap
    else:
        keep = pos_in_e + offsets[sorted_e] < cap
        cap = min(cap, T * K)
    safe_pos = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap))
    return Dispatch(order, sorted_e, order // K, keep, safe_pos, cap)


def combine(w, y_slots, plan: Dispatch, T: int):
    """The weighted combine: y[t] = sum of w·y over token t's kept slots
    (y_slots in the sorted order, dropped ones zero), each product and
    each add rounded to bf16, added one by one in the sorted order (the
    JAX package's `.at[tok_of].add`, as XLA's scatter runs it)."""
    K = w.shape[1]
    contrib = w.reshape(-1)[plan.order][:, None] * y_slots      # bf16
    # each token's sorted positions, ascending (a stable sort by token)
    by_tok = torch.argsort(plan.tok_of, stable=True).reshape(T, K)
    y = contrib[by_tok[:, 0]]
    for j in range(1, K):
        y = y + contrib[by_tok[:, j]]
    return y


def _experts(buf, w_gate, w_up, w_down, act):
    """The grouped products of an (E, rows, d) buffer with E experts'
    weights, bf16."""
    g = torch.bmm(buf, w_gate.to(CDT))
    u = torch.bmm(buf, w_up.to(CDT))
    return torch.bmm(act(g) * u, w_down.to(CDT))


def capacity(T: int, cfg: ArchConfig) -> int:
    """Slots an expert takes for T tokens (the JAX package's rule)."""
    return max(1, int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def moe_dense(moe: MoE, x2d, cfg: ArchConfig):
    """Oracle: (T, d) -> (T, d), every expert on every token."""
    topi, w = route(moe, x2d, cfg)
    act = ACTS[cfg.act]
    g = torch.einsum("td,edf->tef", x2d, moe.w_gate.to(CDT))
    u = torch.einsum("td,edf->tef", x2d, moe.w_up.to(CDT))
    y_all = torch.einsum("tef,efd->ted", act(g) * u, moe.w_down.to(CDT))
    T = x2d.shape[0]
    sel = y_all[torch.arange(T, device=x2d.device)[:, None], topi]
    return (w[..., None] * sel).sum(dim=1)


def moe_sorted_ep(moe: MoE, x2d, cfg: ArchConfig, split=None):
    """(T, d) -> (T, d): sort by expert, capacity buffer, grouped
    products, combine; with a `DataSplit`, as one data shard of the
    split batch."""
    T, d = x2d.shape
    E = cfg.n_experts
    topi, w = route(moe, x2d, cfg)
    if split is None:
        plan = dispatch(topi, E, capacity(T, cfg))
    else:
        off, first = split.offsets(moe, torch.bincount(topi.reshape(-1),
                                                       minlength=E))
        plan = dispatch(topi, E, capacity(split.tokens, cfg), off)
        if first:
            split.dropped.append((~plan.keep).sum())
    cap = plan.cap
    # pack to (E, cap + 1, d); row `cap` takes the dropped slots
    buf = torch.zeros((E, cap + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf[plan.sorted_e, plan.safe_pos] = x2d[plan.tok_of]
    yb = _experts(buf, moe.w_gate, moe.w_up, moe.w_down, ACTS[cfg.act])
    y_slots = yb[plan.sorted_e, plan.safe_pos]
    y_slots = torch.where(plan.keep[:, None], y_slots,
                          torch.zeros((), dtype=yb.dtype, device=yb.device))
    return combine(w, y_slots, plan, T)


def moe_apply(moe: MoE, x, cfg: ArchConfig, split=None):
    """(B, S, d) bf16 -> (B, S, d) through `cfg.moe_impl`: "dense",
    "shard_ep" (`moe_shard_apply`), else "sorted_ep" (with `split`, the
    dispatch of the whole batch x is a data shard of)."""
    if isinstance(x, Parts):
        return _moe_tp(moe, x, cfg, split)
    if cfg.moe_impl == "shard_ep":
        from .moe_shard import moe_shard_apply
        return moe_shard_apply(moe, x, cfg)
    B, S, d = x.shape
    if cfg.moe_impl == "dense":
        return moe_dense(moe, x.reshape(B * S, d), cfg).reshape(B, S, d)
    return moe_sorted_ep(moe, x.reshape(B * S, d), cfg,
                         split).reshape(B, S, d)


def _moe_tp(moe: MoE, x: Parts, cfg: ArchConfig, split=None) -> Parts:
    """"sorted_ep" over `Parts` (the module docstring): -> y whole."""
    if cfg.moe_impl != "sorted_ep":
        raise ValueError(f"moe_impl={cfg.moe_impl!r} under tensor "
                         "parallelism: the experts split over `model` by "
                         "the sorted_ep dispatch")
    B, S, d = x[0].shape
    T, E = B * S, cfg.n_experts
    El = moe.w_gate[0].shape[0]           # the experts a position holds
    plans, ws, bufs = [], [], []
    for j, xj in enumerate(x):
        x2d = xj.reshape(T, d)
        topi, w = topk_route((x2d @ moe.router[j].to(CDT)).to(torch.float32),
                             cfg.top_k)
        if split is None:
            plan = dispatch(topi, E, capacity(T, cfg))
        else:
            counts = torch.bincount(topi.reshape(-1), minlength=E)
            off, first = split.offsets(moe, counts)
            plan = dispatch(topi, E, capacity(split.tokens, cfg),
                            off.to(counts.device, non_blocking=True))
            if first:
                split.dropped.append((~plan.keep).sum())
        e0 = j * El if moe.w_gate.layout == 0 else 0
        own = (plan.sorted_e >= e0) & (plan.sorted_e < e0 + El)
        # another position's slots go to a scratch expert, El
        rows = torch.where(own, plan.sorted_e - e0,
                           torch.full_like(plan.sorted_e, El))
        buf = torch.zeros((El + 1, plan.cap + 1, d), dtype=x2d.dtype,
                          device=x2d.device)
        buf[rows, plan.safe_pos] = x2d[plan.tok_of]
        plans.append(plan)
        ws.append(w)
        bufs.append(buf[:El])
    layout = 0 if moe.w_gate.layout == 0 else "whole"
    buf = constrain(x.like(bufs, layout), "expert", "batch", None)
    yb = buf.map(lambda b, wg, wu, wd: _experts(b, wg, wu, wd, ACTS[cfg.act]),
                 moe.w_gate, moe.w_up, moe.w_down)
    yb = constrain(yb, "expert", "batch", None)
    yb = constrain(yb, None, "batch", None)      # every expert's rows
    out = []
    for j, ybj in enumerate(yb):
        plan = plans[j]
        y_slots = ybj[plan.sorted_e, plan.safe_pos]
        y_slots = torch.where(plan.keep[:, None], y_slots, torch.zeros(
            (), dtype=ybj.dtype, device=ybj.device))
        out.append(combine(ws[j], y_slots, plan, T).reshape(B, S, d))
    return constrain(x.like(out, "whole"), "batch", None, None)
