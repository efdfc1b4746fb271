"""Optimizers and schedules: the port's own copies of the JAX package's
`repro.optim` (same formulas, same constants).

- `adamw`: fp32 moments; weight decay on every parameter (norm scales
  included), `eps` outside the sqrt.
- `adafactor`: factored second moment (`vr`/`vc`) for every leaf of two
  or more dimensions; optional unfactored momentum.
- `warmup_cosine` / `constant_lr`: LR schedules of the step, in float32.
- `clip_grads`: clipping by the global norm, composed into both.

A transform is a pair (init(params) -> state, update(grads, state, params)
-> (params, state, grad_norm)). `params` and `grads` map a leaf path of
the JAX package's parameter pytree to a list of tensors (`LM.leaves()`):
a group leaf lists its per-layer tensors, which the JAX leaf stacks along
a first axis. AdamW is elementwise, so the split changes nothing;
Adafactor factors and clips each leaf as the stacked array it is in the
JAX package (a stacked (n_groups, d) norm scale is factored, and the
update-RMS clip spans every layer of a leaf).

Unlike the JAX package's pure functions, `update` writes the new
parameters into the given tensors and the new moments into the state's
tensors in place (under `torch.no_grad()`), so a full-size model needs no
second copy of either; it returns the same objects.

A leaf's tensors may be placed on a mesh (`distributed.sharding.Placed`,
the data-parallel trainer's parameters): each slice is updated on its
own device, its states placed alike (Adafactor's `vr` / `vc` by the
axes they keep, as `launch.steps.opt_state_axes` gives them). What
spans a whole leaf sums the slices' partials in slice order, so only
scalars and reduced vectors cross devices: the global norm (in float64,
so it rounds to the unplaced norm), and Adafactor's means over a split
dimension and its update RMS (in float32, so they repeat from run to
run but round otherwise than the unplaced leaf's).
"""
from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from ..distributed.sharding import NamedSharding, Placed, place_zeros

F32 = torch.float32


class Transform(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable:
    def sched(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)
    return sched


def constant_lr(lr: float) -> Callable:
    return lambda step: torch.as_tensor(lr, dtype=F32)


def _tensors(tree):
    for ts in tree.values():
        yield from ts


def _local(t) -> list:
    """The tensors an elementwise update writes: a placed tensor's
    distinct slices and copies, else the tensor."""
    return t.distinct() if isinstance(t, Placed) else [t]


def _global_norm(grads):
    """The norm over every leaf: each tensor's sum of squares (a placed
    gradient's one slice at a time, on the slice's device), accumulated
    in float64 and added in leaf and slice order on the first tensor's
    device, so only scalars cross devices. The squares are float32 as
    before; the float64 sums make the total independent of how a leaf is
    cut to about 1e-16, far below the float32 norm's last bit, so a
    mesh's norm is the unplaced one's (a float32 sum of per-slice
    partials rounds otherwise, and AdamW's normalized steps carry a clip
    factor's last bit into every later step)."""
    total = None
    for g in _tensors(grads):
        for t in (g.unique() if isinstance(g, Placed) else (g,)):
            s = torch.sum(torch.square(t.to(F32)), dtype=torch.float64)
            total = s if total is None else total + s.to(total.device)
    return torch.sqrt(total).to(F32)


def clip_grads(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most `max_norm`, the norm
    before clipping). Returns new tensors; the inputs are not changed."""
    scale, gn = _clip_scale(grads, max_norm)
    return {k: [_grad(g, scale) for g in ts] for k, ts in grads.items()}, gn


def _clip_scale(grads, clip):
    """-> (the factor `clip_grads` scales every gradient by, or None
    without clipping; the global norm). The optimizers scale each leaf as
    they reach it, so no clipped copy of all the gradients is held."""
    gn = _global_norm(grads)
    if not clip:
        return None, gn
    return torch.clamp(clip / torch.clamp_min(gn, 1e-9), max=1.0), gn


def _grad(g, scale):
    if scale is None:
        return g
    if isinstance(g, Placed):
        return g.map(lambda t: t * scale.to(t.device))
    return g * scale.to(g.device)


def _zeros_like(p):
    if isinstance(p, Placed):
        return p.map(lambda t: torch.zeros_like(t, dtype=F32))
    return torch.zeros_like(p, dtype=F32)


def _scalar(x, step):
    """`1 - x ** step` in float32, as the JAX package computes it."""
    return 1 - torch.tensor(x, dtype=F32) ** torch.tensor(step, dtype=F32)


def stacked_leaf(path: str) -> bool:
    """Whether a leaf path of the JAX pytree is stacked over layers (the
    groups' and the encoder's leaves)."""
    return path.startswith(("groups/", "encoder/"))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: Callable | float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          clip: float = 1.0) -> Transform:
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        def zeros():
            return {k: [_zeros_like(p) for p in ts]
                    for k, ts in params.items()}
        return {"m": zeros(), "v": zeros(), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        scale, gn = _clip_scale(grads, clip)
        step = state["step"] + 1
        lr_t = sched(step)
        bc1, bc2 = _scalar(b1, step), _scalar(b2, step)
        for k, ps in params.items():
            for leaf in zip(ps, grads[k], state["m"][k], state["v"][k],
                            strict=True):
                for p, g, m, v in zip(*map(_local, leaf), strict=True):
                    g = _grad(g, scale).to(F32)
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    u = (m / bc1.to(m.device)) / (
                        torch.sqrt(v / bc2.to(v.device)) + eps)
                    u = u + weight_decay * p.to(F32)
                    p.copy_((p - lr_t.to(p.device) * u).to(p.dtype))
        state["step"] = step
        return params, state, gn

    return Transform(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; Shazeer & Stern 2018)
# ---------------------------------------------------------------------------


def adafactor(lr: Callable | float, *, decay: float = 0.8, eps: float = 1e-30,
              clip: float = 1.0, momentum: float = 0.0,
              weight_decay: float = 0.0) -> Transform:
    sched = lr if callable(lr) else constant_lr(lr)

    def shape_of(path, ts):
        return ((len(ts),) if stacked_leaf(path) else ()) + tuple(ts[0].shape)

    def init(params):
        f = {}
        for k, ts in params.items():
            if isinstance(ts[0], Placed):
                f[k] = _factored_placed(k, ts)
                continue
            shape, dev = shape_of(k, ts), ts[0].device
            if len(shape) >= 2:
                f[k] = {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:],
                                          dtype=F32, device=dev)}
            else:
                f[k] = {"v": torch.zeros(shape, dtype=F32, device=dev)}
        state = {"f": f, "step": 0}
        if momentum:
            state["m"] = {k: [_zeros_like(p) for p in ts]
                          for k, ts in params.items()}
        return state

    def stack(path, ts):
        return torch.stack(list(ts)) if stacked_leaf(path) else ts[0]

    @torch.no_grad()
    def update(grads, state, params):
        scale, gn = _clip_scale(grads, clip)
        step = state["step"] + 1
        beta = 1.0 - torch.tensor(step, dtype=F32) ** (-decay)
        for k, ps in params.items():
            if isinstance(ps[0], Placed):
                _adafactor_placed(k, ps, grads[k], state, scale, sched(step),
                                  beta, eps, momentum, weight_decay)
                continue
            p = stack(k, ps)
            lr_t = sched(step).to(p.device)
            bt = beta.to(p.device)
            g = _grad(stack(k, grads[k]), scale).to(F32)
            f = state["f"][k]
            g2 = g * g + eps
            if "vr" in f:
                vr = bt * f["vr"] + (1 - bt) * g2.mean(dim=-1)
                vc = bt * f["vc"] + (1 - bt) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp_min(vr.mean(dim=-1)[..., None, None],
                                           eps))
                # zero-grad leaves: rsqrt(0) = inf and 0 * inf = NaN
                u = g * torch.rsqrt(torch.clamp_min(denom, eps))
                f["vr"].copy_(vr)
                f["vc"].copy_(vc)
            else:
                v = bt * f["v"] + (1 - bt) * g2
                u = g * torch.rsqrt(torch.clamp_min(v, eps))
                f["v"].copy_(v)
            # update clipping (RMS <= 1), per the paper
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp_min(rms, 1.0)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            new = (p - lr_t * u).to(p.dtype)
            if momentum:
                m = stack(k, state["m"][k])
                m = momentum * m + (new - p)
                new = (p + m).to(p.dtype)
                for dst, src in zip(state["m"][k], _split(k, m),
                                    strict=True):
                    dst.copy_(src)
            for dst, src in zip(ps, _split(k, new), strict=True):
                dst.copy_(src)
        state["step"] = step
        return params, state, gn

    return Transform(init, update)


def _split(path, x):
    return list(x) if stacked_leaf(path) else [x]


def _stacked_spec(path: str, p: Placed) -> tuple:
    spec = p.sharding.spec + (None,) * (p.ndim - len(p.sharding.spec))
    return ((None,) if stacked_leaf(path) else ()) + spec


def _factored_placed(path: str, ps: list) -> dict:
    """Adafactor's zero state of a placed leaf, placed by the axes each
    keeps: `vr` drops the last dimension, `vc` the one before it (the
    JAX package's `opt_state_axes`); a vector leaf's `v` as the leaf."""
    shape = ((len(ps),) if stacked_leaf(path) else ()) + ps[0].shape
    spec = _stacked_spec(path, ps[0])
    mesh = ps[0].sharding.mesh
    if len(shape) < 2:
        return {"v": place_zeros(shape, NamedSharding(mesh, spec),
                                 name=f"{path}/v")}
    return {"vr": place_zeros(shape[:-1], NamedSharding(mesh, spec[:-1]),
                              name=f"{path}/vr"),
            "vc": place_zeros(shape[:-2] + shape[-1:], NamedSharding(
                mesh, spec[:-2] + spec[-1:]), name=f"{path}/vc")}


def _sum_slices(parts: dict, index: dict, group: dict | None = None) -> dict:
    """{position: partial sum} -> {position: total}: within each group of
    positions (equal `group` values; one group without it), one partial
    a slice (`index`; the first position holding it), added in slice
    order on the first slice's device, the total copied to each
    position's device."""
    group = group or dict.fromkeys(parts, ())
    totals = {}
    for g in dict.fromkeys(group.values()):
        first: dict = {}
        for pos in parts:
            if group[pos] == g:
                first.setdefault(index[pos], pos)
        dev = parts[first[min(first)]].device
        total = 0
        for i in sorted(first):
            total = total + parts[first[i]].to(dev)
        totals[g] = total
    return {pos: totals[group[pos]].to(parts[pos].device) for pos in parts}


@torch.no_grad()
def _adafactor_placed(path, ps, gs, state, scale, lr, beta, eps, momentum,
                      weight_decay):
    """The Adafactor update of one placed leaf (every tensor of it placed
    alike), slice by slice. A mean over a split dimension, and the update
    RMS of a split leaf, sum the slices' partials (`_sum_slices`): along
    that dimension, for each slice of the other split dimensions (a leaf
    split over `data` and `model` along two). Every position's new
    values are computed before any is written: positions on one device
    share the copies of what is not split."""
    stacked = stacked_leaf(path)
    parts = ps[0].sharding.parts(ps[0].ndim)
    parts = ((1,) if stacked else ()) + parts
    split = [d for d, n in enumerate(parts) if n > 1]
    shape = ((len(ps),) if stacked else ()) + ps[0].shape
    nd = len(shape)
    f = state["f"][path]
    seen, positions = set(), []
    for pos, t in ps[0].positions():         # distinct (slice, device)
        if id(t) not in seen:
            seen.add(id(t))
            positions.append(pos)
    sharding = ps[0].sharding
    at = {pos: sharding.index(pos, ps[0].ndim) for pos in positions}

    def total(sums, over):
        """Each position's sum over the split dimensions `over`."""
        def key(pos, inside):
            return tuple(at[pos][d - stacked] for d in split
                         if (d in over) == inside)
        return _sum_slices(sums, {pos: key(pos, True) for pos in sums},
                           {pos: key(pos, False) for pos in sums})

    def local(placed_list, pos):
        ts = [t.local[pos] for t in placed_list]
        return torch.stack(ts) if stacked else ts[0]

    def mean(x, dim):
        """Mean over `dim` of each position's x (all dims of x when
        None), summing the slices' partials where `dim` is split."""
        full = math.prod(shape) if dim is None else shape[dim]
        over = split if dim is None else [d for d in split if d == dim % nd]
        if not over:
            return {pos: (torch.mean(v) if dim is None else v.mean(dim))
                    for pos, v in x.items()}
        sums = {pos: (torch.sum(v) if dim is None else v.sum(dim))
                for pos, v in x.items()}
        return {pos: v / full for pos, v in total(sums, over).items()}

    P = {pos: local(ps, pos) for pos in positions}
    G = {pos: _grad(local(gs, pos), scale).to(F32) for pos in positions}
    g2 = {pos: G[pos] * G[pos] + eps for pos in positions}
    bt = {pos: beta.to(P[pos].device) for pos in positions}
    writes = []
    if "vr" in f:
        rm, cm = mean(g2, -1), mean(g2, -2)
        vr = {pos: bt[pos] * f["vr"].local[pos] + (1 - bt[pos]) * rm[pos]
              for pos in positions}
        vc = {pos: bt[pos] * f["vc"].local[pos] + (1 - bt[pos]) * cm[pos]
              for pos in positions}
        # vr's last dimension is the leaf's dimension -2
        vrm = {pos: x.mean(-1) for pos, x in vr.items()} \
            if nd - 2 not in split else {
                pos: x / shape[-2] for pos, x in total(
                    {p: x.sum(-1) for p, x in vr.items()}, [nd - 2]).items()}
        u = {}
        for pos in positions:
            denom = (vr[pos][..., None] * vc[pos][..., None, :]
                     / torch.clamp_min(vrm[pos][..., None, None], eps))
            u[pos] = G[pos] * torch.rsqrt(torch.clamp_min(denom, eps))
            writes += [(f["vr"].local[pos], vr[pos]),
                       (f["vc"].local[pos], vc[pos])]
    else:
        v = {pos: bt[pos] * f["v"].local[pos] + (1 - bt[pos]) * g2[pos]
             for pos in positions}
        u = {pos: G[pos] * torch.rsqrt(torch.clamp_min(v[pos], eps))
             for pos in positions}
        writes += [(f["v"].local[pos], v[pos]) for pos in positions]
    ms = mean({pos: x * x for pos, x in u.items()}, None)
    for pos in positions:
        p = P[pos]
        uu = u[pos] / torch.clamp_min(torch.sqrt(ms[pos] + 1e-12), 1.0)
        if weight_decay:
            uu = uu + weight_decay * p.to(F32)
        new = (p - lr.to(p.device) * uu).to(p.dtype)
        if momentum:
            m = momentum * local(state["m"][path], pos) + (new - p)
            new = (p + m).to(p.dtype)
            writes += list(zip([t.local[pos] for t in state["m"][path]],
                               _split(path, m)))
        writes += list(zip([t.local[pos] for t in ps], _split(path, new)))
    for dst, src in writes:
        dst.copy_(src)


def make_optimizer(name: str, lr, **kw) -> Transform:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise KeyError(f"unknown optimizer {name!r}")
