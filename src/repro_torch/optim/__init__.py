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
"""
from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

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


def _global_norm(grads):
    total = sum(torch.sum(torch.square(g.to(F32))) for g in _tensors(grads))
    return torch.sqrt(total)


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
    return g if scale is None else g * scale.to(g.device)


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
            return {k: [torch.zeros_like(p, dtype=F32) for p in ts]
                    for k, ts in params.items()}
        return {"m": zeros(), "v": zeros(), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        scale, gn = _clip_scale(grads, clip)
        step = state["step"] + 1
        lr_t = sched(step)
        bc1, bc2 = _scalar(b1, step), _scalar(b2, step)
        for k, ps in params.items():
            for p, g, m, v in zip(ps, grads[k], state["m"][k],
                                  state["v"][k], strict=True):
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
            shape, dev = shape_of(k, ts), ts[0].device
            if len(shape) >= 2:
                f[k] = {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                        "vc": torch.zeros(shape[:-2] + shape[-1:],
                                          dtype=F32, device=dev)}
            else:
                f[k] = {"v": torch.zeros(shape, dtype=F32, device=dev)}
        state = {"f": f, "step": 0}
        if momentum:
            state["m"] = {k: [torch.zeros_like(p, dtype=F32) for p in ts]
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


def make_optimizer(name: str, lr, **kw) -> Transform:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise KeyError(f"unknown optimizer {name!r}")
