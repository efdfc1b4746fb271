"""The train step: loss, backward and the optimizer update, on one card or
data-parallel over a mesh (FSDP).

The port's counterpart of the JAX package's `launch/steps.py::
build_train` and `opt_state_axes`. Prefill and serve steps are the
model's own `prefill` / `decode_step` (the JAX package's `build_prefill`
and `build_serve` are the TPU dry runs' tooling).

Over a mesh the step is the JAX trainer's under `rules_for_cell`: the
batch split over `data`, every parameter and optimizer state split over
`data` on its `fsdp` dimension (`models.lm.place_params`). The data
shards run one after the other from the host, each on its own device:

- shard k takes rows [kB/N, (k+1)B/N) of the batch (of microbatch i,
  rows [iB/m, (i+1)B/m), with m microbatches: the JAX `lax.scan`'s);
- its forward gathers each layer's weights onto its device where the
  layer runs (inside the remat group), and its loss part is its nll sum
  over the whole (micro)batch's label count, counted on the host, so
  the parts add up to the JAX loss however unevenly the ignored labels
  fall;
- its backward sends each slice's gradient back to the slice's device,
  where it adds to the earlier shards' in shard order (a replicated
  leaf's copies are then summed in mesh order), so the sums repeat from
  run to run;
- MoE layers dispatch as the whole batch does (`nn.moe.DataSplit`: the
  whole batch's capacity, and each expert's slots of the earlier shards,
  passed from device to device);
- the optimizer updates each slice on its own device; the global norm
  adds each slice's float64 sum of squares in slice order (only scalars
  cross devices), which rounds to the unsharded trainer's norm, so every
  AdamW step is the unsharded trainer's bit for bit at microbatches =
  shards.

Over a mesh whose `model` axis is larger than 1 the step is also tensor
parallel, the JAX trainer's under the same rules: data shard k runs on
its model positions (k, j), one tensor a position
(`distributed.sharding.Parts`), each reading its slice of every leaf
the rules split over `model` (`ShardWeights(shard=k)`: gathered over
`data` only). Each layer runs at every position in turn, then the
collectives its `constrain` calls name (row-parallel partial sums added
in float32 and rounded to bf16 once); the logits' vocabulary slices are
gathered onto the first position, where the loss is taken once; the
backward runs the adjoint collectives, so a position's copy of a
replicated activation takes only the gradient of its own work, and a
replicated leaf's copies are summed over positions in mesh order as
over data shards. Shards and positions are enqueued one after the other
from the host. `launches_by_shard` lists each mesh position's kernel
launches, in mesh order, and `heads_by_shard` the (call, query heads, KV
heads) of its flash calls.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed.sharding import (NamedSharding, axis_devices,
                                    named_sharding)
from ..kernels import build
from ..models.lm import (LM, PlacedLM, loss_fn, model_positions, param_axes,
                         param_shardings)
from ..nn.moe import DataSplit
from ..optim import make_optimizer, stacked_leaf, warmup_cosine
from .cells import optimizer_for

__all__ = ["opt_state_axes", "build_train"]


def opt_state_axes(opt_name: str, p_axes: dict, p_shapes: dict) -> dict:
    """Logical axes of the optimizer state, parallel to `optim`'s state
    tree (the JAX package's): AdamW's moments as the leaves, Adafactor's
    `vr` without the last dimension and `vc` without the one before it,
    a vector's `v` as the leaf; `step` replicated. `p_axes` and
    `p_shapes` are keyed by leaf path (`models.lm.param_axes`, the
    stacked shapes)."""
    if opt_name == "adamw":
        return {"m": p_axes, "v": p_axes, "step": ()}
    f = {}
    for path, ax in p_axes.items():
        if len(p_shapes[path]) >= 2:
            f[path] = {"vr": tuple(ax[:-1]),
                       "vc": tuple(ax[:-2]) + (ax[-1],)}
        else:
            f[path] = {"v": tuple(ax)}
    return {"f": f, "step": ()}


def _leaf_shapes(cfg: ArchConfig) -> dict:
    """Each leaf's shape as the JAX pytree stacks it (no allocation)."""
    return {path: ((len(ps),) if stacked_leaf(path) else ())
            + tuple(ps[0].shape)
            for path, ps in LM(cfg, device="meta").leaves().items()}


def _check_mesh(mesh, rules: dict) -> None:
    """The mesh step's condition on its rules."""
    if rules.get("batch") != "data":
        raise ValueError(f"the data-parallel step splits the batch over "
                         f"`data`; the rules give {rules.get('batch')!r}")


def build_train(cfg: ArchConfig, microbatches: int = 1, *, mesh=None,
                rules=None, lr: float = 3e-4, total_steps: int = 10000):
    """-> (train_step, tx, shardings).

    `tx` is `optimizer_for(cfg)` (AdamW or Adafactor) under
    `warmup_cosine(lr, 200, total_steps)`. `shardings(mesh, rules)` gives
    ((params, opt_state, batch), (params, opt_state, metrics)) shardings
    as the JAX `build_train`'s: params and AdamW moments keyed and
    listed like `LM.leaves()` (one `NamedSharding` a tensor), Adafactor's
    factored state one a leaf, the int `step` None (not placed), the
    batch's "tokens", "labels" (and "aux") over `batch`.

    Without `mesh`, `train_step(model, opt_state, batch)` runs on the
    model's device: the loss and its backward over `microbatches` equal
    slices of the batch (gradients accumulate in the parameters' fp32
    `.grad`, then divide by the slice count), the update in place
    through `tx`. With `mesh` (and `rules`, `rules_for_cell`'s), `model`
    is a `PlacedLM` placed by `shardings(mesh, rules)` and the step is
    data-parallel, and tensor-parallel where the mesh's `model` axis is
    larger than 1 (the module docstring). Either way it returns
    (opt_state, metrics): "loss" and "grad_norm" as 0-d tensors (on the
    mesh's first device), and over a mesh "moe_dropped" (the slots MoE
    layers dropped at capacity, 0-d), "launches_by_shard" (each mesh
    position's kernel launches, by kernel name, in mesh order) and
    "heads_by_shard" (each position's flash calls' head counts).
    `batch` holds "tokens" and "labels" (B, S), numpy or tensors, and
    "aux" (B, Na, d_model) for the configs that take auxiliary
    embeddings."""
    name = optimizer_for(cfg)
    tx = make_optimizer(name, warmup_cosine(lr, 200, total_steps))
    mb = microbatches
    p_axes = param_axes(cfg)
    o_axes = opt_state_axes(name, p_axes, _leaf_shapes(cfg))

    def shardings(mesh, rules):
        p_sh = param_shardings(cfg, mesh, rules)
        if name == "adamw":
            o_sh = {"m": p_sh, "v": p_sh, "step": None}
        else:
            o_sh = {"f": {path: {k: named_sharding(mesh, rules, ax)
                                 for k, ax in st.items()}
                          for path, st in o_axes["f"].items()},
                    "step": None}
        b_sh = {k: named_sharding(mesh, rules, ("batch", None))
                for k in ("tokens", "labels")}
        if cfg.aux_kind:
            b_sh["aux"] = named_sharding(mesh, rules, ("batch", None, None))
        rep = NamedSharding(mesh, ())
        m_sh = {"loss": rep, "grad_norm": rep}
        return (p_sh, o_sh, b_sh), (p_sh, o_sh, m_sh)

    def train_step(model: LM, opt_state, batch):
        dev = model.device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        if tokens.shape[0] % mb:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{mb} microbatches")
        auxs = [None] * mb
        if batch.get("aux") is not None:
            auxs = torch.as_tensor(batch["aux"], device=dev).chunk(mb)
        model.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for t, lab, aux in zip(tokens.chunk(mb), labels.chunk(mb), auxs,
                               strict=True):
            part = loss_fn(model, cfg, {"tokens": t, "labels": lab,
                                        "aux": aux})
            part.backward()
            loss += part.detach()
        leaves = model.leaves()
        grads = {k: [p.grad / mb if mb > 1 else p.grad for p in ps]
                 for k, ps in leaves.items()}
        _, opt_state, gnorm = tx.update(grads, opt_state, leaves)
        model.zero_grad(set_to_none=True)
        return opt_state, {"loss": loss / mb, "grad_norm": gnorm}

    if mesh is None:
        return train_step, tx, shardings
    _check_mesh(mesh, rules)
    moe = any(spec.moe for spec in cfg.group_spec)
    devices = axis_devices(mesh, "data")      # data shard k on devices[k]
    tp = mesh.shape.get("model", 1) > 1
    order = list(np.ndindex(mesh.devices.shape))

    def fsdp_step(model: PlacedLM, opt_state, batch):
        n = len(devices)
        host = {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v.cpu()) for k, v in batch.items()
            if v is not None}
        B = host["tokens"].shape[0]
        if B % (mb * n):
            raise ValueError(f"batch {B} does not split into {mb} "
                             f"microbatches over {n} data shards")
        per = B // (mb * n)
        model.zero_grad()
        parts, dropped = [], []
        with build.by_position() as log:
            for i in range(mb):
                rows = slice(i * B // mb, (i + 1) * B // mb)
                count = max(int((host["labels"][rows] >= 0).sum()), 1)
                split = DataSplit(host["tokens"][rows].numel()) if moe \
                    else None
                for k, dev in enumerate(devices):
                    r0 = rows.start + k * per
                    sb = {key: v[r0:r0 + per].to(dev, non_blocking=True)
                          for key, v in host.items()}
                    if split is not None:
                        split.shard = k
                    weights = (model.weights(None, shard=k, rules=rules)
                               if tp else model.weights(dev))
                    with build.at_position(model_positions(mesh, k)[0]):
                        part = loss_fn(model.skeleton, cfg, sb,
                                       weights=weights, split=split,
                                       count=count)
                        part.backward()
                    parts.append(part.detach())
                if split is not None:
                    dropped += split.dropped
        _sum_replica_grads(model)
        first = devices[0]
        loss = 0
        for part in parts:
            loss = loss + part.to(first)
        leaves = model.leaves()
        grads = {k: [p.map(lambda t: t.grad / mb if mb > 1 else t.grad)
                     for p in ps] for k, ps in leaves.items()}
        _, opt_state, gnorm = tx.update(grads, opt_state, leaves)
        model.zero_grad()
        metrics = {"loss": loss / mb, "grad_norm": gnorm,
                   "launches_by_shard": [dict(log.launches.get(pos, {}))
                                         for pos in order],
                   "heads_by_shard": [sorted(log.heads.get(pos, ()))
                                      for pos in order]}
        if moe:
            total = torch.zeros((), dtype=torch.int64, device=first)
            for d in dropped:
                total = total + d.to(first)
            metrics["moe_dropped"] = total
        return opt_state, metrics

    return fsdp_step, tx, shardings


@torch.no_grad()
def _sum_replica_grads(model: PlacedLM) -> None:
    """A slice held on several devices got each device's shards'
    gradients in its copy there: every copy takes their sum, added in
    mesh order."""
    for p in model.placed.values():
        for copies in p.slices().values():
            grads = [c.grad for c in copies if c.grad is not None]
            if len(copies) < 2 or not grads:
                continue
            total = grads[0]
            for g in grads[1:]:
                total = total + g.to(total.device)
            for c in copies:
                c.grad = total.to(c.device, copy=True)
