"""The train, prefill and serve steps, on one card or over a (data,
model) or (pod, data, model) mesh.

The port's counterpart of the JAX package's `launch/steps.py::
build_train`, `opt_state_axes`, `build_prefill` and `build_serve` (the
JAX builders' `ShapeDtypeStruct` argument specs are the TPU dry runs'
tooling and are not ported, nor is `build_step`).

Over a mesh the step is the JAX trainer's under `rules_for_cell`: the
batch split over `data` (over `("pod", "data")`, pod-major, on a pod
mesh: `distributed.sharding.ShardLayout`), every parameter and
optimizer state split over `data` on its `fsdp` dimension and
replicated over `pod` (`models.lm.place_params`). The data shards run
one after the other from the host, each on its own device:

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

Serving over a mesh (`build_prefill`, `build_serve`) runs the JAX
builders' steps under a serving cell's rules: each data shard decodes
its rows of the batch against its slices of caches placed by
`models.lm.cache_axes`, over its model positions where `model` > 1
(each layer's cache and PIM branches in `nn.layers`); the logits are
gathered onto the mesh's first device. The data shards run in lockstep
threads, so each protected projection's scale is the whole batch's as
in the JAX step. Two layouts of the batch (`ShardLayout`): split over
the axes its rule names (rows pod-major), or whole (`long_500k`'s one
sequence), every data shard then a replica of the others but for its
block of the KV rows (context parallelism: the prefill runs whole on
each replica and keeps each position's rows; a decode step's attention
merges every block's partial softmax, `nn.layers._decode_split`). A
replica's protected words are not counted again, and its MoE layers
dispatch its batch as the unsharded call does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed.sharding import (NamedSharding, Parts, ShardLayout,
                                    _spec_axes, model_dim, named_sharding,
                                    run_shards)
from ..kernels import build
from ..models.lm import (LM, PlacedLM, cache_shardings, decode_step,
                         init_caches, loss_fn, param_axes, param_shardings,
                         pim_param_axes, prefill)
from ..nn.moe import DataSplit
from ..optim import make_optimizer, stacked_leaf, warmup_cosine
from .cells import optimizer_for

__all__ = ["opt_state_axes", "build_train", "build_prefill", "build_serve"]


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


def _check_mesh(mesh, rules: dict) -> ShardLayout:
    """The mesh step's condition on its rules: the batch split over every
    data shard (no replicas), over `data` (and `pod`)."""
    layout = ShardLayout(mesh, rules)
    if layout.replicated or "data" not in _spec_axes(rules.get("batch")):
        raise ValueError(f"the data-parallel step splits the batch over "
                         f"every data shard (`data`, and `pod`); the rules "
                         f"give {rules.get('batch')!r} on {mesh}")
    return layout


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
    layout = _check_mesh(mesh, rules)
    moe = any(spec.moe for spec in cfg.group_spec)
    devices = layout.devices                  # data shard k on devices[k]
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
                    r0 = rows.start + layout.row[k] * per
                    sb = {key: v[r0:r0 + per].to(dev, non_blocking=True)
                          for key, v in host.items()}
                    if split is not None:
                        split.shard = layout.row[k]
                    weights = (model.weights(None, shard=k, rules=rules)
                               if tp else model.weights(dev))
                    with build.at_position(layout.positions[k][0]):
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


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------


def _serve_ctx(cfg: ArchConfig, pim_ctx):
    """`pim_ctx`, or the JAX `_maybe_ctx`'s fault-free context where the
    config enables PIM."""
    if pim_ctx is not None or not cfg.pim.enabled:
        return pim_ctx
    from ..core.context import PIMContext
    return PIMContext(cfg.pim)


def _serve_param_axes(cfg: ArchConfig) -> dict:
    axes = param_axes(cfg)
    if cfg.pim.enabled and cfg.pim.precoded:
        axes = pim_param_axes(axes, cfg)
    return axes


def _serve_shardings(cfg: ArchConfig, mesh, rules: dict) -> tuple:
    """(params, batch, logits, caches) shardings of a serving cell."""
    p_sh = param_shardings(cfg, mesh, rules, _serve_param_axes(cfg))
    b_sh = {"tokens": named_sharding(mesh, rules, ("batch", None))}
    if cfg.aux_kind:
        b_sh["aux"] = named_sharding(mesh, rules, ("batch", None, None))
    lg_sh = named_sharding(mesh, rules, ("batch", None, "vocab"))
    return p_sh, b_sh, lg_sh, cache_shardings(cfg, mesh, rules)


class _Shards:
    """The data shards of a serving step over a mesh (`ShardLayout`):
    shard k's rows of the batch on its device (the whole batch where the
    rules keep it whole), its weights (`ShardWeights`, of its model
    positions where `model` > 1) and its slices of placed caches."""

    def __init__(self, mesh, rules: dict):
        self.mesh, self.rules = mesh, rules
        self.layout = ShardLayout(mesh, rules)
        self.devices = self.layout.devices
        self.tp = mesh.shape.get("model", 1) > 1
        self.by_shard: list = []         # the last step's logits a shard

    def run(self, fn) -> list:
        """[fn(k) for each data shard k], in lockstep threads
        (`distributed.sharding.run_shards`): a protected projection's
        activation scale is the whole batch's."""
        return run_shards(fn, self.layout)

    def split(self, cfg: ArchConfig, tokens: int):
        """Each shard's `DataSplit` where MoE layers dispatch over more
        than one block of rows (the whole batch's capacity; one for each
        replica index, so replicas dispatch apart), else None."""
        if self.layout.row_blocks > 1 and any(s.moe for s in cfg.group_spec):
            splits = [DataSplit(tokens)
                      for _ in range(max(self.layout.replica) + 1)]
            return [splits[r] for r in self.layout.replica]
        return [None] * len(self.devices)

    def rows(self, batch: dict) -> list:
        """Each shard's rows of `batch` ("tokens", "aux") on its device."""
        host = {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v.cpu()) for k, v in batch.items()
            if v is not None and k != "pos"}
        B, n = host["tokens"].shape[0], self.layout.row_blocks
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} data "
                             "shards")
        per = B // n
        return [{k: v[r * per:(r + 1) * per].to(dev, non_blocking=True)
                 for k, v in host.items()}
                for r, dev in zip(self.layout.row, self.devices)]

    def weights(self, model: PlacedLM, k: int):
        """Shard k's `ShardWeights`, in a skeleton of its own (shards in
        lockstep threads swap their weights in at once)."""
        skel = model.skeleton_of(k)
        return (model.weights(None, shard=k, rules=self.rules,
                              skeleton=skel) if self.tp
                else model.weights(self.devices[k], skeleton=skel))

    def view(self, caches: dict, k: int) -> dict:
        """Shard k's slices of placed caches: `Parts` of its model
        positions' tensors (laid out as `model` splits each entry), or
        its one position's tensors."""
        positions = self.layout.positions[k]

        def part(p):
            if not self.tp:
                return p.local[positions[0]]
            md = model_dim(p.sharding, p.ndim)
            return Parts([p.local[pos] for pos in positions],
                         "whole" if md is None else md,
                         positions=positions, rules=self.rules)
        return {pos: {name: part(p) for name, p in e.items()}
                for pos, e in caches.items()}

    def gather(self, logits: list) -> torch.Tensor:
        """Each block of rows' logits (its first replica's), in row order,
        on the mesh's first device; every shard's are kept in
        `by_shard`."""
        self.by_shard = logits
        first = self.mesh.device
        rows: dict = {}
        for r, lg in zip(self.layout.row, logits):
            rows.setdefault(r, lg)
        return torch.cat([rows[r].to(first, non_blocking=True)
                          for r in sorted(rows)])


def _fill(placed, caches: dict, k: int, shards: _Shards) -> None:
    """Shard k's prompt caches (`prefill`'s, whole over the sequence)
    written into its slices of `placed`: each position's block of the K/V
    rows into its first rows, the rest whole."""
    blocks = shards.layout.kv_block[k]
    for pos, e in shards.view(placed, k).items():
        for name, dst in e.items():
            src = caches[pos][name]
            split = isinstance(dst, Parts)
            for j, (d, t) in enumerate(zip(dst, src) if split
                                       else [(dst, src)]):
                if name not in ("k", "v"):
                    d.copy_(t)
                    continue
                Wl = d.shape[2]               # (G, B, Wl, ...) a position
                t = t[:, :, blocks[j] * Wl:(blocks[j] + 1) * Wl]
                d[:, :, :t.shape[2]] = t


def build_prefill(cfg: ArchConfig, *, mesh=None, rules=None, pim_ctx=None):
    """-> (prefill_step, shardings), the JAX `build_prefill`'s step.

    `shardings(mesh, rules)` gives ((params, batch), (logits, caches))
    shardings as the JAX builder's: the parameters by `param_axes` (and
    `pim_param_axes` for a precoded PIM config, whose `*_enc` weights
    split by rows with `wo` and `w_down`), "tokens" (and "aux") over
    `batch`, the logits over `batch` and `vocab`, the caches by
    `cache_axes`.

    `prefill_step(model, batch, max_seq=None)` -> (logits (B, S, V)
    float32, caches): `batch` holds "tokens" (B, S) (and "aux"), numpy
    or tensors. Without `mesh` it is `models.lm.prefill` on the model's
    device (caches S long, as there). With `mesh` (and `rules`,
    `rules_for_cell`'s), `model` is a `PlacedLM` placed by
    `shardings(mesh, rules)`; each data shard runs its rows, over its
    model positions (`Parts`) where `model` > 1, and the caches come
    back placed by `cache_axes` (`init_caches(..., mesh=...)`),
    `max_seq` rows long (the prompt's length by default) with the
    prompt in their first rows; the logits are gathered onto the mesh's
    first device (each data shard's, replicas' too, stay in the step's
    `shards.by_shard`). A `model` axis of 1 runs the unsharded `prefill`
    on each data shard. MoE layers dispatch as the whole batch does (its
    capacity, `nn.moe.DataSplit`), as the JAX dispatch of the whole
    batch does. `pim_ctx` protects the config's target projections
    (by default a fault-free `PIMContext(cfg.pim)` where PIM is
    enabled)."""
    ctx = _serve_ctx(cfg, pim_ctx)

    def shardings(mesh, rules):
        p_sh, b_sh, lg_sh, c_sh = _serve_shardings(cfg, mesh, rules)
        return (p_sh, b_sh), (lg_sh, c_sh)

    if mesh is None:
        def prefill_step(model: LM, batch, max_seq=None):
            tokens = torch.as_tensor(batch["tokens"], device=model.device)
            return prefill(model, cfg, tokens, aux=batch.get("aux"),
                           pim_ctx=ctx)
        return prefill_step, shardings
    shards = _Shards(mesh, rules)

    def mesh_prefill_step(model: PlacedLM, batch, max_seq=None):
        parts = shards.rows(batch)
        B, S = np.shape(batch["tokens"])
        caches = init_caches(cfg, B, max_seq or S, mesh=mesh, rules=rules)
        splits = shards.split(cfg, B * S)

        def shard(k):
            split = splits[k]
            sb = parts[k]
            weights = shards.weights(model, k)
            with build.at_position(shards.layout.positions[k][0]):
                lg, c = prefill(weights.skeleton, cfg, sb["tokens"],
                                aux=sb.get("aux"), pim_ctx=ctx,
                                weights=weights, split=split)
            _fill(caches, c, k, shards)
            return lg
        return shards.gather(shards.run(shard)), caches
    mesh_prefill_step.shards = shards
    return mesh_prefill_step, shardings


def build_serve(cfg: ArchConfig, batch: int, max_seq: int, *, mesh=None,
                rules=None, pim_ctx=None):
    """-> (serve_step, shardings), the JAX `build_serve`'s one-token
    decode against `max_seq`-deep caches of `batch` rows.

    `shardings(mesh, rules)` gives ((params, caches, batch), (logits,
    caches)) shardings as the JAX builder's ("pos" None: an int).
    `serve_step(model, caches, batch)` -> (logits (B, 1, V) float32,
    caches): `batch` holds "tokens" (B, 1) and "pos" (an int), and
    "aux" where the config takes it. Without `mesh` it is
    `models.lm.decode_step` on the model's device. With `mesh`, `model`
    is a `PlacedLM` and `caches` the placed caches of `build_prefill`'s
    step or of `init_caches(cfg, batch, max_seq, mesh=..., rules=...)`,
    written in place: each data shard decodes its rows, over its model
    positions where `model` > 1. MoE layers dispatch as the whole batch
    does, as in `build_prefill`. `pim_ctx` as for `build_prefill`."""
    ctx = _serve_ctx(cfg, pim_ctx)

    def shardings(mesh, rules):
        p_sh, b_sh, lg_sh, c_sh = _serve_shardings(cfg, mesh, rules)
        return (p_sh, c_sh, dict(b_sh, pos=None)), (lg_sh, c_sh)

    if mesh is None:
        def serve_step(model: LM, caches, batch_):
            tokens = torch.as_tensor(batch_["tokens"], device=model.device)
            return decode_step(model, cfg, caches, tokens, batch_["pos"],
                               aux=batch_.get("aux"), pim_ctx=ctx)
        return serve_step, shardings
    shards = _Shards(mesh, rules)

    def mesh_serve_step(model: PlacedLM, caches, batch_):
        splits = shards.split(cfg, np.shape(batch_["tokens"])[0])
        parts = shards.rows(batch_)

        def shard(k):
            split = splits[k]
            sb = parts[k]
            weights = shards.weights(model, k)
            with build.at_position(shards.layout.positions[k][0]):
                return decode_step(weights.skeleton, cfg,
                                   shards.view(caches, k), sb["tokens"],
                                   batch_["pos"], aux=sb.get("aux"),
                                   pim_ctx=ctx, weights=weights,
                                   split=split)[0]
        return shards.gather(shards.run(shard)), caches
    mesh_serve_step.shards = shards
    return mesh_serve_step, shardings
