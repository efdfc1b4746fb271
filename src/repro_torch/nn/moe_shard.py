"""Expert-parallel MoE: the port of the JAX package's `repro.nn.moe_shard`.

`moe_shard_apply` runs under an active mesh with a `model` axis
(`distributed.sharding.use_rules`), the experts split over the `model`
axis's devices (expert parallelism):

1. the tokens are split over the mesh's other axes (the data shards),
   and each data shard routes its local tokens with the router
   replicated onto its device;
2. each data shard packs its tokens into per-expert capacity buckets
   (E, cap, d), `cap` from its *local* token count, as in the JAX
   package, so which slots drop depends on the data split exactly as it
   does there;
3. the exchange out: expert block j of the buckets goes to model shard
   j's device, where the grouped products of its E / ep experts run;
4. the exchange back returns the products to the data shard, which
   unpacks them and combines each token's slots in `nn.moe`'s order.

Under the JAX `shard_map` every model shard of a data shard holds the
same tokens (they are replicated over `model`), so the ep sends of its
all_to_all are equal, and every model shard computes the same combine.
Here each data shard sends each expert block once, from its device, and
combines once: the same exchange less the duplicate copies, and the same
values. The exchanges are device-to-device copies (`Tensor.to`, over
NVLink between cards), through which autograd gives the backward.

`place_experts` puts each model shard's expert slice on its device once
for each data group's devices (a view where the device is the weights'
own) and keeps it for later calls while nothing records gradients; a call that records them slices
and copies anew, so that the backward reaches the parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed.sharding import active_mesh
from . import moe as _moe
from .layers import ACTS, CDT

__all__ = ["place_experts", "moe_shard_apply"]


def _groups(mesh) -> np.ndarray:
    """The mesh's devices as (data shards, ep): the `model` axis last,
    every other axis flattened into the data shards."""
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index("model"), -1)
    return arr.reshape(-1, arr.shape[-1])


def place_experts(layer, devices) -> list:
    """Each model shard's (w_gate, w_up, w_down) slice of E / ep experts
    on its device, shard j on `devices[j]`. Kept on the layer, one
    placement for each tuple of devices (each data group's model shards),
    and reused while the weights are unchanged and no gradient is
    recorded."""
    ws = (layer.w_gate, layer.w_up, layer.w_down)
    ep = len(devices)
    E = ws[0].shape[0]
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} model "
                         f"shards")
    keep = not (torch.is_grad_enabled() and any(w.requires_grad
                                                for w in ws))
    key = tuple((w.data_ptr(), w._version) for w in ws)
    cache = getattr(layer, "_placed", {})
    hit = cache.get(tuple(devices))
    if keep and hit is not None and hit[0] == key:
        return hit[1]
    e = E // ep
    placed = [tuple(w[j * e:(j + 1) * e].to(d) for w in ws)
              for j, d in enumerate(devices)]
    if keep:
        cache[tuple(devices)] = (key, placed)
        layer._placed = cache
    return placed


def _local_moe(layer, x, cfg: ArchConfig, devices) -> torch.Tensor:
    """One data shard's body: x (T_loc, d) bf16, its tokens, on
    devices[0]; the experts split over `devices` (its model shards)."""
    T, d = x.shape
    E = cfg.n_experts
    topi, w = _moe.route(layer, x, cfg)
    plan = _moe.dispatch(topi, E, _moe.capacity(T, cfg))
    cap = plan.cap
    # the local pack; row `cap` takes the dropped slots
    send = torch.zeros((E, cap + 1, d), dtype=x.dtype, device=x.device)
    send[plan.sorted_e, plan.safe_pos] = x[plan.tok_of]
    send = send[:, :cap]
    act = ACTS[cfg.act]
    experts = place_experts(layer, devices)
    e = E // len(devices)
    # out: each model shard's expert block to its device; its grouped
    # products there; back: the products to this data shard's device
    outs = [_moe._experts(send[j * e:(j + 1) * e].to(dev, non_blocking=True),
                          *experts[j], act)
            for j, dev in enumerate(devices)]
    back = torch.cat([y.to(x.device, non_blocking=True) for y in outs])
    backp = torch.cat([back, back.new_zeros((E, 1, d))], dim=1)
    y_slots = backp[plan.sorted_e, plan.safe_pos]
    y_slots = torch.where(plan.keep[:, None], y_slots,
                          torch.zeros((), dtype=y_slots.dtype,
                                      device=y_slots.device))
    return _moe.combine(w, y_slots, plan, T)


def moe_shard_apply(layer, x, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) bf16 -> (B, S, d), expert-parallel under the active
    mesh's `model` axis; without an active mesh that has one, the
    one-device dispatch (`nn.moe.moe_sorted_ep`). The B·S tokens must
    split evenly over the data shards (as `shard_map` requires); the
    output lies on x's device."""
    mesh = active_mesh()
    B, S, d = x.shape
    x2d = x.reshape(B * S, d).to(CDT)
    if mesh is None or "model" not in mesh.axis_names:
        return _moe.moe_sorted_ep(layer, x2d, cfg).reshape(B, S, d)
    groups = _groups(mesh)
    if groups[0, 0].type != x.device.type:
        raise ValueError(f"tokens on {x.device}, mesh on "
                         f"{groups[0, 0].type} devices")
    if (B * S) % len(groups):
        raise ValueError(f"{B * S} tokens do not split over "
                         f"{len(groups)} data shards")
    t = B * S // len(groups)
    outs = [_local_moe(layer, x2d[i * t:(i + 1) * t].to(devs[0],
                                                         non_blocking=True),
                       cfg, list(devs))
            for i, devs in enumerate(groups)]
    y = torch.cat([o.to(x.device, non_blocking=True) for o in outs])
    return y.reshape(B, S, d)
