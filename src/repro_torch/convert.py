"""Carry data across from the JAX package as plain numpy arrays.

In this system data takes the place of weights: a code's Tanner graph and
a tensor's stored cells. `code_from_arrays` rebuilds an `LDPCCode` from the
fields of the JAX package's `LDPCCode` (any mapping of numpy arrays and
ints, e.g. `{f: getattr(code, f) for f in CODE_FIELDS}`), and
`stored_from_arrays` wraps persisted cell levels as a `StoredTensor` on a
device, so both packages can run on the identical graph and cells.
`params_from_arrays` loads a model's weights from the JAX package's
`init_params` pytree (as numpy arrays, stacked over groups), with the
precoded PIM weights of its `encode_params_for_pim` where the tree has
them, so both packages can run the same model on the same integers, and `opt_state_from_arrays` carries an
optimizer state (AdamW's `m`/`v`/`step`, Adafactor's `f`/`step`/`m`)
across the same way, so both packages' optimizers start from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.construction import LDPCCode
from .device import resolve_device
from .memory.array import StoredTensor
from .models.lm import LM, jax_path
from .optim import stacked_leaf

CODE_FIELDS = ("p", "n", "k", "H", "G", "P", "cn_vns", "cn_coefs", "cn_mask",
               "perm_to_contrib", "perm_to_sym", "dv", "dc_max")
_INTS = ("p", "n", "k", "dv", "dc_max")
_DTYPES = {"H": np.int64, "G": np.int64, "P": np.int64, "cn_vns": np.int32,
           "cn_coefs": np.int32, "cn_mask": bool, "perm_to_contrib": np.int32,
           "perm_to_sym": np.int32}
# the projections whose precoded PIM weights a parameter tree may carry
PIM_LEAVES = (("mlp", "w_down"), ("attn", "wo"))


def code_from_arrays(d) -> LDPCCode:
    """A mapping with the `LDPCCode` fields -> the port's `LDPCCode`."""
    missing = [f for f in CODE_FIELDS if f not in d]
    if missing:
        raise KeyError(f"code arrays lack {missing}")
    kw = {f: int(d[f]) for f in _INTS}
    kw.update({f: np.array(d[f], dtype=dt) for f, dt in _DTYPES.items()})
    c = kw["n"] - kw["k"]
    if kw["H"].shape != (c, kw["n"]) or kw["P"].shape != (kw["k"], c):
        raise ValueError(f"H {kw['H'].shape} / P {kw['P'].shape} do not fit "
                         f"n={kw['n']}, k={kw['k']}")
    return LDPCCode(**kw)


def stored_from_arrays(enc, dtype, shape, nbytes: int,
                       device=None) -> StoredTensor:
    """(n_words, n) cell levels (numpy) and the tensor's dtype, shape and
    byte count -> a `StoredTensor` with int8 cells on `device` (the card by
    default)."""
    cells = torch.as_tensor(np.asarray(enc).astype(np.int8),
                            device=resolve_device(device))
    return StoredTensor(cells.contiguous(), np.dtype(dtype).name,
                        tuple(shape), int(nbytes))


def params_from_arrays(tree, cfg: ArchConfig, device=None) -> LM:
    """The JAX package's parameter pytree as numpy arrays
    (`jax.tree.map(np.asarray, params)`: "embed", "final_norm",
    "lm_head" unless tied, "groups"/"pos{i}" subtrees whose leaves are
    stacked over `n_groups` (MoE experts as (n_groups, E, d, f)), and for
    encoder-decoder configs "encoder" (stacked over `encoder_groups`) and
    "enc_norm") -> the port's `LM` on `device` (the card by
    default). Every parameter must be present with the model's shape. The
    precoded leaves of `repro.models.encode_params_for_pim` (`w_down_enc`,
    `w_down_alpha`, `wo_enc`, `wo_alpha`), where present, become the
    layers' PIM buffers (`LM.pim_leaves`)."""
    device = resolve_device(device)
    model = LM(cfg, device=device)
    with torch.no_grad():
        for name, param in model.named_parameters():
            path, g = jax_path(name, cfg)
            arr = np.asarray(_node(tree, path) if g is None
                             else _node(tree, path)[g])
            if arr.shape != tuple(param.shape):
                raise ValueError(f"{name}: array of shape {arr.shape}, "
                                 f"parameter {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    for idx, blk in enumerate(model.blocks):
        g, i = divmod(idx, len(cfg.group_spec))
        node = tree["groups"][f"pos{i}"]
        for sub, weight in PIM_LEAVES:
            leaf = node.get(sub, {})
            if f"{weight}_enc" not in leaf:
                continue
            enc = np.asarray(leaf[f"{weight}_enc"][g])
            if enc.dtype != np.int8:
                raise ValueError(f"{sub}/{weight}_enc: dtype {enc.dtype}, "
                                 "expected the precoded int8 cells")
            module = getattr(blk, sub)
            setattr(module, f"{weight}_enc",
                    torch.tensor(enc, device=device))
            setattr(module, f"{weight}_alpha", torch.tensor(
                np.float32(leaf[f"{weight}_alpha"][g]), device=device))
    return model


def _node(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _leaf_lists(tree, model: LM, device) -> dict[str, list[torch.Tensor]]:
    """A params-shaped JAX pytree of numpy arrays -> {leaf path: tensors},
    group leaves split into their per-layer slices (as `LM.leaves`)."""
    out = {}
    for path, params in model.leaves().items():
        arr = np.asarray(_node(tree, path.split("/")), dtype=np.float32)
        parts = list(arr) if stacked_leaf(path) else [arr]
        if len(parts) != len(params):
            raise ValueError(f"{path}: {len(parts)} arrays for "
                             f"{len(params)} parameters")
        out[path] = [torch.tensor(a, device=device) for a in parts]
    return out


def opt_state_from_arrays(state, model: LM, device=None) -> dict:
    """The JAX package's optimizer state as numpy arrays
    (`jax.tree.map(np.asarray, opt_state)`) -> the port's state for
    `model` (`optim.adamw` / `optim.adafactor`): moments per leaf as lists
    of per-layer tensors, Adafactor's factored `vr`/`vc` kept whole (they
    belong to the stacked leaf), `step` an int."""
    device = resolve_device(device)
    out = {"step": int(np.asarray(state["step"]))}
    for key in ("m", "v"):
        if key in state:
            out[key] = _leaf_lists(state[key], model, device)
    if "f" in state:
        out["f"] = {path: {k: torch.tensor(np.asarray(a, np.float32),
                                           device=device)
                           for k, a in _node(state["f"],
                                             path.split("/")).items()}
                    for path in model.leaves()}
    return out
