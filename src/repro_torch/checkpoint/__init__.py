"""Fault-tolerant checkpointing: the port's counterpart of the JAX
package's `repro.checkpoint`, in the same on-disk format.

- **atomic**: write to `<dir>/tmp.<step>.<pid>/`, fsync the manifest, then
  `rename()` to `step_<N>/`; a crash mid-write never corrupts the latest
  checkpoint;
- **per leaf**: a tree (nested dicts and lists of tensors, numpy arrays
  and numbers) is flattened to "/"-joined paths, one `.npy` per leaf;
- **self-describing**: `manifest.json` records the step, caller extras
  (the data-pipeline state), and a payload checksum;
- **NB-LDPC-protected payloads** (the paper's memory mode), `protect=True`:
  each leaf's bytes are written through the port's
  `memory.ProtectedMemoryArray` on wl1024_r08 (base-p symbolization and
  the systematic encode, the gf_matmul kernel on the card) and scanned and
  corrected on load (the scan and FBP kernels). Storage faults are
  injected with `inject_storage_faults` through the `memory.channel`
  models, never by editing the `.prot.npz` files.

A placed leaf (`distributed.sharding.Placed`, a data-parallel run's) is
saved whole, gathered one leaf at a time, so a checkpoint holds full
arrays whatever mesh wrote it, as the JAX package's do. Restored leaves
take the template leaf's kind (a tensor leaf comes back as a tensor on
that tensor's device, anything else as a numpy array), or with
`shardings=` are placed by them onto a mesh: the elastic restore, onto
any mesh the arrays divide. The protected array lives on `device` (the
card unless the caller asks for the CPU).
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from ..core.codes import REGISTRY
from ..device import resolve_device
from ..distributed.sharding import NamedSharding, Placed, place
from ..memory import Channel, ProtectedMemoryArray, StoredTensor

_PROT_CODE = "wl1024_r08"
_PROT_VERSION = 2          # the JAX package's protected-payload format


def _items(node):
    if isinstance(node, dict):
        return [(str(k), v) for k, v in sorted(node.items())]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Placed):
        return leaf.numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sharding_at(shardings, key):
    """The shardings under `key`: a `NamedSharding` (or None) covers its
    whole subtree."""
    if shardings is None or isinstance(shardings, NamedSharding):
        return shardings
    return shardings[key] if isinstance(shardings, dict) else \
        shardings[int(key)]


def _unflatten_into(template, flat: dict[str, np.ndarray], prefix="",
                    shardings=None):
    items = _items(template)
    if items is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        arr = flat[prefix]
        if shardings is not None:
            return place(arr, shardings, name=prefix)
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(arr, device=template.device)
        return arr
    subs = {key: _unflatten_into(sub, flat,
                                 f"{prefix}/{key}" if prefix else key,
                                 _sharding_at(shardings, key))
            for key, sub in items}
    if isinstance(template, dict):
        return {k: subs[str(k)] for k in template}
    return type(template)(subs[str(i)] for i in range(len(template)))


def _hash_leaf(h, key: str, arr: np.ndarray) -> None:
    h.update(key.encode())
    h.update(np.ascontiguousarray(arr).tobytes())


def _checksum(arrs: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrs):
        _hash_leaf(h, k, arrs[k])
    return h.hexdigest()[:16]


def _protected_memory(code: str, device) -> ProtectedMemoryArray:
    return ProtectedMemoryArray(code, controller="basic", n_iters=10,
                                damping=0.3, device=device)


def _stored_to_npz(st: StoredTensor) -> dict[str, np.ndarray]:
    return {"enc": st.enc.cpu().numpy(), "nbytes": np.asarray([st.nbytes]),
            "dtype": str(st.dtype), "shape": np.asarray(st.shape, np.int64)}


def _npz_to_stored(z) -> StoredTensor:
    return StoredTensor(torch.as_tensor(np.asarray(z["enc"])),
                        str(z["dtype"]), tuple(int(s) for s in z["shape"]),
                        int(z["nbytes"][0]))


def _leaf_generator(key: int, i: int, device) -> torch.Generator:
    seed = int(np.random.SeedSequence([key, i]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def inject_storage_faults(directory: str, channel: Channel, *,
                          key: int = 0, step: int | None = None,
                          t: float = 0.0, n_reads: int = 0,
                          device=None) -> int:
    """Corrupt a protected checkpoint's stored codewords in place through a
    `memory.channel` model, leaf i drawn from a generator seeded by
    (key, i) on `device`. Returns the number of cells changed."""
    p = REGISTRY[_PROT_CODE][2]
    if channel.p != p:
        raise ValueError(f"channel alphabet {channel.p} != GF({p})")
    device = resolve_device(device)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    changed = 0
    for i, fn in enumerate(sorted(glob.glob(os.path.join(d, "*.prot.npz")))):
        z = dict(np.load(fn, allow_pickle=False))
        enc = torch.as_tensor(np.asarray(z["enc"]), device=device)
        new = channel.apply(_leaf_generator(key, i, device), enc, t=t,
                            n_reads=n_reads).to(enc.dtype)
        changed += int((new != enc).sum())
        z["enc"] = new.cpu().numpy()
        with open(fn, "wb") as f:
            np.savez(f, **z)
    return changed


# -- public API --------------------------------------------------------------


def save_checkpoint(directory: str, step: int, tree, *, extra: dict | None
                    = None, protect: bool = False, keep: int = 3,
                    device=None) -> str:
    """Atomically persist `tree` (params, optimizer state, ...) at `step`;
    keep the newest `keep` checkpoints. Each leaf is read to the host
    (gathered whole, if placed) one at a time. With `protect`, the leaves
    are encoded on `device`."""
    os.makedirs(directory, exist_ok=True)
    leaves = _flatten(tree)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)

    mem = _protected_memory(_PROT_CODE, resolve_device(device)) \
        if protect else None
    h = hashlib.sha256()
    for k in sorted(leaves):
        arr = _to_numpy(leaves[k])
        _hash_leaf(h, k, arr)
        fn = os.path.join(tmp, k.replace("/", "__") + ".npy")
        if protect:
            st = mem.write(k, arr)
            np.savez(fn + ".prot.npz", **_stored_to_npz(st))
            mem.discard(k)           # one leaf resident at a time
        else:
            np.save(fn, arr)

    manifest = {
        "step": step,
        "time": time.time(),
        "checksum": h.hexdigest()[:16],
        "protected": protect,
        "prot_version": _PROT_VERSION if protect else None,
        "prot_code": _PROT_CODE if protect else None,
        "extra": extra or {},
        "leaves": sorted(leaves),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish

    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, old))
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template, *, step: int | None = None,
                       shardings=None, correct: bool = True, device=None):
    """Restore into `template`'s structure (the newest step by default).
    `shardings`: a tree of `NamedSharding`s that is a prefix of the
    template's (a sharding places every leaf under it; None leaves a
    subtree to the template's kinds), each leaf placed onto its mesh (the
    elastic restore). A protected checkpoint is scanned and corrected on
    `device`. Returns (tree, manifest); the manifest of a protected one
    carries the decoder's `correction_stats`."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    mem = None
    if manifest["protected"]:
        if manifest.get("prot_version") != _PROT_VERSION:
            raise OSError(
                f"checkpoint {d} uses protected-payload format "
                f"{manifest.get('prot_version')}; this build reads "
                f"version {_PROT_VERSION}")
        mem = _protected_memory(manifest.get("prot_code", _PROT_CODE),
                                resolve_device(device))

    flat = {}
    for key in manifest["leaves"]:
        fn = os.path.join(d, key.replace("/", "__") + ".npy")
        if mem is not None:
            z = np.load(fn + ".prot.npz")
            mem.import_stored(key, _npz_to_stored(z))
            flat[key] = mem.read(key, correct=correct)
            mem.discard(key)         # one leaf resident at a time
        else:
            flat[key] = np.load(fn)

    if mem is not None:
        manifest["correction_stats"] = mem.stats.as_dict()
    if _checksum(flat) != manifest["checksum"]:
        if not manifest["protected"]:
            raise OSError(f"checkpoint {d} failed checksum verification")
        if correct:
            raise OSError(f"checkpoint {d} failed post-correction checksum "
                          "(storage errors exceeded the code's strength)")
    return _unflatten_into(template, flat, shardings=shardings), manifest
