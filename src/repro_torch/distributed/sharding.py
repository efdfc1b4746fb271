"""The device mesh, the ambient mesh and the sharded codec: the port
of the JAX package's `repro.distributed.sharding`.

The JAX package drives every device of a mesh from one process (`jax.jit`,
`shard_map`), and so does the port: a `Mesh` names axes over an array of
`torch.device`s, each shard's work is launched on its own device (on that
device's current stream), and the collectives are explicit
device-to-device copies (`Tensor.to(device, non_blocking=True)`, over
NVLink between cards). There are no `torch.distributed` process groups.

A mesh may name one device more than once. That is how the CPU tests run
2, 3 or 8 shards (the JAX tests force host devices for the same purpose)
and how one card runs a 4-shard mesh. `data_mesh()` and
`launch.mesh.make_host_mesh()` name each visible card once. A mesh that
mixes CPU and CUDA devices raises.

- `use_rules` and `active_mesh`: the ambient mesh, which
  `nn.moe`'s `moe_impl="shard_ep"` reads, as in the JAX module.
- `decode_sharded` and `scan_syndromes_sharded`: NB-LDPC decode and the
  syndrome scan are per-word independent, so the batch is cut into one
  row block per device of the `data` axis, each block decoded or scanned
  on its device, and the results gathered back; B is padded to a
  multiple of the shard count with all-zero words (valid codewords) and
  the pad stripped from every output. Decoding a word does not depend on
  the other words of its batch, so the results equal the unsharded ones
  bit for bit.
- `shard_page`: a page's rows [k·W/S, (k+1)·W/S) on mesh device k, the
  storage of `memory.paged.PagedProtectedStore(mesh=...)`.

The shards run one after the other from the host: each shard's decode
reads one byte back per early-exit iteration, so shards on different
cards do not overlap yet (ROADMAP Queue 2).

The logical-axis tables (`RULES_SINGLE_POD`, `RULES_MULTI_POD`,
`rules_for`), `resolve_spec`, `constrain` and `named_sharding` place the
dense layers' tensors by logical axis. Nothing of this slice reads them,
so they wait for the tensor-parallel slice (ROADMAP Queue 1), and
`use_rules` takes the mesh alone until then.
"""
from __future__ import annotations

import collections
import threading
from contextlib import contextmanager

import numpy as np
import torch

from ..core.construction import LDPCCode
from ..core.decode import DecodeResult, decode_integers
from ..core.gf import symbol_dtype
from ..device import as_tensor, resolve_device
from ..kernels.gf_matmul import scan_syndromes_routed

__all__ = ["Mesh", "use_rules", "active_mesh", "data_mesh",
           "axis_devices", "split_rows", "gather_rows", "shard_page",
           "decode_shards", "gather_decode", "decode_sharded",
           "scan_shards", "scan_syndromes_sharded"]

_CTX = threading.local()

def _device(d) -> torch.device:
    """`d` as a torch.device with its index: a bare "cuda" is the
    current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Named axes over an array of `torch.device`s, the port's
    `jax.sharding.Mesh`: `devices` holds one device per mesh position (a
    device may repeat), `axis_names` names its axes and `shape` maps each
    name to its size, in order."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} needs one distinct "
                             f"name per axis, got {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [_device(d) for d in arr.flat]
        kinds = {d.type for d in flat}
        if len(kinds) != 1:
            raise ValueError(f"mesh mixes device types {sorted(kinds)}: "
                             "every shard must run on one kind of device")
        if kinds - {"cpu", "cuda"}:
            raise ValueError(f"no mesh over {kinds.pop()!r} devices")
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = axis_names

    @property
    def shape(self) -> collections.OrderedDict:
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The mesh's first device: where sharded results are gathered."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"[{', '.join(str(d) for d in self.devices.flat)}])")


@contextmanager
def use_rules(mesh: Mesh | None):
    """Make `mesh` the ambient one for this thread; `None` clears it."""
    prev = getattr(_CTX, "mesh", None)
    _CTX.mesh = mesh
    try:
        yield
    finally:
        _CTX.mesh = prev


def active_mesh() -> Mesh | None:
    return getattr(_CTX, "mesh", None)


# ---------------------------------------------------------------------------
# the data mesh and row shards
# ---------------------------------------------------------------------------


def data_mesh(axis_name: str = "data", devices=None) -> Mesh:
    """1-D mesh over `devices`, by default every visible card once. With
    no CUDA and no `devices` it raises (the device rule)."""
    if devices is None:
        resolve_device(None)                  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(list(devices), (axis_name,))


def axis_devices(mesh: Mesh, axis_name: str = "data") -> list:
    """The devices along `axis_name`, at the first position of every
    other axis: one per shard of a batch split over that axis (the other
    axes' devices hold replicas in the JAX `shard_map`)."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no "
                         f"{axis_name!r} axis")
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index(axis_name), 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def _same_kind(t: torch.Tensor, devices) -> None:
    kind = devices[0].type
    if t.device.type != kind:
        raise ValueError(f"tensor on {t.device}, mesh on {kind} devices: "
                         "nothing moves between the CPU and the card")


def split_rows(y: torch.Tensor, devices) -> list:
    """(B, ...) -> one block of ceil(B / S) rows per device, block k on
    `devices[k]`, the last blocks padded with zero rows."""
    _same_kind(y, devices)
    S, B = len(devices), y.shape[0]
    per = -(-B // S)
    parts = []
    for k, dev in enumerate(devices):
        part = y[k * per:(k + 1) * per]
        if part.shape[0] < per:
            part = torch.cat([part, part.new_zeros(
                (per - part.shape[0],) + tuple(y.shape[1:]))])
        parts.append(part.to(dev, non_blocking=True))
    return parts


def gather_rows(parts, device) -> torch.Tensor:
    """Row blocks on their devices -> one tensor on `device`."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def shard_page(page: torch.Tensor, mesh: Mesh,
               axis_name: str = "data") -> tuple:
    """A (page_words, n) page as row shards: rows [k·W/S, (k+1)·W/S) on
    device k of the `axis_name` axis. The caller keeps W a multiple of S
    (`PagedProtectedStore` checks it), so nothing is padded."""
    devices = axis_devices(mesh, axis_name)
    if page.shape[0] % len(devices):
        raise ValueError(f"page of {page.shape[0]} rows over "
                         f"{len(devices)} shards")
    return tuple(split_rows(page, devices))


# ---------------------------------------------------------------------------
# the sharded decode and scan
# ---------------------------------------------------------------------------


def decode_shards(code: LDPCCode, parts, **kw) -> list:
    """`decode_integers` of each row block on its own device (the
    estimator is not fed, as the JAX `shard_map` body feeds it nothing).
    Returns one `(y_corrected, DecodeResult)` per block."""
    return [decode_integers(code, part, observe=False, **kw)
            for part in parts]


def gather_decode(outs, device, rows: int | None = None):
    """Per-block `(y_corrected, DecodeResult)`s -> one pair on `device`,
    cut to the first `rows` rows."""
    def cat(ts):
        return gather_rows(ts, device)[:rows]
    y = cat([o[0] for o in outs])
    res = DecodeResult(*(cat([o[1][f] for o in outs])
                         for f in range(len(DecodeResult._fields))))
    return y, res


def decode_sharded(code: LDPCCode, y, *, mesh: Mesh | None = None,
                   axis_name: str = "data", n_iters: int = 10,
                   llv_scale: float = 4.0, llv_mode: str = "manhattan",
                   early_exit: bool = False, damping: float = 0.0):
    """Shard batched integer decode across the devices of `axis_name`
    (every visible card by default) along the batch axis.

    y: (B, n) received integer words, a tensor (results on its device) or
    an array (results on the mesh's first device). B is padded to a
    multiple of the shard count with all-zero words and the pad is
    stripped from every output. Returns (y_corrected (B, n),
    DecodeResult) exactly like `core.decode.decode_integers`."""
    mesh = data_mesh(axis_name) if mesh is None else mesh
    devices = axis_devices(mesh, axis_name)
    y = as_tensor(y, devices[0])
    parts = split_rows(y, devices)
    outs = decode_shards(code, parts, n_iters=n_iters, llv_scale=llv_scale,
                         llv_mode=llv_mode, early_exit=early_exit,
                         damping=damping)
    return gather_decode(outs, y.device, y.shape[0])


def scan_shards(code: LDPCCode, parts) -> list:
    """The fused syndrome scan of each row block on its own device (one
    scan launch a block on the card): per-block (rows,) bool flags."""
    dtype = symbol_dtype(code.p)
    return [scan_syndromes_routed(part, code.tensor("H.T", part.device,
                                                    dtype), code.p)
            for part in parts]


def scan_syndromes_sharded(code: LDPCCode, y, *, mesh: Mesh | None = None,
                           axis_name: str = "data") -> torch.Tensor:
    """Fan the fused syndrome scan across the devices of `axis_name` along
    the batch axis: y (B, n) stored level-words -> (B,) bool flags, on
    y's device (the mesh's first device for an array). B is padded to a
    shard-count multiple with all-zero words (never flagged) and the pad
    stripped. Raises past the int32 bound n·(p−1)² < 2^31."""
    # the fused scan accumulates int32 on every shard: each word's
    # syndrome sums are bounded by n·(p−1)² (the controller sends larger
    # codes to its exact scan)
    if code.n * (code.p - 1) ** 2 >= 2 ** 31:
        raise ValueError(
            f"scan_syndromes_sharded int32 bound exceeded: {code.n} * "
            f"({code.p}-1)^2 >= 2^31 — use the exact host scan")
    mesh = data_mesh(axis_name) if mesh is None else mesh
    devices = axis_devices(mesh, axis_name)
    y = as_tensor(y, devices[0])
    flags = scan_shards(code, split_rows(y, devices))
    return gather_rows(flags, y.device)[:y.shape[0]]
