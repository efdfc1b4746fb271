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

- `use_rules(mesh, rules=None)` and `active_mesh`: the ambient mesh
  and its logical-axis rules (`RULES_SINGLE_POD` by default), whose mesh
  `nn.moe`'s `moe_impl="shard_ep"` reads, as in the JAX module.
- `RULES_SINGLE_POD`: the default logical-to-mesh axis table, which
  `launch.cells.rules_for_cell` starts from.
- `NamedSharding` and `named_sharding(mesh, rules, axes)`: a mesh and a
  spec (one entry a dimension: `None` whole, or the mesh axis, or tuple
  of axes, that splits it), as `jax.sharding.NamedSharding`.
- `Placed` and `place`: a tensor placed by a `NamedSharding`, each mesh
  position holding its slice (positions along axes the spec does not
  name hold the same slice), and `Placed.gather`, the whole tensor on
  one device (differentiable: the backward sends each slice's gradient
  back to its device). A dimension the named axes do not divide raises,
  as `jax.jit` with such `in_shardings` does. The data-parallel trainer
  (`launch.steps.build_train(mesh=...)`) keeps its parameters and
  optimizer states so.
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

Tensor parallelism (a `model` axis larger than 1) runs each data shard
on its model positions, one tensor a position:

- `Parts`: an activation of one data shard as one tensor per model
  position, in model order, each on its position's device, with the
  layout that makes the whole of them: "whole" (each holds all of it),
  "sum" (each a partial sum: a row-parallel product's, in float32), a
  dimension d (each holds its slice along d) or "own" (each position's
  own selection, such as the KV heads its query heads read). The
  parameters a layer
  reads are `Parts` too (`models.lm.ShardWeights`), each position's
  slice along `model`, gathered whole over `data`.
- `resolve_spec(axes)` and `constrain(x, *axes)`: as the JAX module's.
  `constrain` is the identity on a tensor (no rules, or a `model` axis
  of 1: the unsharded and data-parallel paths run as they were) and on
  `Parts` already laid out as the spec names; otherwise it is the one
  place where an activation's layout over `model` changes: a concat for
  an all-gather, a sum in model order (float32, rounded to the whole's
  dtype once) copied to every position for an all-reduce, a slice for a
  scatter. Their backwards are the adjoint collectives, summed in model
  order, so gradients repeat from run to run. `Parts` carry their
  rules, so a remat recomputation on an autograd thread resolves alike.

The multi-pod table, the sequence-sharded KV rules and the serving
cells' rules are read only by a tensor-parallel prefill and decode
(ROADMAP Queue 1, tensor-parallel serving), and come with them.
"""
from __future__ import annotations

import collections
import math
import threading
from contextlib import contextmanager

import numpy as np
import torch

from ..core.construction import LDPCCode
from ..core.decode import DecodeResult, decode_integers
from ..core.gf import symbol_dtype
from ..device import as_tensor, resolve_device
from ..kernels import build
from ..kernels.gf_matmul import scan_syndromes_routed

__all__ = ["Mesh", "RULES_SINGLE_POD", "use_rules", "active_mesh",
           "active_rules", "resolve_spec", "constrain", "Parts",
           "model_dim", "NamedSharding", "named_sharding", "Placed", "place",
           "place_zeros", "data_mesh",
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


# The default logical -> mesh axis table (the JAX module's single-pod
# one). `None` means "whole" (replicated); a value is one mesh axis or a
# tuple of them.
RULES_SINGLE_POD = {
    "batch": "data",
    "expert": "model",
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "d_inner": "model",
    "vocab": "model",
    "kv_seq": None,       # becomes "data" for long-context decode cells
    "seq": None,
    "d_model": None,
    "code_blocks": "model",
}


@contextmanager
def use_rules(mesh: Mesh | None, rules: dict | None = None):
    """Make `mesh` and its logical-axis `rules` (`RULES_SINGLE_POD` when
    None) the ambient ones for this thread; `None` clears them."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = None if mesh is None else (
        mesh, dict(RULES_SINGLE_POD) if rules is None else rules)
    try:
        yield
    finally:
        _CTX.state = prev


def active_mesh() -> Mesh | None:
    st = getattr(_CTX, "state", None)
    return st[0] if st else None


def active_rules() -> dict | None:
    st = getattr(_CTX, "state", None)
    return st[1] if st else None


def resolve_spec(axes, rules: dict | None = None) -> tuple:
    """Logical `axes` -> the spec (one entry a dimension) under `rules`,
    by default the active ones; () with none active (the JAX
    `resolve_spec`'s empty `PartitionSpec`)."""
    if rules is None:
        rules = active_rules()
        if rules is None:
            return ()
    return tuple(None if a is None else rules.get(a) for a in axes)


# ---------------------------------------------------------------------------
# shardings and placed tensors
# ---------------------------------------------------------------------------


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """`mesh` and `spec`, the port's `jax.sharding.NamedSharding`: entry d
    of `spec` splits dimension d of a tensor over a mesh axis (a name),
    over several (a tuple, the first the major one) or not at all
    (None); dimensions past the spec are whole. Mesh positions that differ
    only along axes the spec does not name hold the same slice."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh, self.spec = mesh, tuple(spec)
        named = [a for e in self.spec for a in _spec_axes(e)]
        unknown = [a for a in named if a not in mesh.axis_names]
        if unknown:
            raise ValueError(f"spec {self.spec} names {unknown}, not axes "
                             f"of the mesh {mesh.axis_names}")
        if len(set(named)) != len(named):
            raise ValueError(f"spec {self.spec} uses a mesh axis twice")

    def parts(self, ndim: int) -> tuple:
        """The number of slices each of `ndim` dimensions is cut into."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than the "
                             f"tensor's {ndim} dimensions")
        shape = self.mesh.shape
        return tuple(math.prod(shape[a] for a in _spec_axes(e))
                     for e in self.spec + (None,) * (ndim - len(self.spec)))

    def shard_shape(self, shape, name: str = "tensor") -> tuple:
        """The shape of each slice of a tensor of `shape`; a dimension the
        named axes do not divide raises (as `jax.jit` does)."""
        out = []
        for d, (n, k) in enumerate(zip(shape, self.parts(len(shape)),
                                       strict=True)):
            if n % k:
                raise ValueError(
                    f"{name}: dimension {d} of size {n} is not divisible by "
                    f"{k}, the size of mesh axes {_spec_axes(self.spec[d])} "
                    f"(full shape: {tuple(shape)})")
            out.append(n // k)
        return tuple(out)

    def index(self, pos: tuple, ndim: int) -> tuple:
        """The slice that mesh position `pos` holds: its index along each
        dimension."""
        names = self.mesh.axis_names
        sizes = self.mesh.devices.shape
        out = []
        for e in self.spec + (None,) * (ndim - len(self.spec)):
            i = 0
            for a in _spec_axes(e):
                k = names.index(a)
                i = i * sizes[k] + pos[k]
            out.append(i)
        return tuple(out)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, spec={self.spec})"


def named_sharding(mesh: Mesh, rules: dict, axes) -> NamedSharding:
    """Logical `axes` -> the sharding `rules` give them on `mesh`."""
    return NamedSharding(mesh, tuple(None if a is None else rules.get(a)
                                     for a in axes))


class Placed:
    """A tensor placed by a `NamedSharding`: `shape` is the whole
    tensor's, `local[pos]` the slice mesh position `pos` holds on that
    position's device. Positions holding the same slice on the same
    device share one tensor; a slice on several devices has a copy on
    each (a replica)."""

    def __init__(self, sharding: NamedSharding, shape, local: np.ndarray):
        self.sharding, self.shape, self.local = sharding, tuple(shape), local
        self._slices: dict | None = None

    @property
    def dtype(self) -> torch.dtype:
        return self.local.flat[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def positions(self):
        """(mesh position, its tensor) in mesh order."""
        for pos in np.ndindex(self.local.shape):
            yield pos, self.local[pos]

    def distinct(self) -> list:
        """Every tensor once, in mesh order (what an elementwise update
        writes)."""
        seen, out = set(), []
        for _pos, t in self.positions():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def slices(self) -> dict:
        """{slice index: its distinct copies in mesh order}, in slice
        order (worked out once: the positions' tensors never change)."""
        if self._slices is None:
            out: dict[tuple, list] = {}
            for pos, t in self.positions():
                copies = out.setdefault(self.sharding.index(pos, self.ndim),
                                        [])
                if all(c is not t for c in copies):
                    copies.append(t)
            self._slices = dict(sorted(out.items()))
        return self._slices

    def unique(self) -> list:
        """One copy of each slice (the first in mesh order), in slice
        order: what a reduction over the whole tensor reads."""
        return [copies[0] for copies in self.slices().values()]

    def map(self, fn) -> Placed:
        """`fn` of each distinct tensor, placed as this one (sharing kept)."""
        done: dict[int, torch.Tensor] = {}
        local = np.empty(self.local.shape, dtype=object)
        for pos, t in self.positions():
            if id(t) not in done:
                done[id(t)] = fn(t)
            local[pos] = done[id(t)]
        return Placed(self.sharding, self.shape, local)

    def gather(self, device, model: int | None = None) -> torch.Tensor:
        """The whole tensor on `device`: each slice from its copy there,
        else from its first copy, concatenated in mesh order. Autograd
        sends each slice's gradient back to the copy it was read from.
        With `model`, only model position `model`'s block of the
        dimension the `model` axis splits (whole along every other
        axis): a tensor-parallel position's weight, gathered over
        `data` only."""
        device = _device(device)
        parts = self.sharding.parts(self.ndim)
        slices = self.slices()
        md = None if model is None else model_dim(self.sharding, self.ndim)

        def pick(copies):
            for t in copies:
                if t.device == device:
                    return t
            return copies[0].to(device, non_blocking=True)

        def build(prefix):
            d = len(prefix)
            if d == self.ndim:
                return pick(slices[prefix])
            if d == md:
                return build(prefix + (model,))
            if parts[d] == 1:
                return build(prefix + (0,))
            return torch.cat([build(prefix + (i,)) for i in range(parts[d])],
                             dim=d)
        return build(())

    def numpy(self) -> np.ndarray:
        """The whole tensor as a numpy array (read slice by slice)."""
        with torch.no_grad():
            return self.gather("cpu").numpy()

    def __repr__(self) -> str:
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"{self.sharding!r})")


def _placed(shape, sharding: NamedSharding, name: str, make) -> Placed:
    """A `Placed` of `shape` whose slice `idx` on device `dev` is
    `make(idx, slice shape, dev)`, made once for each slice and device."""
    sub = sharding.shard_shape(shape, name)
    mesh = sharding.mesh
    made: dict[tuple, torch.Tensor] = {}
    local = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[pos]
        key = (sharding.index(pos, len(shape)), dev)
        if key not in made:
            made[key] = make(key[0], sub, dev)
        local[pos] = made[key]
    return Placed(sharding, shape, local)


def place(x, sharding: NamedSharding, *, name: str = "tensor",
          dtype=None) -> Placed:
    """A tensor or array placed by `sharding`: each mesh position gets its
    slice, copied onto its device (one copy for each slice and device).
    Raises where the named axes do not divide a dimension."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    dtype = x.dtype if dtype is None else dtype
    if x.device.type not in ("cpu", sharding.mesh.device.type):
        raise ValueError(f"{name} on {x.device}, mesh on "
                         f"{sharding.mesh.device.type} devices")

    def copy(idx, sub, dev):
        sl = tuple(slice(i * n, (i + 1) * n) for i, n in zip(idx, sub))
        return torch.empty(sub, dtype=dtype, device=dev).copy_(x[sl])
    return _placed(tuple(x.shape), sharding, name, copy)


def place_zeros(shape, sharding: NamedSharding, *, dtype=torch.float32,
                name: str = "tensor") -> Placed:
    """Zeros of `shape` placed by `sharding`, made slice by slice (the
    whole tensor never exists)."""
    return _placed(tuple(shape), sharding, name, lambda _idx, sub, dev:
                   torch.zeros(sub, dtype=dtype, device=dev))


def model_dim(sharding: NamedSharding, ndim: int) -> int | None:
    """The dimension the `model` axis splits under `sharding`, or None.
    Raises where `model` shares a dimension with another axis (no rule
    of `launch.cells.rules_for_cell` makes one)."""
    for d, e in enumerate(sharding.spec[:ndim]):
        axes = _spec_axes(e)
        if "model" in axes:
            if len(axes) > 1:
                raise ValueError(f"spec {sharding.spec}: `model` splits a "
                                 "dimension together with other axes")
            return d
    return None


# ---------------------------------------------------------------------------
# tensor parallelism: one tensor a model position, and `constrain`
# ---------------------------------------------------------------------------


class Parts:
    """One data shard's tensor under tensor parallelism: `parts[j]` on
    model position j's device (`positions[j]`, its mesh position), and
    `layout`, how they make the whole: "whole" (each holds it all),
    "sum" (each a partial sum; the whole is their sum rounded to
    `dtype`), a dimension d >= 0 (each holds its slice along d, in
    model order) or "own" (each what its position reads, e.g. the KV
    heads its query heads use: no whole). `rules` are the logical-axis
    rules `constrain` resolves by."""

    def __init__(self, parts, layout, *, positions, rules: dict,
                 dtype: torch.dtype | None = None):
        self.parts = list(parts)
        if isinstance(layout, int) and layout < 0:
            layout += self.parts[0].ndim
        self.layout, self.positions, self.rules = layout, positions, rules
        self.dtype = self.parts[0].dtype if dtype is None else dtype

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, j: int) -> torch.Tensor:
        return self.parts[j]

    def __iter__(self):
        return iter(self.parts)

    @property
    def devices(self) -> list:
        return [p.device for p in self.parts]

    def like(self, parts, layout=None, dtype=None) -> Parts:
        """`parts` at these positions, under these rules (this layout
        unless given)."""
        return Parts(parts, self.layout if layout is None else layout,
                     positions=self.positions, rules=self.rules, dtype=dtype)

    def map(self, fn, *others, layout=None, dtype=None) -> Parts:
        """fn(part j, other j...) at each position j in model order (its
        launches tagged with position j); `others` are `Parts` (their
        part j) or values given to every call."""
        out = []
        for j, p in enumerate(self.parts):
            args = [o[j] if isinstance(o, Parts) else o for o in others]
            with build.at_position(self.positions[j]):
                out.append(fn(p, *args))
        return self.like(out, layout, dtype)

    def __add__(self, other: Parts) -> Parts:
        if other.layout != self.layout or "sum" in (self.layout,
                                                     other.layout):
            raise ValueError(f"Parts of layouts {self.layout!r} and "
                             f"{other.layout!r} do not add")
        return self.map(torch.add, other)

    def to(self, dtype: torch.dtype) -> Parts:
        return self.map(lambda t: t.to(dtype), dtype=dtype)

    def __repr__(self) -> str:
        return (f"Parts({len(self)} x {tuple(self.parts[0].shape)}, "
                f"layout={self.layout!r}, {self.dtype})")


def _copies(t: torch.Tensor, devices) -> list:
    """`t` once a device of `devices`: itself first, a copy elsewhere."""
    return [t if j == 0 and d == t.device else t.to(d, copy=True)
            for j, d in enumerate(devices)]


class _AllReduce(torch.autograd.Function):
    """Partial sums -> their sum on every part's device: added in model
    order in float32 on the first part's device, rounded to `dtype`
    once, copied. The backward adds the copies' gradients alike and
    gives each part the total."""

    @staticmethod
    def forward(ctx, dtype, *parts):
        ctx.set_materialize_grads(False)
        ctx.devices = [p.device for p in parts]
        ctx.dtypes = [p.dtype for p in parts]
        first = ctx.devices[0]
        total = parts[0].to(torch.float32, copy=True)
        for p in parts[1:]:
            total += p.to(first, non_blocking=True).to(torch.float32)
        return tuple(_copies(total.to(dtype), ctx.devices))

    @staticmethod
    def backward(ctx, *grads):
        total = _sum_f32([g for g in grads if g is not None],
                         ctx.devices[0])
        if total is None:
            return (None,) * (1 + len(grads))
        return (None, *(total.to(d, dt, copy=True)
                        for d, dt in zip(ctx.devices, ctx.dtypes)))


def _sum_f32(grads, device):
    total = None
    for g in grads:
        g = g.to(device, non_blocking=True).to(torch.float32)
        total = g.clone() if total is None else total.add_(g)
    return total


class _AllGather(torch.autograd.Function):
    """Slices along `dim` -> the whole on every part's device (a concat
    in model order). The backward gives each slice the sum, in model
    order and float32, of its block of every copy's gradient."""

    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.set_materialize_grads(False)
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.dtypes = [p.dtype for p in parts]
        made: dict = {}
        outs = []
        for d in ctx.devices:
            if d in made:
                outs.append(made[d].clone())
            else:
                made[d] = torch.cat([p.to(d, non_blocking=True)
                                     for p in parts], dim)
                outs.append(made[d])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out, start = [None], 0
        for d, n, dt in zip(ctx.devices, ctx.sizes, ctx.dtypes):
            total = _sum_f32([g.narrow(ctx.dim, start, n) for g in grads
                              if g is not None], d)
            out.append(None if total is None else total.to(dt))
            start += n
        return tuple(out)


def _scatter(x: Parts, dim: int) -> Parts:
    """Whole -> each position's slice along `dim` (a view of its copy)."""
    n, M = x[0].shape[dim], len(x)
    if n % M:
        raise ValueError(f"dimension {dim} of size {n} does not split over "
                         f"{M} model positions")
    return x.like([t.narrow(dim, j * (n // M), n // M)
                   for j, t in enumerate(x)], dim)


def relayout(x: Parts, target) -> Parts:
    """`x` laid out as `target` ("whole" or a dimension), by the
    collectives `constrain` names."""
    if x.layout == target:
        return x
    if x.layout == "own":
        raise ValueError("Parts of layout 'own' (each position's own "
                         "selection) make no whole to lay out again")
    if x.layout == "sum":
        x = x.like(_AllReduce.apply(x.dtype, *x.parts), "whole", x.dtype)
        return x if target == "whole" else _scatter(x, target)
    if x.layout != "whole":
        x = x.like(_AllGather.apply(x.layout, *x.parts), "whole")
    return x if target == "whole" else _scatter(x, target)


def constrain(x, *axes):
    """The layout that logical `axes` give on the `model` axis (the JAX
    `with_sharding_constraint` by logical axes). The identity on a
    tensor (no active rules or a `model` axis of 1: nothing is split
    over `model`) and on `Parts` already so laid out; otherwise the
    collective that makes the layout (`relayout`)."""
    if not isinstance(x, Parts):
        return x
    target = "whole"
    for d, e in enumerate(resolve_spec(axes, x.rules)):
        if "model" in _spec_axes(e):
            target = d
    return relayout(x, target)


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
