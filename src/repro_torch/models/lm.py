"""Config-driven model stacks: parameters, training pass, prefill and
decode, for every architecture of `configs.ARCH_IDS`.

The stack is `n_groups` repetitions of `cfg.group_spec`, as in the JAX
package's `repro.models.lm`; here it is a `ModuleList` of `Block`s run in
a Python loop (block `g * len(group_spec) + i` is group g, position i).
A layer is global or sliding-window self-attention, cross-attention
(llama-3.2-vision, over `aux` embeddings), mamba (falcon-mamba, jamba)
or encoder-decoder (the whisper decoder: self, cross, MLP); its FFN is a
gated MLP, an MoE (olmoe, jamba), both (arctic) or none. Encoder-decoder
configs run a bidirectional encoder stack (`encoder`, `enc_norm`,
`cfg.encoder_groups` layers) over the precomputed frame embeddings
`aux` first, and the decoder cross-attends its output.

PIM protection (the paper's technique) plugs in through `pim_ctx`, a
`core.context.PIMContext`: every block's `mlp_down` and `attn_o`
projections that its targets name run on the protected PIM path, in
`forward` and `loss_fn` (the training pass too), `prefill` and
`decode_step` (the MoE experts and the encoder are not protected, as in
the JAX package). The backward through a protected projection is the
JAX package's own gradient: it flows through the activation and ternary
scales only (`PIMContext.matmul`). `encode_params_for_pim` precodes
those weights once, as the JAX package's deploy-time transform does; a
precoded projection never reads its float weight, whose gradient stays
None (the JAX package gives zeros), and its `*_alpha` buffer gets none.

Entry points: `init_params` / `forward` / `loss_fn` / `init_caches` /
`prefill` / `decode_step`. `forward` and `loss_fn` are the training pass:
under `cfg.remat` (with grad enabled) each group, and each encoder layer,
runs under `torch.utils.checkpoint`, the counterpart of the JAX package's
`jax.checkpoint` over the group body: remat_policy "full" saves nothing,
"dots" saves the outputs of the un-batched products (`aten.mm`, what
`x @ W` lowers to) and recomputes the rest
(`dots_with_no_batch_dims_saveable`). `pim_ctx` reaches every
recomputed group; a recomputation draws a faulted context's faults
again (each call seeds its own generator) and is left out of its
`stats()`, which count each forward call once.
`prefill(..., protected_kv=ProtectedKVConfig(...))` returns a
`ProtectedKVCaches` manager whose global-attention K/V live in NB-LDPC
protected paged stores (mamba states, cross K/V and sliding-window rings
stay dense there); `decode_step` serves through it (or through the dense
caches of `init_caches`, which it updates in place). Both run on the
parameters' device; `init_params` puts them on the card unless asked for
the CPU. `attn_impl="standin"` (the JAX package's cost-lowering tooling)
is not ported, by design.

Over a mesh (`launch.steps.build_prefill` / `build_serve`) the
parameters are a `PlacedLM` placed by `param_axes` (and
`pim_param_axes`: the precoded `*_enc` weights split by rows with `wo`
and `w_down`, their scales whole), the dense caches `Placed` by
`cache_axes` (`init_caches(..., mesh=...)`), and `prefill` /
`decode_step` run one data shard at a time with its `ShardWeights`,
over its model positions (`Parts`) where `model` > 1. Under context
parallelism (`long_500k`: the batch whole, the KV sequence over `data`,
`pod` and maybe `model`) each data shard is a replica but for its block
of the caches' rows; the mamba states and cross K/V are replicated.
"""
from __future__ import annotations

import functools
from contextlib import contextmanager, nullcontext

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig, LayerSpec
from ..device import resolve_device
from ..distributed.sharding import (Parts, Placed, constrain, model_dim,
                                    named_sharding, place, place_zeros,
                                    shard_positions, sync_replicas)
from ..kernels import build
from ..nn.layers import CDT, Block, RMSNorm, _param
from ..nn.mamba import mamba_param_axes

__all__ = ["LM", "init_params", "param_axes", "pim_param_axes",
           "param_shardings", "PlacedLM", "place_params", "forward",
           "loss_fn", "cache_axes", "cache_shardings", "init_caches",
           "prefill", "decode_step", "encode_params_for_pim"]

# the encoder's layers: bidirectional attention is chosen at apply time
_ENC_SPEC = LayerSpec(kind="attn")


class LM(nn.Module):
    """The model's parameters: `embed` (V, d), `final_norm`, `lm_head`
    (d, V) unless the embeddings are tied, one `Block` per layer, and for
    encoder-decoder configs the `encoder` blocks and `enc_norm`."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), generator, device)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), generator,
                                  device)
        self.blocks = nn.ModuleList(
            Block(spec, cfg, generator=generator, device=device)
            for _ in range(cfg.n_groups) for spec in cfg.group_spec)
        if cfg.encoder_groups > 0:
            self.encoder = nn.ModuleList(
                Block(_ENC_SPEC, cfg, generator=generator, device=device)
                for _ in range(cfg.encoder_groups))
            self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)

    def block(self, g: int, i: int) -> Block:
        return self.blocks[g * len(self.cfg.group_spec) + i]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def leaves(self) -> dict[str, list[nn.Parameter]]:
        """The parameters as the JAX package's pytree leaves, keyed by path
        ("embed", "final_norm/scale", "groups/pos0/attn/wq",
        "encoder/attn/wq", ...) in that tree's leaf order: a group or
        encoder leaf lists its per-layer tensors (the JAX leaf stacks
        them), any other leaf one tensor."""
        out: dict[str, list[nn.Parameter]] = {}
        for name, param in self.named_parameters():
            path, _g = jax_path(name, self.cfg)
            out.setdefault("/".join(path), []).append(param)
        return dict(sorted(out.items()))

    def pim_leaves(self) -> dict[str, list[torch.Tensor]]:
        """The precoded PIM weights of `encode_params_for_pim` (or carried
        across by `convert.params_from_arrays`), keyed like `leaves`:
        "groups/pos0/mlp/w_down_enc" lists its per-layer int8 tensors (the
        JAX leaf stacks them over the group). Empty before precoding."""
        out: dict[str, list[torch.Tensor]] = {}
        for name, buf in self.named_buffers():
            path, _g = jax_path(name, self.cfg)
            out.setdefault("/".join(path), []).append(buf)
        return dict(sorted(out.items()))


def jax_path(name: str, cfg: ArchConfig) -> tuple[tuple[str, ...],
                                                  int | None]:
    """A parameter name of `LM` -> (its path in the JAX package's pytree,
    its layer index in the stacked leaf, or None): "blocks.3.attn.wq"
    with a 2-layer group is (("groups", "pos1", "attn", "wq"), 1);
    "encoder.2.mlp.w_up" is (("encoder", "mlp", "w_up"), 2)."""
    path = name.split(".")
    if path[0] == "encoder":
        return ("encoder", *path[2:]), int(path[1])
    if path[0] != "blocks":
        return tuple(path), None
    g, i = divmod(int(path[1]), len(cfg.group_spec))
    return ("groups", f"pos{i}", *path[2:]), g


def init_params(cfg: ArchConfig, generator: torch.Generator | int = 0, *,
                device=None) -> LM:
    """A model with N(0, 0.02²) float32 weights, unit norm scales and the
    mamba layers' fixed init, the JAX package's distributions (not its
    bits). `generator` is a `torch.Generator` (the model goes on its
    device unless `device` says otherwise) or a seed for one on `device`
    (the card by default)."""
    if isinstance(generator, torch.Generator):
        device = torch.device(device) if device is not None \
            else generator.device
    else:
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(int(generator))
    return LM(cfg, generator=generator, device=device)


def _block_axes(spec: LayerSpec, cfg: ArchConfig) -> dict:
    """Logical sharding axes of one layer's leaves (the JAX package's
    `_block_axes`), as a tree of its subtree names."""
    norm = {"scale": (None,)}
    attn = {"wq": ("fsdp", "heads_flat"), "wk": ("fsdp", "kv_flat"),
            "wv": ("fsdp", "kv_flat"), "wo": ("heads_flat", "fsdp")}
    mlp = {"w_gate": ("fsdp", "d_ff"), "w_up": ("fsdp", "d_ff"),
           "w_down": ("d_ff", "fsdp")}
    a: dict = {"norm1": norm}
    if spec.kind == "mamba":
        a["mamba"] = {k: tuple("fsdp" if ax == "d_model" else ax for ax in v)
                      for k, v in mamba_param_axes().items()}
    elif spec.kind == "encdec":
        a.update(attn=attn, norm_x=norm, xattn=attn)
    else:
        a["attn"] = attn
    has_ffn = spec.moe or cfg.d_ff > 0
    if spec.kind == "mamba" and cfg.d_ff == 0 and not spec.moe:
        has_ffn = False
    if has_ffn:
        a["norm2"] = norm
        if spec.moe:
            a["moe"] = {"router": ("fsdp", None),
                        "w_gate": ("expert", "fsdp", None),
                        "w_up": ("expert", "fsdp", None),
                        "w_down": ("expert", None, "fsdp")}
            if spec.dense_residual:
                a["mlp"] = mlp
        else:
            a["mlp"] = mlp
    if spec.kind == "encdec":
        a.update(norm2=norm, mlp=mlp)
    return a


def _flat(tree: dict, prefix: str, lead: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path, lead) if isinstance(v, dict)
                   else {path: lead + v})
    return out


def param_axes(cfg: ArchConfig) -> dict[str, tuple]:
    """Logical sharding axes of every leaf, keyed like `LM.leaves()` (the
    JAX package's `param_axes`, flattened to its paths): a group or
    encoder leaf's axes start with None, the stacking axis; each of its
    per-layer tensors takes the rest."""
    axes = {"embed": ("vocab", "fsdp"), "final_norm/scale": (None,)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("fsdp", "vocab")
    for i, spec in enumerate(cfg.group_spec):
        axes.update(_flat(_block_axes(spec, cfg), f"groups/pos{i}",
                          (None,)))
    if cfg.encoder_groups > 0:
        axes.update(_flat(_block_axes(_ENC_SPEC, cfg), "encoder", (None,)))
        axes["enc_norm/scale"] = (None,)
    return dict(sorted(axes.items()))


def layer_axes(path: str, axes: tuple) -> tuple:
    """The axes of each tensor of a leaf: a stacked leaf's less its
    stacking axis."""
    return axes[1:] if path.startswith(("groups/", "encoder/")) else axes


def pim_param_axes(axes: dict, cfg: ArchConfig) -> dict:
    """`axes` (`param_axes`) with the precoded leaves of
    `encode_params_for_pim` (the JAX package's `pim_param_axes`): each
    `w_down_enc` split by rows as `w_down` (`d_ff`), each `wo_enc` as
    `wo` (`heads_flat`), their columns whole (the check columns ride in
    each codeword block), and the `*_alpha` scales whole."""
    targets = set(cfg.pim.targets)
    axes = dict(axes)
    for i, spec in enumerate(cfg.group_spec):
        block = _block_axes(spec, cfg)
        pre = f"groups/pos{i}"
        if "mlp" in block and "mlp_down" in targets:
            axes[f"{pre}/mlp/w_down_enc"] = (None, "d_ff", None)
            axes[f"{pre}/mlp/w_down_alpha"] = (None,)
        if "attn" in block and "attn_o" in targets:
            axes[f"{pre}/attn/wo_enc"] = (None, "heads_flat", None)
            axes[f"{pre}/attn/wo_alpha"] = (None,)
    return dict(sorted(axes.items()))


def param_shardings(cfg: ArchConfig, mesh, rules: dict,
                    axes: dict | None = None) -> dict:
    """{leaf path: one `NamedSharding` per tensor of the leaf} under
    `rules` on `mesh`, keyed and listed like `LM.leaves()` (and like
    `LM.pim_leaves()` for the leaves of `pim_param_axes`), of `axes`
    (`param_axes(cfg)` by default)."""
    counts = {"groups": cfg.n_groups, "encoder": cfg.encoder_groups}
    axes = param_axes(cfg) if axes is None else axes
    return {path: [named_sharding(mesh, rules, layer_axes(path, ax))]
            * counts.get(path.split("/")[0], 1)
            for path, ax in axes.items()}


class PlacedLM:
    """An LM's parameters placed on a mesh (FSDP): `placed` maps each
    parameter name of `LM` to its `Placed` tensor, whose slices are
    leaves that gather gradients; `buffers` the precoded PIM weights'
    (`encode_params_for_pim`'s `*_enc` and `*_alpha`), where placed;
    `skeleton` is the `LM` on the meta device, the structure `forward`
    runs."""

    def __init__(self, cfg: ArchConfig, placed: dict[str, Placed],
                 buffers: dict[str, Placed] | None = None):
        self.cfg = cfg
        self.skeleton = LM(cfg, device="meta")
        names = [n for n, _ in self.skeleton.named_parameters()]
        if sorted(names) != sorted(placed):
            raise ValueError("placed parameters do not match the model's: "
                             f"{sorted(set(names) ^ set(placed))}")
        self.placed = {n: placed[n] for n in names}
        unknown = [n for n in sorted(buffers or {}) if n.rpartition(".")[2]
                   not in self.skeleton.get_submodule(
                       n.rpartition(".")[0])._buffers]
        if unknown:
            raise ValueError(f"placed buffers the model has no slot for: "
                             f"{unknown}")
        self.buffers = dict(sorted((buffers or {}).items()))
        for t in self.distinct():
            t.requires_grad_(True)

    @property
    def mesh(self):
        return next(iter(self.placed.values())).sharding.mesh

    def leaves(self) -> dict[str, list[Placed]]:
        """The placed parameters keyed and listed like `LM.leaves()`."""
        out: dict[str, list[Placed]] = {}
        for name, p in self.placed.items():
            path, _g = jax_path(name, self.cfg)
            out.setdefault("/".join(path), []).append(p)
        return dict(sorted(out.items()))

    def distinct(self) -> list[torch.Tensor]:
        """Every slice tensor once."""
        return [t for p in self.placed.values() for t in p.distinct()]

    def zero_grad(self) -> None:
        for t in self.distinct():
            t.grad = None

    def weights(self, device, *, shard: int | None = None,
                rules: dict | None = None,
                skeleton: LM | None = None) -> ShardWeights:
        """The weights of the data shard on `device`, or with `shard` (and
        the step's `rules`), of data shard `shard`'s model positions
        (tensor parallelism), swapped into `skeleton` (this model's by
        default)."""
        return ShardWeights(self, device, shard=shard, rules=rules,
                            skeleton=skeleton)

    def skeleton_of(self, k: int) -> LM:
        """A skeleton of its own for data shard k (the first is
        `skeleton`): shards run in threads swap their weights into
        separate modules."""
        if k == 0:
            return self.skeleton
        extra = self.__dict__.setdefault("_skeletons", {})
        if k not in extra:
            extra[k] = LM(self.cfg, device="meta")
        return extra[k]

    @torch.no_grad()
    def gather(self, device) -> LM:
        """The whole model on `device` (a copy)."""
        model = LM(self.cfg, device=device)
        for name, param in model.named_parameters():
            param.copy_(self.placed[name].gather(device))
        return model


def place_params(model: LM, shardings: dict) -> PlacedLM:
    """`model`'s parameters placed by `shardings` (`param_shardings`),
    and its precoded PIM weights where `shardings` has their leaves
    (`pim_param_axes`). Precode the whole model first
    (`encode_params_for_pim`): the ternary threshold and scale are each
    weight's whole mean, so slices encoded alone would differ."""
    placed, buffers = {}, {}
    for out, named in ((placed, model.named_parameters()),
                       (buffers, model.named_buffers())):
        for name, t in named:
            path, g = jax_path(name, model.cfg)
            key = "/".join(path)
            if out is buffers and key not in shardings:
                continue
            out[name] = place(t.detach(), shardings[key][g or 0], name=name)
    return PlacedLM(model.cfg, placed, buffers)


class ShardWeights:
    """One data shard's view of a `PlacedLM`: inside `use(*names)` the
    skeleton's parameters (and placed PIM buffers) under those module or
    parameter names are the placed ones gathered whole onto `device`; with `shard` (tensor
    parallelism), `Parts` of data shard `shard`'s model positions: each
    position's slice along `model` gathered whole over `data` onto its
    device (layout the dimension `model` splits, or "whole"; a whole
    leaf gathered once a device), under the step's `rules`. The swap
    is made in `skeleton` (the model's own by default)."""

    def __init__(self, model: PlacedLM, device=None, *,
                 shard: int | None = None, rules: dict | None = None,
                 skeleton: LM | None = None):
        self.model, self.rules = model, rules
        self.skeleton = model.skeleton if skeleton is None else skeleton
        self.device = None if device is None else torch.device(device)
        self.positions = (None if shard is None
                          else shard_positions(model.mesh)[shard])
        self._under: dict[str, list[str]] = {}

    def _local(self, name: str):
        placed = self.model.placed.get(name) or self.model.buffers[name]
        if self.positions is None:
            return placed.gather(self.device)
        md = model_dim(placed.sharding, placed.ndim)
        made: dict = {}
        parts = []
        for j, pos in enumerate(self.positions):
            dev = self.model.mesh.devices[pos]
            key = (dev, None if md is None else j)
            if key not in made:
                made[key] = placed.gather(dev, None if md is None else j)
            parts.append(made[key])
        return Parts(parts, "whole" if md is None else md,
                     positions=self.positions, rules=self.rules)

    def _names(self, prefix: str) -> list[str]:
        if prefix not in self._under:
            self._under[prefix] = [n for n in (*self.model.placed,
                                               *self.model.buffers)
                                   if n == prefix or
                                   n.startswith(prefix + ".")]
        return self._under[prefix]

    @contextmanager
    def use(self, *prefixes):
        swapped = []
        try:
            for prefix in prefixes:
                for name in self._names(prefix):
                    mod_name, _, leaf = name.rpartition(".")
                    mod = self.skeleton.get_submodule(mod_name)
                    slots = (mod._parameters if leaf in mod._parameters
                             else mod._buffers)
                    swapped.append((slots, leaf, slots[leaf]))
                    slots[leaf] = self._local(name)
            yield
        finally:
            for slots, leaf, p in reversed(swapped):
                slots[leaf] = p


def _using(weights: ShardWeights | None, *prefixes):
    return nullcontext() if weights is None else weights.use(*prefixes)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _embed(params: LM, cfg: ArchConfig, tokens):
    if isinstance(params.embed, Parts):
        return _embed_tp(params.embed, cfg, tokens)
    tokens = torch.as_tensor(tokens, device=params.device).to(torch.int64)
    x = params.embed[tokens].to(CDT)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=CDT)
    return x


def _embed_tp(embed: Parts, cfg: ArchConfig, tokens) -> Parts:
    """The lookup at each model position: where the vocabulary splits,
    each position's rows (others' tokens give zero rows), summed over
    positions (exact: one nonzero row a token); else its whole table."""
    def rows(table, j):
        tok = torch.as_tensor(tokens, device=table.device).to(torch.int64)
        if embed.layout == "whole":
            return table[tok]
        local = tok - j * table.shape[0]
        own = (local >= 0) & (local < table.shape[0])
        got = table[torch.where(own, local, torch.zeros_like(local))]
        return got.masked_fill(~own[..., None], 0)
    x = embed.like([rows(t, j) for j, t in enumerate(embed)],
                   "sum" if embed.layout == 0 else "whole", CDT)
    x = constrain(x, "batch", None, None).to(CDT)
    if cfg.embed_scale:
        x = x.map(lambda t: t * torch.tensor(cfg.d_model ** 0.5, dtype=CDT))
    return x


def _head_logits(params: LM, cfg: ArchConfig, x) -> torch.Tensor:
    x = params.final_norm(x)
    if isinstance(x, Parts):
        return _head_logits_tp(params, cfg, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = (x @ head.to(CDT)).to(torch.float32)
    if cfg.softcap_final:
        logits = cfg.softcap_final * torch.tanh(logits / cfg.softcap_final)
    return logits


def _head_logits_tp(params: LM, cfg: ArchConfig, x: Parts) -> torch.Tensor:
    """The logits on the first model position: each position's vocabulary
    slice gathered there where the vocabulary splits, else computed
    there alone (the loss counts once)."""
    head = params.embed if cfg.tie_embeddings else params.lm_head

    def logits(t, w):
        w = w.T if cfg.tie_embeddings else w
        out = (t @ w.to(CDT)).to(torch.float32)
        if cfg.softcap_final:
            out = cfg.softcap_final * torch.tanh(out / cfg.softcap_final)
        return out
    if head.layout == "whole":
        with build.at_position(x.positions[0]):
            return logits(x[0], head[0])
    parts = constrain(x.map(logits, head, layout=-1), "batch", None, "vocab")
    first = x[0].device
    return torch.cat([p.to(first, non_blocking=True) for p in parts], dim=-1)


def _aux(aux, like):
    """`aux` on `like`'s device, or at every model position of `like`."""
    if aux is None:
        return None
    if isinstance(like, Parts):
        return like.like([torch.as_tensor(aux, device=t.device)
                          for t in like], "whole")
    return torch.as_tensor(aux, device=like.device)


def _positions(x):
    """arange(S) for x (B, S, d) on its device, or at every model
    position of x."""
    if isinstance(x, Parts):
        return x.like([torch.arange(t.shape[1], device=t.device)
                       for t in x], "whole")
    return torch.arange(x.shape[1], device=x.device)


def _block_cache(spec: LayerSpec, cfg: ArchConfig, batch: int, max_seq: int,
                 n_aux: int, device) -> dict:
    """One layer's dense decode cache: a mamba layer's conv tail (batch,
    d_conv - 1, d_inner) bf16 and SSM state (batch, d_inner, d_state)
    fp32; else self-attention K and V (batch, seq, Hkv, D) bf16 (seq =
    the window for sliding layers, a ring, else `max_seq`) and/or cross
    K/V `ck`, `cv` (batch, n_aux, Hkv, D)."""
    if spec.kind == "mamba":
        return {"conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                    dtype=CDT, device=device),
                "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                                   dtype=torch.float32, device=device)}
    c = {}
    if spec.kind == "encdec" or not spec.cross:
        seq = min(max_seq, spec.local_window) if spec.local_window \
            else max_seq
        shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
        c["k"] = torch.zeros(shape, dtype=CDT, device=device)
        c["v"] = torch.zeros(shape, dtype=CDT, device=device)
    if spec.kind == "encdec" or spec.cross:
        shape = (batch, n_aux, cfg.n_kv_heads, cfg.head_dim)
        c["ck"] = torch.zeros(shape, dtype=CDT, device=device)
        c["cv"] = torch.zeros(shape, dtype=CDT, device=device)
    return c


def cache_axes(cfg: ArchConfig) -> dict:
    """Logical sharding axes of the dense caches, parallel to
    `init_caches`' tree (the JAX package's `cache_axes`): K/V over
    `batch`, `kv_seq` and `kv_heads`, cross K/V over `batch` and
    `kv_heads`, a mamba layer's state over `batch` and `d_inner`; each
    with the stacking axis first."""
    def block(spec: LayerSpec) -> dict:
        if spec.kind == "mamba":
            return {"conv": (None, "batch", None, "d_inner"),
                    "ssm": (None, "batch", "d_inner", None)}
        c = {}
        if spec.kind == "encdec" or not spec.cross:
            c["k"] = c["v"] = (None, "batch", "kv_seq", "kv_heads", None)
        if spec.kind == "encdec" or spec.cross:
            c["ck"] = c["cv"] = (None, "batch", None, "kv_heads", None)
        return c
    return {f"pos{i}": block(spec) for i, spec in enumerate(cfg.group_spec)}


def cache_shardings(cfg: ArchConfig, mesh, rules: dict) -> dict:
    """`cache_axes` as `NamedSharding`s under `rules` on `mesh`."""
    return {pos: {name: named_sharding(mesh, rules, ax)
                  for name, ax in e.items()}
            for pos, e in cache_axes(cfg).items()}


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                protected_kv=None, device=None, mesh=None, rules=None):
    """Dense decode caches, stacked over `n_groups`:
    {"pos{i}": {name: (n_groups, ...)}} with each layer's entries of
    `_block_cache` (cross K/V `cfg.n_aux_tokens` long). With
    `protected_kv` (a `models.kv.ProtectedKVConfig`), a
    `ProtectedKVCaches` manager instead. With `mesh` (and `rules`,
    `launch.cells.rules_for_cell`'s), each entry is zeros `Placed` by
    `cache_shardings` (made slice by slice), on the mesh's devices: K/V
    split over `batch` and `kv_seq` (over `data`, `pod` and `model` as
    the rules say: `long_500k` keeps the batch whole on every data shard
    and splits the rows) and `kv_heads`, the other entries replicated
    over the axes their rules do not name."""
    if mesh is not None:
        shapes = init_caches(cfg, batch, max_seq, device="meta")
        sh = cache_shardings(cfg, mesh, rules)
        return {pos: {name: place_zeros(t.shape, sh[pos][name],
                                        dtype=t.dtype, name=f"{pos}/{name}")
                      for name, t in e.items()}
                for pos, e in shapes.items()}
    device = resolve_device(device)
    if protected_kv is not None:
        from .kv import ProtectedKVCaches
        return ProtectedKVCaches(cfg, protected_kv, batch, max_seq,
                                 device=device)
    n_aux = cfg.n_aux_tokens or 1
    return {f"pos{i}": {name: torch.stack([buf] * cfg.n_groups)
                        for name, buf in _block_cache(spec, cfg, batch,
                                                      max_seq, n_aux,
                                                      device).items()}
            for i, spec in enumerate(cfg.group_spec)}


# ---------------------------------------------------------------------------
# forward / loss (training)
# ---------------------------------------------------------------------------


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the un-batched products' outputs, recompute everything else
    (`jax.checkpoint_policies.dots_with_no_batch_dims_saveable`)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig, fn, *args):
    """fn(*args) under `torch.utils.checkpoint`: "dots" saves the
    un-batched products, any other policy nothing (the JAX package's
    `_remat`). The recomputation's launches carry the forward's mesh
    position (`build.at_position`), on whichever thread it runs."""
    pos, inner = build.current_position(), fn

    def fn(*a):
        with build.at_position(pos):
            return inner(*a)
    if any(isinstance(a, Parts) for a in args):
        return _remat_parts(fn, args)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


def _remat_parts(fn, args):
    """fn(*args) over `Parts` (a tensor-parallel group or encoder layer)
    under the reentrant `torch.utils.checkpoint`, which saves nothing and
    recomputes the whole call in its one backward node ("dots" recomputes
    all of it too). The non-reentrant checkpoint's saved-tensor hooks
    would recompute from whichever autograd device thread unpacks first,
    and one group spans every position's card, so two threads could
    recompute one group at once. The `Parts` go in as their tensors and
    come back as the output's, beside an empty tensor that requires
    grad: the encoder's first layer takes no input that does, and the
    reentrant checkpoint backpropagates only where one does."""
    parts = [a for a in args if isinstance(a, Parts)]
    flat = [t for a in parts for t in a]
    meta: dict = {}        # the output's layout, never its tensors

    def run(_grad_anchor, *tensors):
        it = iter(tensors)
        out = fn(*(a.like([next(it) for _ in a]) if isinstance(a, Parts)
                   else a for a in args))
        meta.update(layout=out.layout, dtype=out.dtype)
        return tuple(out)
    anchor = torch.empty(0, device=flat[0].device, requires_grad=True)
    outs = checkpoint(run, anchor, *flat, use_reentrant=True)
    return parts[0].like(list(outs), meta["layout"], meta["dtype"])


def _counted_once(fn, pim_ctx):
    """fn, whose calls after the first (a remat backward's
    recomputations) run with `pim_ctx`, if any, uncounted."""
    calls = 0

    def once(*args):
        nonlocal calls
        calls += 1
        if calls == 1 or pim_ctx is None:
            return fn(*args)
        with pim_ctx.uncounted():
            return fn(*args)
    return once


def _run_group(params: LM, cfg: ArchConfig, g: int, x, positions, aux=None,
               pim_ctx=None, weights=None, split=None):
    for i, spec in enumerate(cfg.group_spec):
        idx = g * len(cfg.group_spec) + i
        with _using(weights, f"blocks.{idx}"):
            x, _ = params.blocks[idx](x, spec, cfg, positions=positions,
                                      aux=aux, pim_ctx=pim_ctx, split=split)
    return x


def _encoder_layer(params: LM, cfg: ArchConfig, j: int, x, positions,
                   weights=None):
    with _using(weights, f"encoder.{j}"):
        blk = params.encoder[j]
        x = x + blk.attn.encode(blk.norm1(x), cfg, positions).to(CDT)
        return x + blk.mlp(blk.norm2(x))


def _run_encoder(params: LM, cfg: ArchConfig, aux, remat: bool = False,
                 weights=None):
    """The bidirectional encoder over (B, Na, d) frame embeddings ->
    (B, Na, d) bf16 after `enc_norm`."""
    if aux is None:
        raise ValueError(f"{cfg.name}: the encoder needs `aux`, the frame "
                         "embeddings (B, Na, d_model)")
    x = aux.to(CDT)
    positions = _positions(x)
    for j in range(cfg.encoder_groups):
        x = (_remat(cfg, _encoder_layer, params, cfg, j, x, positions,
                    weights) if remat
             else _encoder_layer(params, cfg, j, x, positions, weights))
    with _using(weights, "enc_norm"):
        return params.enc_norm(x)


def forward(params: LM, cfg: ArchConfig, tokens, *, aux=None,
            pim_ctx=None, weights=None, split=None) -> torch.Tensor:
    """tokens: (B, S) ints; aux: (B, Na, d_model) modality embeddings
    (the encoder's input for encoder-decoder configs, the cross-attention
    K/V source for cross configs). Returns logits (B, S, V) float32. With
    `cfg.remat` and grad enabled, each group's (and encoder layer's)
    activations are recomputed in the backward pass by
    `cfg.remat_policy`. `pim_ctx` protects its target projections, in
    the recomputation too; the gradient through them is the JAX
    package's, through the scales. One data shard of a placed model runs
    with `params` its `PlacedLM.skeleton`, `weights` its `ShardWeights`
    and `split` the batch's `nn.moe.DataSplit`."""
    remat = cfg.remat and torch.is_grad_enabled()
    with _using(weights, "embed"):
        x = _embed(params, cfg, tokens)
    positions = _positions(x)
    aux = _aux(aux, x)
    if cfg.encoder_groups > 0:
        aux = _run_encoder(params, cfg, aux, remat, weights)
    for g in range(cfg.n_groups):
        args = (params, cfg, g, x, positions, aux, pim_ctx, weights, split)
        x = (_remat(cfg, _counted_once(_run_group, pim_ctx), *args) if remat
             else _run_group(*args))
    head = "embed" if cfg.tie_embeddings else "lm_head"
    with _using(weights, "final_norm", head):
        return _head_logits(params, cfg, x)


def loss_fn(params: LM, cfg: ArchConfig, batch, *, pim_ctx=None,
            weights=None, split=None, count=None):
    """Causal-LM cross entropy (a 0-d float32 tensor). batch: "tokens"
    (B, S) and "labels" (B, S), label -1 = ignore; optional "aux". The
    nll sum is divided by `count`, where given (the whole batch's label
    count, for one data shard of it), else by this batch's own count (at
    least 1). `weights` and `split` as for `forward`."""
    logits = forward(params, cfg, batch["tokens"], aux=batch.get("aux"),
                     pim_ctx=pim_ctx, weights=weights, split=split)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = (labels >= 0).to(torch.float32)
    lab = torch.clamp_min(labels, 0).to(torch.int64)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    # a fill, not a copy from the host: a copy would wait for the card
    tot = torch.clamp_min(mask.sum(), 1.0) if count is None else \
        torch.full((), float(count), dtype=torch.float32,
                   device=logits.device)
    return (nll * mask).sum() / tot


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def _roll_ring(t, S: int, W: int):
    """The prompt's last W rows of (B, S, ...) K or V, rolled so that the
    token at position q sits at slot q % W (a ring); over `Parts` at
    each position."""
    if isinstance(t, Parts):
        return t.map(lambda a: _roll_ring(a, S, W))
    return torch.roll(t[:, -W:], S % W, dims=1)


def _stack(bufs):
    """Per-group tensors, or `Parts`, stacked over a new first axis."""
    if not isinstance(bufs[0], Parts):
        return torch.stack(bufs)
    first = bufs[0]
    layout = first.layout + 1 if isinstance(first.layout, int) \
        else first.layout
    return first.like([torch.stack([b[j] for b in bufs])
                       for j in range(len(first))], layout, first.dtype)


@torch.no_grad()
def prefill(params: LM, cfg: ArchConfig, tokens, *, aux=None, pim_ctx=None,
            protected_kv=None, max_seq: int | None = None, weights=None,
            split=None):
    """Run the full prompt (B, S) and build decode caches. Returns (logits
    (B, S, V) float32, caches): stacked over groups, {"pos{i}": {name:
    (n_groups, B, ...)}}, with the prompt's RoPE'd K/V ("k", "v", S' long,
    S' = the window for sliding layers, ring-aligned), cross K/V ("ck",
    "cv", of `aux` or the encoder's output) and mamba layers' final state
    ("conv", "ssm"); or with `protected_kv` a `ProtectedKVCaches` manager
    that has ingested them (`max_seq` sizes its dense entries; the prompt
    length by default). `pim_ctx` protects its target projections.

    One data shard of a placed model runs with `params` its
    `PlacedLM.skeleton`, `weights` its `ShardWeights` and `split` the
    batch's `nn.moe.DataSplit` (MoE layers dispatch as the whole batch
    does, as in `forward`); with
    `ShardWeights(shard=k)` (tensor parallelism) every cache entry is
    `Parts`: each position's KV heads where the rules split them (all
    of them at every position where they do not) and its d_inner slice
    of a mamba state, and the logits are gathered onto the first
    position (`launch.steps.build_prefill` places the caches)."""
    B, S = tokens.shape
    with _using(weights, "embed"):
        x = _embed(params, cfg, tokens)
    positions = _positions(x)
    aux = _aux(aux, x)
    if cfg.encoder_groups > 0:
        aux = _run_encoder(params, cfg, aux, weights=weights)
    entries: dict[str, dict[str, list]] = {
        f"pos{i}": {} for i in range(len(cfg.group_spec))}
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            idx = g * len(cfg.group_spec) + i
            with _using(weights, f"blocks.{idx}"):
                blk = params.blocks[idx]
                entry = {}
                if spec.kind != "mamba":
                    if spec.kind == "encdec" or not spec.cross:
                        # capture K/V by recomputing the projections (cheap
                        # next to the attention itself)
                        k, v = blk.attn.project_kv(blk.norm1(x), cfg,
                                                   positions)
                        if spec.local_window and spec.local_window < S:
                            # ring alignment: the token at position q sits
                            # at q % W
                            k = _roll_ring(k, S, spec.local_window)
                            v = _roll_ring(v, S, spec.local_window)
                        entry["k"], entry["v"] = k, v
                    if spec.kind == "encdec" or spec.cross:
                        attn = blk.xattn if spec.kind == "encdec" \
                            else blk.attn
                        entry["ck"], entry["cv"] = attn.cross_kv(
                            aux, cfg, cached=True)
                x, nc = blk(x, spec, cfg, positions=positions, aux=aux,
                            pim_ctx=pim_ctx, split=split)
            if spec.kind == "mamba":
                entry = nc                  # the full pass's final state
            for name, val in entry.items():
                entries[f"pos{i}"].setdefault(name, []).append(val)
    caches = {pos: {name: _stack(bufs) for name, bufs in e.items()}
              for pos, e in entries.items()}
    head = "embed" if cfg.tie_embeddings else "lm_head"
    with _using(weights, "final_norm", head):
        logits = _head_logits(params, cfg, x)
    if protected_kv is not None:
        from .kv import ProtectedKVCaches
        pkv_caches = ProtectedKVCaches(cfg, protected_kv, B, max_seq or S,
                                       device=params.device)
        pkv_caches.ingest_prefill(caches, S)
        return logits, pkv_caches
    return logits, caches


def _decode_step_protected(params: LM, cfg: ArchConfig, caches, token, pos,
                           aux=None, pim_ctx=None):
    """One-token decode against `ProtectedKVCaches`: each protected layer
    appends the token's K/V and reads through its `attend`; dense entries
    update in the manager. `pos` is a scalar or a (B,) vector."""
    B = token.shape[0]
    x = _embed(params, cfg, token)
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=params.device).reshape(-1, 1)
    positions = positions.expand(B, 1)
    aux = _aux(aux, x)
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            x, nc = params.block(g, i)(x, spec, cfg, positions=positions,
                                       aux=aux, cache=caches.view(g, i),
                                       cache_pos=pos, pim_ctx=pim_ctx)
            caches.update(g, i, nc)
    return _head_logits(params, cfg, x), caches


def _layer(buf, g: int):
    """Layer g's view of a stacked cache entry (a tensor or `Parts`)."""
    if not isinstance(buf, Parts):
        return buf[g]
    layout = buf.layout - 1 if isinstance(buf.layout, int) else buf.layout
    return buf.like([t[g] for t in buf], layout, buf.dtype)


def _copy_into(dst, src) -> None:
    if isinstance(dst, Parts):
        for d, t in zip(dst, src, strict=True):
            d.copy_(t)
    else:
        dst.copy_(src)


@torch.no_grad()
def decode_step(params: LM, cfg: ArchConfig, caches, token, pos, *,
                aux=None, pim_ctx=None, weights=None, split=None):
    """One-token decode. token: (B, 1) ints; pos: the position (an int).
    `caches` is the stacked dense caches of `init_caches` or `prefill`,
    written in place (cross entries must hold K/V, from `prefill`: a
    layer with "ck" in its cache reads it, as in the JAX package), the
    `ProtectedKVCaches` manager of `prefill(..., protected_kv=...)`, or
    any manager with the same `view`/`update` surface and
    `is_protected_manager = True` (the serving engine's batched caches,
    which take a (B,) per-slot `pos`). Returns (logits (B, 1, V)
    float32, caches). `pim_ctx` protects its target projections.
    `weights` and `split` as for `prefill`: with `ShardWeights(shard=k)` the dense
    caches are `Parts` of each position's slices of a placed cache
    (`launch.steps.build_serve`), each written in place at its
    position."""
    from .kv import ProtectedKVCaches
    if (isinstance(caches, ProtectedKVCaches)
            or getattr(caches, "is_protected_manager", False)):
        return _decode_step_protected(params, cfg, caches, token, pos,
                                      aux, pim_ctx)
    with _using(weights, "embed"):
        x = _embed(params, cfg, token)

    def at(t):
        return torch.full((t.shape[0], 1), int(pos), dtype=torch.int32,
                          device=t.device)
    positions = (x.like([at(t) for t in x], "whole")
                 if isinstance(x, Parts) else at(x))
    aux = _aux(aux, x)
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            idx = g * len(cfg.group_spec) + i
            view = {name: _layer(buf, g)
                    for name, buf in caches[f"pos{i}"].items()}
            with _using(weights, f"blocks.{idx}"):
                x, nc = params.blocks[idx](x, spec, cfg, positions=positions,
                                           aux=aux, cache=view,
                                           cache_pos=pos, pim_ctx=pim_ctx,
                                           split=split)
            new = {name: val for name, val in (nc or {}).items()
                   if val is not view[name]}    # a mamba layer's new state
            if new:
                sync_replicas()         # every replica has read the state
            for name, val in new.items():
                _copy_into(view[name], val)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    with _using(weights, "final_norm", head):
        return _head_logits(params, cfg, x), caches


# ---------------------------------------------------------------------------
# PIM deployment: precoded weights (the paper's deploy-time encode, Fig. 2(b))
# ---------------------------------------------------------------------------


@torch.no_grad()
def encode_params_for_pim(params: LM, cfg: ArchConfig) -> LM:
    """Deploy-time transform: for every protected projection, store the
    ternarized + NB-LDPC-encoded int8 weights (`w_down_enc`, `wo_enc`)
    and the fp32 ternary scale (`*_alpha`) next to the fp weights, as
    buffers of each layer (`LM.pim_leaves`). Serving then reads only the
    encoded integers — the paper's 'write-time encode': checks are
    generated when the array is programmed, not per MAC. Encodes on the
    parameters' device; returns `params`, updated in place."""
    from ..core.context import PIMContext
    ctx = PIMContext(cfg.pim)
    targets = set(cfg.pim.targets)
    for blk in params.blocks:          # not the encoder, as in the JAX
        if "mlp_down" in targets and hasattr(blk, "mlp"):
            blk.mlp.w_down_enc, blk.mlp.w_down_alpha = ctx.encode_weight(
                blk.mlp.w_down)
        if "attn_o" in targets and hasattr(blk, "attn"):
            blk.attn.wo_enc, blk.attn.wo_alpha = ctx.encode_weight(
                blk.attn.wo)
    return params
