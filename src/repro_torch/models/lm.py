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
`forward` (inference), `prefill` and `decode_step` (the MoE experts and
the encoder are not protected, as in the JAX package).
`encode_params_for_pim` precodes those weights once, as the JAX package's
deploy-time transform does. A backward through the protected projections
is not ported (ROADMAP Queue 1 item 10).

Entry points: `init_params` / `forward` / `loss_fn` / `init_caches` /
`prefill` / `decode_step`. `forward` and `loss_fn` are the training pass:
under `cfg.remat` (with grad enabled) each group, and each encoder layer,
runs under `torch.utils.checkpoint`, the counterpart of the JAX package's
`jax.checkpoint` over the group body: remat_policy "full" saves nothing,
"dots" saves the outputs of the un-batched products (`aten.mm`, what
`x @ W` lowers to) and recomputes the rest
(`dots_with_no_batch_dims_saveable`).
`prefill(..., protected_kv=ProtectedKVConfig(...))` returns a
`ProtectedKVCaches` manager whose global-attention K/V live in NB-LDPC
protected paged stores (mamba states, cross K/V and sliding-window rings
stay dense there); `decode_step` serves through it (or through the dense
caches of `init_caches`, which it updates in place). Both run on the
parameters' device; `init_params` puts them on the card unless asked for
the CPU. `attn_impl="standin"` (the JAX package's cost-lowering tooling)
is not ported, by design.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig, LayerSpec
from ..device import resolve_device
from ..nn.layers import CDT, Block, RMSNorm, _param

__all__ = ["LM", "init_params", "forward", "loss_fn", "init_caches",
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


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _embed(params: LM, cfg: ArchConfig, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=params.device).to(torch.int64)
    x = params.embed[tokens].to(CDT)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=CDT)
    return x


def _head_logits(params: LM, cfg: ArchConfig, x) -> torch.Tensor:
    x = params.final_norm(x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = (x @ head.to(CDT)).to(torch.float32)
    if cfg.softcap_final:
        logits = cfg.softcap_final * torch.tanh(logits / cfg.softcap_final)
    return logits


def _aux(params: LM, aux):
    return None if aux is None else torch.as_tensor(aux, device=params.device)


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


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                protected_kv=None, device=None):
    """Dense decode caches, stacked over `n_groups`:
    {"pos{i}": {name: (n_groups, ...)}} with each layer's entries of
    `_block_cache` (cross K/V `cfg.n_aux_tokens` long). With
    `protected_kv` (a `models.kv.ProtectedKVConfig`), a
    `ProtectedKVCaches` manager instead."""
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
    `_remat`)."""
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


def _run_group(params: LM, cfg: ArchConfig, g: int, x, positions, aux=None,
               pim_ctx=None):
    for i, spec in enumerate(cfg.group_spec):
        x, _ = params.block(g, i)(x, spec, cfg, positions=positions,
                                  aux=aux, pim_ctx=pim_ctx)
    return x


def _encoder_layer(blk: Block, cfg: ArchConfig, x, positions):
    x = x + blk.attn.encode(blk.norm1(x), cfg, positions).to(CDT)
    return x + blk.mlp(blk.norm2(x))


def _run_encoder(params: LM, cfg: ArchConfig, aux, remat: bool = False):
    """The bidirectional encoder over (B, Na, d) frame embeddings ->
    (B, Na, d) bf16 after `enc_norm`."""
    if aux is None:
        raise ValueError(f"{cfg.name}: the encoder needs `aux`, the frame "
                         "embeddings (B, Na, d_model)")
    x = aux.to(CDT)
    positions = torch.arange(x.shape[1], device=x.device)
    for blk in params.encoder:
        x = (_remat(cfg, _encoder_layer, blk, cfg, x, positions) if remat
             else _encoder_layer(blk, cfg, x, positions))
    return params.enc_norm(x)


def forward(params: LM, cfg: ArchConfig, tokens, *, aux=None,
            pim_ctx=None) -> torch.Tensor:
    """tokens: (B, S) ints; aux: (B, Na, d_model) modality embeddings
    (the encoder's input for encoder-decoder configs, the cross-attention
    K/V source for cross configs). Returns logits (B, S, V) float32. With
    `cfg.remat` and grad enabled, each group's (and encoder layer's)
    activations are recomputed in the backward pass by
    `cfg.remat_policy`. With `pim_ctx` it is an inference pass: under
    grad it raises."""
    if pim_ctx is not None and torch.is_grad_enabled():
        raise NotImplementedError(
            "a backward through the PIM-protected projections (pim_ctx) is "
            "not ported: ROADMAP Queue 1 item 10; run forward with pim_ctx "
            "under torch.no_grad()")
    remat = cfg.remat and torch.is_grad_enabled()
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=params.device)
    aux = _aux(params, aux)
    if cfg.encoder_groups > 0:
        aux = _run_encoder(params, cfg, aux, remat)
    for g in range(cfg.n_groups):
        if remat:
            x = _remat(cfg, _run_group, params, cfg, g, x, positions, aux)
        else:
            x = _run_group(params, cfg, g, x, positions, aux, pim_ctx)
    return _head_logits(params, cfg, x)


def loss_fn(params: LM, cfg: ArchConfig, batch, *, pim_ctx=None):
    """Causal-LM cross entropy (a 0-d float32 tensor). batch: "tokens"
    (B, S) and "labels" (B, S), label -1 = ignore; optional "aux"."""
    logits = forward(params, cfg, batch["tokens"], aux=batch.get("aux"),
                     pim_ctx=pim_ctx)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = (labels >= 0).to(torch.float32)
    lab = torch.clamp_min(labels, 0).to(torch.int64)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    tot = torch.clamp_min(mask.sum(), 1.0)
    return (nll * mask).sum() / tot


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(params: LM, cfg: ArchConfig, tokens, *, aux=None, pim_ctx=None,
            protected_kv=None, max_seq: int | None = None):
    """Run the full prompt (B, S) and build decode caches. Returns (logits
    (B, S, V) float32, caches): stacked over groups, {"pos{i}": {name:
    (n_groups, B, ...)}}, with the prompt's RoPE'd K/V ("k", "v", S' long,
    S' = the window for sliding layers, ring-aligned), cross K/V ("ck",
    "cv", of `aux` or the encoder's output) and mamba layers' final state
    ("conv", "ssm"); or with `protected_kv` a `ProtectedKVCaches` manager
    that has ingested them (`max_seq` sizes its dense entries; the prompt
    length by default). `pim_ctx` protects its target projections."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=params.device)
    aux = _aux(params, aux)
    if cfg.encoder_groups > 0:
        aux = _run_encoder(params, cfg, aux)
    entries: dict[str, dict[str, list]] = {
        f"pos{i}": {} for i in range(len(cfg.group_spec))}
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            blk = params.block(g, i)
            entry = {}
            if spec.kind != "mamba":
                if spec.kind == "encdec" or not spec.cross:
                    # capture K/V by recomputing the projections (cheap
                    # next to the attention itself)
                    k, v = blk.attn.project_kv(blk.norm1(x), cfg, positions)
                    if spec.local_window and spec.local_window < S:
                        # ring alignment: the token at position q sits at
                        # q % W
                        Wd = spec.local_window
                        k = torch.roll(k[:, -Wd:], S % Wd, dims=1)
                        v = torch.roll(v[:, -Wd:], S % Wd, dims=1)
                    entry["k"], entry["v"] = k, v
                if spec.kind == "encdec" or spec.cross:
                    attn = blk.xattn if spec.kind == "encdec" else blk.attn
                    entry["ck"], entry["cv"] = attn.cross_kv(aux, cfg)
            x, nc = blk(x, spec, cfg, positions=positions, aux=aux,
                        pim_ctx=pim_ctx)
            if spec.kind == "mamba":
                entry = nc                  # the full pass's final state
            for name, val in entry.items():
                entries[f"pos{i}"].setdefault(name, []).append(val)
    caches = {pos: {name: torch.stack(bufs) for name, bufs in e.items()}
              for pos, e in entries.items()}
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
    aux = _aux(params, aux)
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            x, nc = params.block(g, i)(x, spec, cfg, positions=positions,
                                       aux=aux, cache=caches.view(g, i),
                                       cache_pos=pos, pim_ctx=pim_ctx)
            caches.update(g, i, nc)
    return _head_logits(params, cfg, x), caches


@torch.no_grad()
def decode_step(params: LM, cfg: ArchConfig, caches, token, pos, *,
                aux=None, pim_ctx=None):
    """One-token decode. token: (B, 1) ints; pos: the position (an int).
    `caches` is the stacked dense caches of `init_caches` or `prefill`,
    written in place (cross entries must hold K/V, from `prefill`: a
    layer with "ck" in its cache reads it, as in the JAX package), the
    `ProtectedKVCaches` manager of `prefill(..., protected_kv=...)`, or
    any manager with the same `view`/`update` surface and
    `is_protected_manager = True` (the serving engine's batched caches,
    which take a (B,) per-slot `pos`). Returns (logits (B, 1, V)
    float32, caches). `pim_ctx` protects its target projections."""
    from .kv import ProtectedKVCaches
    if (isinstance(caches, ProtectedKVCaches)
            or getattr(caches, "is_protected_manager", False)):
        return _decode_step_protected(params, cfg, caches, token, pos,
                                      aux, pim_ctx)
    B = token.shape[0]
    x = _embed(params, cfg, token)
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=params.device)
    aux = _aux(params, aux)
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            view = {name: buf[g] for name, buf in caches[f"pos{i}"].items()}
            x, nc = params.block(g, i)(x, spec, cfg, positions=positions,
                                       aux=aux, cache=view, cache_pos=pos,
                                       pim_ctx=pim_ctx)
            for name, val in (nc or {}).items():
                if val is not view[name]:       # a mamba layer's new state
                    view[name].copy_(val)
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
