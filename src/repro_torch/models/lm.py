"""Config-driven dense transformer: parameters, prefill and decode.

The stack is `n_groups` repetitions of `cfg.group_spec`, as in the JAX
package's `repro.models.lm`; here it is a `ModuleList` of `Block`s run in
a Python loop (block `g * len(group_spec) + i` is group g, position i).
This slice ports the dense attention-only subset: global and
sliding-window self-attention with a gated MLP. MoE, mamba,
encoder-decoder and cross blocks raise `NotImplementedError`
(ROADMAP Queue 1 item 9).

PIM protection (the paper's technique) plugs in through `pim_ctx`, a
`core.context.PIMContext`: every block's `mlp_down` and `attn_o`
projections that its targets name run on the protected PIM path, in
`forward` (inference), `prefill` and `decode_step`.
`encode_params_for_pim` precodes those weights once, as the JAX package's
deploy-time transform does. A backward through the protected projections
is not ported (ROADMAP Queue 1 item 10).

Entry points: `init_params` / `forward` / `loss_fn` / `init_caches` /
`prefill` / `decode_step`. `forward` and `loss_fn` are the training pass:
under `cfg.remat` (with grad enabled) each group runs under
`torch.utils.checkpoint`, the counterpart of the JAX package's
`jax.checkpoint` over the group body.
`prefill(..., protected_kv=ProtectedKVConfig(...))` returns a
`ProtectedKVCaches` manager whose global-attention K/V live in NB-LDPC
protected paged stores; `decode_step` serves through it (or through the
dense caches of `init_caches`, which it updates in place). Both run on the
parameters' device; `init_params` puts them on the card unless asked for
the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, LayerSpec
from ..device import resolve_device
from ..nn.layers import CDT, Block, RMSNorm, _param

__all__ = ["LM", "init_params", "forward", "loss_fn", "init_caches",
           "prefill", "decode_step", "encode_params_for_pim"]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.encoder_groups or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: encoder and MoE stacks are not ported yet: "
            "ROADMAP Queue 1 item 9")


class LM(nn.Module):
    """The model's parameters: `embed` (V, d), `final_norm`, `lm_head`
    (d, V) unless the embeddings are tied, and one `Block` per layer."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), generator, device)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), generator,
                                  device)
        self.blocks = nn.ModuleList(
            Block(spec, cfg, generator=generator, device=device)
            for _ in range(cfg.n_groups) for spec in cfg.group_spec)

    def block(self, g: int, i: int) -> Block:
        return self.blocks[g * len(self.cfg.group_spec) + i]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def leaves(self) -> dict[str, list[nn.Parameter]]:
        """The parameters as the JAX package's pytree leaves, keyed by path
        ("embed", "final_norm/scale", "groups/pos0/attn/wq", ...) in that
        tree's leaf order: a group leaf lists its `n_groups` per-layer
        tensors (the JAX leaf stacks them), any other leaf one tensor."""
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
    its group index or None): "blocks.3.attn.wq" with a 2-layer group is
    (("groups", "pos1", "attn", "wq"), 1)."""
    path = name.split(".")
    if path[0] != "blocks":
        return tuple(path), None
    g, i = divmod(int(path[1]), len(cfg.group_spec))
    return ("groups", f"pos{i}", *path[2:]), g


def init_params(cfg: ArchConfig, generator: torch.Generator | int = 0, *,
                device=None) -> LM:
    """A model with N(0, 0.02²) float32 weights and unit norm scales, the
    JAX package's distributions (not its bits). `generator` is a
    `torch.Generator` (the model goes on its device unless `device` says
    otherwise) or a seed for one on `device` (the card by default)."""
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


def _block_cache(spec: LayerSpec, cfg: ArchConfig, batch: int, max_seq: int,
                 device) -> dict:
    """One layer's dense decode cache: K and V (batch, seq, Hkv, D) bf16,
    seq = the window for sliding layers (a ring), else `max_seq`."""
    seq = min(max_seq, spec.local_window) if spec.local_window else max_seq
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=CDT, device=device),
            "v": torch.zeros(shape, dtype=CDT, device=device)}


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                protected_kv=None, device=None):
    """Dense decode caches, stacked over `n_groups`:
    {"pos{i}": {"k", "v": (n_groups, batch, seq, Hkv, D)}}. With
    `protected_kv` (a `models.kv.ProtectedKVConfig`), a `ProtectedKVCaches`
    manager instead."""
    _check_supported(cfg)
    device = resolve_device(device)
    if protected_kv is not None:
        from .kv import ProtectedKVCaches
        return ProtectedKVCaches(cfg, protected_kv, batch, max_seq,
                                 device=device)
    return {f"pos{i}": {name: torch.stack([buf] * cfg.n_groups)
                        for name, buf in _block_cache(spec, cfg, batch,
                                                      max_seq,
                                                      device).items()}
            for i, spec in enumerate(cfg.group_spec)}


# ---------------------------------------------------------------------------
# forward / loss (training)
# ---------------------------------------------------------------------------


def _run_group(params: LM, cfg: ArchConfig, g: int, x, positions,
               pim_ctx=None):
    for i, spec in enumerate(cfg.group_spec):
        x, _ = params.block(g, i)(x, spec, cfg, positions=positions,
                                  pim_ctx=pim_ctx)
    return x


def forward(params: LM, cfg: ArchConfig, tokens, *, aux=None,
            pim_ctx=None) -> torch.Tensor:
    """tokens: (B, S) ints. Returns logits (B, S, V) float32. With
    `cfg.remat` and grad enabled, each group's activations are recomputed
    in the backward pass (remat_policy "full": nothing inside a group is
    saved). With `pim_ctx` it is an inference pass: under grad it
    raises."""
    if pim_ctx is not None and torch.is_grad_enabled():
        raise NotImplementedError(
            "a backward through the PIM-protected projections (pim_ctx) is "
            "not ported: ROADMAP Queue 1 item 10; run forward with pim_ctx "
            "under torch.no_grad()")
    if aux is not None:
        raise NotImplementedError("auxiliary (cross-attention) inputs are "
                                  "not ported yet: ROADMAP Queue 1 item 9")
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported (no config "
            "uses it): ROADMAP Queue 1 item 9")
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=params.device)
    for g in range(cfg.n_groups):
        if remat:
            x = checkpoint(_run_group, params, cfg, g, x, positions,
                           use_reentrant=False)
        else:
            x = _run_group(params, cfg, g, x, positions, pim_ctx)
    return _head_logits(params, cfg, x)


def loss_fn(params: LM, cfg: ArchConfig, batch, *, pim_ctx=None):
    """Causal-LM cross entropy (a 0-d float32 tensor). batch: "tokens"
    (B, S) and "labels" (B, S), label -1 = ignore."""
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
    (B, S, V) float32, caches): the prompt's RoPE'd K/V stacked over groups
    ({"pos{i}": {"k", "v": (n_groups, B, S', Hkv, D)}}, S' = the window
    for sliding layers, ring-aligned), or with `protected_kv` a
    `ProtectedKVCaches` manager that has ingested them (`max_seq` sizes
    its dense entries; the prompt length by default). `pim_ctx` protects
    its target projections."""
    if aux is not None:
        raise NotImplementedError("auxiliary (cross-attention) inputs are "
                                  "not ported yet: ROADMAP Queue 1 item 9")
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=params.device)
    entries = {f"pos{i}": {"k": [], "v": []}
               for i in range(len(cfg.group_spec))}
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            blk = params.block(g, i)
            # capture K/V by recomputing the projections (cheap next to
            # the attention itself)
            k, v = blk.attn.project_kv(blk.norm1(x), cfg, positions)
            if spec.local_window and spec.local_window < S:
                # ring alignment: the token at position q sits at q % W
                Wd = spec.local_window
                k = torch.roll(k[:, -Wd:], S % Wd, dims=1)
                v = torch.roll(v[:, -Wd:], S % Wd, dims=1)
            entries[f"pos{i}"]["k"].append(k)
            entries[f"pos{i}"]["v"].append(v)
            x, _ = blk(x, spec, cfg, positions=positions, pim_ctx=pim_ctx)
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
                           pim_ctx=None):
    """One-token decode against `ProtectedKVCaches`: each protected layer
    appends the token's K/V and reads through its `attend`; dense entries
    update in the manager. `pos` is a scalar or a (B,) vector."""
    B = token.shape[0]
    x = _embed(params, cfg, token)
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=params.device).reshape(-1, 1)
    positions = positions.expand(B, 1)
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            x, nc = params.block(g, i)(x, spec, cfg, positions=positions,
                                       cache=caches.view(g, i),
                                       cache_pos=pos, pim_ctx=pim_ctx)
            caches.update(g, i, nc)
    return _head_logits(params, cfg, x), caches


@torch.no_grad()
def decode_step(params: LM, cfg: ArchConfig, caches, token, pos, *,
                aux=None, pim_ctx=None):
    """One-token decode. token: (B, 1) ints; pos: the position (an int).
    `caches` is the stacked dense caches of `init_caches`, written in
    place, the `ProtectedKVCaches` manager of `prefill(...,
    protected_kv=...)`, or any manager with the same `view`/`update`
    surface and `is_protected_manager = True` (the serving engine's
    batched caches, which take a (B,) per-slot `pos`). Returns (logits
    (B, 1, V) float32, caches).
    `pim_ctx` protects its target projections."""
    if aux is not None:
        raise NotImplementedError("auxiliary (cross-attention) inputs are "
                                  "not ported yet: ROADMAP Queue 1 item 9")
    from .kv import ProtectedKVCaches
    if (isinstance(caches, ProtectedKVCaches)
            or getattr(caches, "is_protected_manager", False)):
        return _decode_step_protected(params, cfg, caches, token, pos,
                                      pim_ctx)
    B = token.shape[0]
    x = _embed(params, cfg, token)
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=params.device)
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.group_spec):
            gc = caches[f"pos{i}"]
            x, _ = params.block(g, i)(
                x, spec, cfg, positions=positions,
                cache={"k": gc["k"][g], "v": gc["v"][g]}, cache_pos=pos,
                pim_ctx=pim_ctx)
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
    for blk in params.blocks:
        if "mlp_down" in targets and hasattr(blk, "mlp"):
            blk.mlp.w_down_enc, blk.mlp.w_down_alpha = ctx.encode_weight(
                blk.mlp.w_down)
        if "attn_o" in targets:
            blk.attn.wo_enc, blk.attn.wo_alpha = ctx.encode_weight(
                blk.attn.wo)
    return params
