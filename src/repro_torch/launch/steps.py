"""The train step: loss, backward and the optimizer update on one card.

The port's counterpart of the JAX package's `launch/steps.py::build_train`
with no shardings and no mesh. Prefill and serve steps are the model's own
`prefill` / `decode_step`.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.lm import LM, loss_fn
from ..optim import make_optimizer, warmup_cosine
from .cells import optimizer_for


def build_train(cfg: ArchConfig, microbatches: int = 1, *, lr: float = 3e-4,
                total_steps: int = 10000):
    """-> (train_step, tx). `train_step(model, opt_state, batch)` runs the
    loss and its backward over `microbatches` equal slices of the batch
    (gradients accumulate in the parameters' fp32 `.grad`, then divide by
    the slice count), updates the model and `opt_state` in place through
    `tx` (`optimizer_for(cfg)`, AdamW or Adafactor, under
    `warmup_cosine(lr, 200, total_steps)`) and returns the metrics
    {"loss", "grad_norm"} as 0-d tensors. `batch` holds "tokens" and
    "labels" (B, S), numpy or tensors, and "aux" (B, Na, d_model) for
    the configs that take auxiliary embeddings."""
    tx = make_optimizer(optimizer_for(cfg),
                        warmup_cosine(lr, 200, total_steps))
    mb = microbatches

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

    return train_step, tx
