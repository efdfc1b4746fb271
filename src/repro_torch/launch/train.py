"""End-to-end training driver on one card.

The port's counterpart of the JAX package's `launch/train.py`: a
config-driven model, the resumable `TokenPipeline`, AdamW or Adafactor
(`launch.cells.optimizer_for`), atomic checkpoints through
`RestartManager` and a straggler watchdog. `main` keeps the JAX driver's
flags and defaults and calls `run`, which does the loop; `run` takes any
`ArchConfig` (e.g. one with `attn_impl="flash"`, which routes attention
through the flash kernels). It runs on the card unless the caller passes
`device="cpu"`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \
      --reduced --steps 120 --batch 8 --seq 128 --ckpt-dir runs/run1
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import get_config
from ..configs.base import ArchConfig
from ..data import DataConfig, TokenPipeline
from ..device import resolve_device
from ..distributed.fault import RestartManager, StragglerWatchdog
from ..kernels import build
from ..models.lm import LM, init_params
from .steps import build_train


def run(cfg: ArchConfig, *, steps: int = 100,
        batch: int = 8, seq: int = 128, lr: float = 3e-3,
        microbatches: int = 1, ckpt_dir: str | None = None,
        save_every: int = 50, log_every: int = 10, seed: int = 0,
        protect: bool = False, device=None, params: LM | None = None,
        log=print) -> list[dict]:
    """Train `cfg` for `steps` optimizer steps (resuming from the newest
    checkpoint in `ckpt_dir`, if any), with the optimizer that
    `optimizer_for(cfg)` picks; `params` is a starting model (moved to `device`),
    else `init_params(cfg, seed)`. Checkpoints are written every
    `save_every` steps, NB-LDPC-protected with `protect`. Returns one dict
    per step run: step, loss, grad_norm, seconds (host clock around the
    step, ending in the loss's read-back) and launches (the kernel
    launches the step made, by kernel name)."""
    device = resolve_device(device)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_train")
    train_step, tx = build_train(cfg, microbatches, lr=lr,
                                 total_steps=steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed)
    mgr = RestartManager(ckpt_dir, save_every=save_every, protect=protect,
                         device=device)
    dog = StragglerWatchdog()

    model = params.to(device) if params is not None else \
        init_params(cfg, seed, device=device)
    fresh = {"params": model.leaves(), "opt": tx.init(model.leaves())}
    state, start_step, data_state = mgr.restore_or_init(lambda: fresh)
    opt = state["opt"]
    if state is not fresh:                 # restored: load into the model
        with torch.no_grad():
            for k, ps in model.leaves().items():
                for p, saved in zip(ps, state["params"][k], strict=True):
                    p.copy_(saved)
        opt["step"] = int(opt["step"])
    del fresh, state
    pipe = (TokenPipeline.restore(dcfg, data_state) if data_state
            else TokenPipeline(dcfg, step=start_step))

    history = []
    for step in range(start_step, steps):
        before = dict(build.LAUNCHES)
        dog.step_start()
        opt, metrics = train_step(model, opt, next(pipe))
        loss = float(metrics["loss"])
        dt = dog.step_end(step)
        gnorm = float(metrics["grad_norm"])
        launches = {k: n - before.get(k, 0)
                    for k, n in build.LAUNCHES.items()
                    if n != before.get(k, 0)}
        history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                        "seconds": dt, "launches": launches})
        if step % log_every == 0 or step == steps - 1:
            log(f"step {step:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}  "
                f"{dt:.2f}s")
        mgr.maybe_save(step, {"params": model.leaves(), "opt": opt},
                       data_state=pipe.state())
    if history:
        log(f"final loss {history[-1]['loss']:.4f} (first "
            f"{history[0]['loss']:.4f}); stragglers flagged: "
            f"{len(dog.flagged)}")
    return history


def main(argv=None, *, device=None):
    """The JAX driver's command line; returns the losses of the steps
    run. `device` (not a flag) lets a caller train on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-groups", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_groups=args.n_groups, d_model=args.d_model,
                          n_heads=max(4, args.d_model // 64),
                          d_ff=4 * args.d_model, vocab=args.vocab)
    history = run(cfg, steps=args.steps, batch=args.batch,
                  seq=args.seq, lr=args.lr, microbatches=args.microbatches,
                  ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                  log_every=args.log_every, seed=args.seed, device=device)
    return [h["loss"] for h in history]


if __name__ == "__main__":
    main()
