"""Batched serving command line with optional NB-LDPC PIM protection.

Prefill the prompt batch, then decode tokens greedily step by step. With
`--protect`, the target projections run through the simulated-PIM +
NB-LDPC path (the paper's deployment scenario); `--fault-rate` injects the
paper's Fig. 6(c) fault model (±1 output errors) into every protected MAC
so the ECC actually works. `--precoded` ternarizes and encodes those
weights once before serving (`models.encode_params_for_pim`) instead of
per call. Runs on the card unless `--device cpu`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper_pim \
      --reduced --batch 4 --prompt-len 16 --gen 8 --protect --fault-rate 1e-3
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import PIMSpec
from ..core.context import PIMContext
from ..device import resolve_device
from ..models import (decode_step, encode_params_for_pim, init_caches,
                      init_params, prefill)

FAULT_SEED = 7          # the fault draws' seed (the JAX package's key 7)


def main(argv=None) -> np.ndarray:
    """Returns the generated tokens, (batch, gen) int64."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_pim")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--protect", action="store_true")
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--precoded", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_groups=2, d_model=128, n_heads=4, d_ff=256)
    if args.protect and not cfg.pim.enabled:
        cfg = dataclasses.replace(cfg, pim=PIMSpec(
            enabled=True, code_name="wl40_r08", mode="correct", n_iters=4))

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen)
    B, S = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device)

    ctx = None
    if args.protect:
        base = PIMContext(cfg.pim)
        ctx = (base.with_faults(FAULT_SEED, args.fault_rate)
               if args.fault_rate > 0 else base)
        if args.precoded:
            encode_params_for_pim(params, cfg)

    t0 = time.time()
    logits, pre = prefill(params, cfg, prompts, pim_ctx=ctx)
    # re-home the prompt's caches into max-length buffers for decoding
    caches = init_caches(cfg, B, S + args.gen, device=device)
    for pos, entry in pre.items():
        for name, val in entry.items():
            caches[pos][name][:, :, :val.shape[2]] = val
    tok = logits[:, -1:].argmax(dim=-1)
    outs = [tok]
    print(f"prefill: {tuple(logits.shape)} in {time.time() - t0:.2f}s")

    t0 = time.time()
    for i in range(args.gen - 1):
        logits, caches = decode_step(params, cfg, caches, tok, S + i,
                                     pim_ctx=ctx)
        tok = logits.argmax(dim=-1)
        outs.append(tok)
    out = torch.cat(outs, dim=1).cpu().numpy()
    dt = time.time() - t0
    print("generated tokens:")
    for b in range(B):
        print(f"  [{b}]", out[b].tolist())
    print(f"decode: {args.gen - 1} steps x {B} seqs in {dt:.2f}s "
          f"({(args.gen - 1) * B / max(dt, 1e-9):.1f} tok/s)"
          + ("  [NB-LDPC protected]" if args.protect else ""))
    return out


if __name__ == "__main__":
    main()
