"""Time the data-parallel trainer's global gradient norm two ways on every
visible card: (A) the port's, each slice's float64 sum of squares added
in slice order (only scalars cross cards), and (B) each gradient read
whole onto the first card and summed there (every gradient crosses).

granite-3-2b at full width and depth (flash, remat, AdamW, seq 4096), 2
rows a card, `launch.train.run` over a (data = cards, model 1) mesh
under `rules_for_cell`'s rules, as `chip_smoke.py` phase 20 (a) runs it.
Six runs of 3 steps in one process, A B A B, then A and B with every
card synchronized around the norm, which times the norm alone. Prints
one JSON line a run (ms a step, grad norms, the norm's ms) and the
card's name and power limit.

Run:  python3 scripts/fsdp_norm_ab.py    (on the card; four cards for
the cross-card figures)
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed.sharding import Mesh, Placed  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.cells import rules_for_cell, settings_for  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.lm import param_shardings, place_params  # noqa: E402

ARCH, ROWS, SEQ, STEPS = "granite_3_2b", 2, 4096, 3


def gather_norm(grads):
    """(B): each gradient whole on the first card, summed there."""
    total, dev = 0, None
    for g in optim._tensors(grads):
        if dev is None:
            dev = g.local.flat[0].device if isinstance(g, Placed) \
                else g.device
        t = g.gather(dev) if isinstance(g, Placed) else g
        total = total + torch.sum(torch.square(t.to(torch.float32))).to(dev)
    return torch.sqrt(total)


def synced(fn, times: list):
    """`fn` with every card synchronized before and after, its ms kept."""
    def norm(grads):
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        out = fn(grads)
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return norm


def main() -> int:
    if not torch.cuda.is_available():
        print("fsdp_norm_ab: no CUDA device", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    cfg = dataclasses.replace(get_config(ARCH), attn_impl="flash")
    cards = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    mesh = Mesh([[c] for c in cards], ("data", "model"))
    shape = ShapeSpec("custom", SEQ, ROWS * len(cards), "train")
    rules = rules_for_cell(mesh, cfg, shape, settings_for(ARCH, shape))
    placed = place_params(init_params(cfg, 0, device=cards[0]),
                          param_shardings(cfg, mesh, rules))
    ours = optim._global_norm
    for tag, fn, sync in (("A", ours, False), ("B", gather_norm, False),
                          ("A", ours, False), ("B", gather_norm, False),
                          ("A", ours, True), ("B", gather_norm, True)):
        norm_ms: list = []
        optim._global_norm = synced(fn, norm_ms) if sync else fn
        with tempfile.TemporaryDirectory() as d:
            hist = run(cfg, params=placed, mesh=mesh, rules=rules,
                       steps=STEPS, batch=shape.global_batch, seq=SEQ, seed=0,
                       ckpt_dir=d, save_every=STEPS + 1, log=lambda m: None)
        print(json.dumps({"norm": tag, "cards": len(cards), "synced": sync,
                          "ms": [h["seconds"] * 1e3 for h in hist],
                          "grad_norm": [h["grad_norm"] for h in hist],
                          "norm_ms": norm_ms}), flush=True)
    optim._global_norm = ours
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
