"""End-to-end training example on the PyTorch/CUDA port (the
counterpart of `examples/train_small.py`): a ~100M-param granite-family
model on the synthetic pipeline with checkpoints, restart safety and the
straggler watchdog.

Its geometry is d_model 1024 x 6 groups (98.6M parameters; 16 query
heads over granite's 8 KV heads). The JAX example's 768 x 12 gives 12
query heads over 8 KV heads, which neither package's attention takes
(the reshape into KV groups raises in both).

Run:  PYTHONPATH=src python scripts/train_small_torch.py [--steps 200] [--cpu]
(on the card; `--cpu` trains on the CPU). Any other flag of
`repro_torch.launch.train` given here overrides the example's own, e.g.
`--d-model 64 --n-groups 2 --ckpt-dir DIR` for a smaller model elsewhere.
"""
import os
import sys
import tempfile

from repro_torch.launch import train

if __name__ == "__main__":
    args = sys.argv[1:]
    device = None
    if "--cpu" in args:
        args.remove("--cpu")
        device = "cpu"
    steps = "200"
    if "--steps" in args:
        steps = args[args.index("--steps") + 1]
    # d_model 1024 x 6 groups ~= 100M params
    train.main(["--arch", "granite_3_2b", "--reduced",
                "--d-model", "1024", "--n-groups", "6",
                "--vocab", "4096", "--seq", "256", "--batch", "8",
                "--steps", steps, "--lr", "1e-3",
                "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                           "repro_torch_train_small"),
                "--save-every", "50", "--log-every", "10", *args],
               device=device)
