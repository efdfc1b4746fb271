"""Memory-mode example on the PyTorch/CUDA port (the counterpart of
`examples/memory_mode.py`, paper §3.1): NB-LDPC protecting *stored* data
via the `repro_torch.memory` subsystem.

Part 1 — `ProtectedMemoryArray`: tensors are packed into GF(3) codewords on
write; MLC device faults (asymmetric level transitions, retention drift,
stuck-at cells) are injected through the channel models; reads correct
transparently under a write-back controller and a scrub sweep repairs the
whole array in place.

Part 2 — the framework's own checkpoints: protected payloads ride the same
subsystem, and storage rot is injected with `inject_storage_faults` (the
channel API — no hand-editing of the on-disk layout).

Run:  PYTHONPATH=src python scripts/memory_mode_torch.py [--cpu]
(on the card; `--cpu` runs the kernels' plain versions on the CPU)
"""
import sys
import tempfile

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.device import resolve_device
from repro_torch.memory import (Compose, ProtectedMemoryArray, RetentionDrift,
                                StuckAt, asymmetric_adjacent)

device = resolve_device("cpu" if "--cpu" in sys.argv[1:] else None)

# a physics stack: adjacent-level confusion + slow drift + a few dead cells
device_noise = Compose(
    asymmetric_adjacent(3, eps_up=2e-3, eps_down=1e-3),
    RetentionDrift(3, rate=5e-7, rest_level=0),     # ~0.2%/h of aging
    StuckAt(3, fraction=2e-4, stuck_level=0, seed=7),
)

# ---- Part 1: protected array + controller policies -------------------------
mem = ProtectedMemoryArray("wl320_r08", controller="writeback", chunk_size=128,
                           device=device)
kv = np.linspace(-2, 2, 8192).astype(np.float32).reshape(128, 64)
mem.write("kv_cache", kv)

n_cells = mem.inject(device_noise, t=3600.0)            # one hour of aging
print(f"injected {n_cells} faulty cells into stored codewords")

out = mem.read("kv_cache")
st = mem.stats
print(f"read-back exact={np.array_equal(out, kv)}  "
      f"(detected={st.detected} corrected={st.corrected} "
      f"uncorrectable={st.uncorrectable} writebacks={st.writebacks})")
assert np.array_equal(out, kv)

mem.inject(device_noise, t=3600.0)                      # keep aging
report = mem.scrub()
print(f"scrub: {report['words_scanned']} words scanned, "
      f"{report['corrected']} repaired in place, "
      f"{report['bandwidth_cells_per_s'] / 1e6:.2f} Mcells/s")

# ---- Part 2: NB-LDPC-protected checkpoints ---------------------------------
with tempfile.TemporaryDirectory() as d:
    tree = {"layer/w": np.linspace(-2, 2, 4096).astype(np.float32).reshape(64, 64),
            "layer/b": np.zeros(64, np.float32)}
    path = ckpt.save_checkpoint(d, 100, tree, protect=True, device=device)
    print(f"saved NB-LDPC-protected checkpoint: {path}")

    n = ckpt.inject_storage_faults(d, device_noise, key=0, t=3600.0,
                                   device=device)
    print(f"injected {n} faulty cells into the stored checkpoint")

    out, man = ckpt.restore_checkpoint(d, tree, device=device)
    ok = all(np.array_equal(out[k], tree[k]) for k in tree)
    cs = man["correction_stats"]
    print(f"restore with FBP correction: exact={ok} "
          f"(corrected {cs['corrected']}/{cs['detected']} flagged words)")
    assert ok
    print("OK: memory-mode NB-LDPC recovered the corrupted checkpoint.")
