"""Device time of the fused protected read (`attend_protected`) at
chip_smoke.py phase 2's shapes and at one request's (B = 1) over short
and long contexts, for the port in a given source tree, so that two
commits can be compared on one card in one call (parent, change, change,
parent):

    python3 scripts/attend_compare.py TREE LABEL

TREE is a checkout of this repository (`.`, or a `git archive` of another
commit unpacked into a directory that .gitignore lists); its `src/` goes
first on the import path and its kernels are built from its own sources.
The operands come from chip_smoke.py's `attend_operands` (this script's
checkout), seeded per case, so every tree gets the same inputs. Where the
tree's `attend_protected` takes `ref_pages`, the engine's case passes the
engine's bound (phase 14's max_seq in pages), as `BatchedPagedKV` does.

Prints the card's name and power limit, then one line
`ATTEND LABEL {json}`: per case the device ms (torch.profiler, the
kernels alone), the CUDA-event ms of a call, the plan (`attend_plan`'s
tuple), the ranges it launches and the max abs error against the plain
version. Exits 1 where the kernel leaves phase 2's tolerance.
"""
from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SERVING = dict(B=4, Sq=1, Hq=32, Hkv=8, D=64, T=16, NP=32, S=1)
# label, shape, ragged valid counts, ranges sized for the engine's max_seq
CASES = [
    ("serving", SERVING, False, False),
    ("per_slot", {**SERVING, "S": 4}, True, False),
    ("long_np256", {**SERVING, "NP": 256}, False, False),
    ("engine_per_slot", {**SERVING, "S": 4, "NP": 20}, True, True),
    ("single_np32", {**SERVING, "B": 1}, False, False),
    ("single_np128", {**SERVING, "B": 1, "NP": 128}, False, False),
    ("single_np256", {**SERVING, "B": 1, "NP": 256}, False, False),
    ("single_np512", {**SERVING, "B": 1, "NP": 512}, False, False),
]


def main(tree: str, label: str) -> int:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as smoke
    from repro_torch.core import get_code
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    if not torch.cuda.is_available():
        print("attend_compare: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    takes_ref = "ref_pages" in inspect.signature(
        pa.attend_protected).parameters
    code = get_code("wl160_r08")
    sms = build.sm_count(device)
    ref = -(-smoke.ENGINE_MAX_SEQ // SERVING["T"])
    out, ok = {}, True
    for i, (case, shape, ragged, engine) in enumerate(CASES):
        gen = torch.Generator(device=device).manual_seed(smoke.SEED + i)
        args, kw = smoke.attend_operands(device, gen, code=code,
                                         ragged=ragged, **shape)
        kw.update(with_hot=True)
        plan_args = (shape["NP"], shape["B"] * shape["Hkv"], shape["T"], sms)
        if engine and takes_ref:
            kw.update(ref_pages=ref)
            plan_args += (ref,)
        plan = pa.attend_plan(*plan_args)

        def call(args=args, kw=kw):
            return pa.attend_protected(*args, **kw)

        got = call()
        want = pa.attend_protected_plain(*args, **kw)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if bool((diff > smoke.ULP_ATOL
                 + smoke.ULP_RTOL * want.float().abs()).any()):
            ok = False
        out[case] = {
            "shape": shape, "ref_pages": kw.get("ref_pages"),
            "plan": list(plan), "ranges": plan[-1],
            "device_ms": smoke.device_ms(call, "attend_", 20),
            "ms": smoke.cuda_ms(call, 20), "max_abs_err": err}
    print(f"ATTEND {label} {json.dumps(out)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
