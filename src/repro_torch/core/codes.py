"""Registry of standard NB-LDPC code configurations, the same as the JAX
package's `repro.core.codes.REGISTRY` (same names, same parameters, so the
same codes).

Mirrors the paper's evaluated design points:
  - prototype chip: word length 256, code rate 0.8, GF(3)  (paper §5, §6.2)
  - Fig 6(a): word lengths 32..1024 at rate 0.8
  - Fig 6(b): word length 512 at rates 0.33..0.8
  - max-rate point: word length 1024 at rate 0.88 (paper abstract / §6.3)
"""
from __future__ import annotations

import functools

from .construction import LDPCCode, build_code

# name -> (n, k, p, dv)
REGISTRY = {
    "chip256_r08": (256, 205, 3, 3),      # silicon prototype point
    "wl32_r08": (32, 26, 3, 3),
    "wl64_r08": (64, 51, 3, 3),
    "wl128_r08": (128, 102, 3, 3),
    "wl256_r08": (256, 205, 3, 3),
    "wl512_r08": (512, 410, 3, 3),
    "wl1024_r08": (1024, 819, 3, 3),
    "wl1024_r088": (1024, 902, 3, 3),     # >88% code rate headline point
    "wl512_r033": (512, 169, 3, 3),
    "wl512_r05": (512, 256, 3, 3),
    "wl512_r067": (512, 343, 3, 3),
    # small codes for model-layer protection & tests (keep per-layer padding low)
    "wl40_r08": (40, 32, 3, 3),
    "wl80_r08": (80, 64, 3, 3),
    "wl160_r08": (160, 128, 3, 3),
    "wl320_r08": (320, 256, 3, 3),
    # multi-level-cell variants (paper §3.3: MLC support via larger GF(p))
    "wl160_r08_gf5": (160, 128, 5, 3),
    "wl160_r08_gf7": (160, 128, 7, 3),
}


@functools.lru_cache(maxsize=64)
def get_code(name: str, seed: int = 0) -> LDPCCode:
    if name not in REGISTRY:
        raise KeyError(f"unknown code {name!r}; available: {sorted(REGISTRY)}")
    n, k, p, dv = REGISTRY[name]
    return build_code(n, k, p=p, dv=dv, seed=seed)
