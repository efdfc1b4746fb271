"""Protected-memory subsystem: the paper's *memory mode* in PyTorch.

- `channel`    — composable MLC memristor channel models driven by
                 explicit `torch.Generator`s;
- `array`      — `ProtectedMemoryArray`: tensors packed into GF(p)
                 codewords on write, held as int8 cells on the device,
                 decoded on read;
- `controller` — controller policies (basic / writeback / scrub) with
                 per-policy stats;
- `repair`     — `RepairQueue`: cross-page flagged-row batching;
- `paged`      — `PagedProtectedStore`: fixed-shape pages on the device
                 with scan-gated corrected reads (the protected KV cache's
                 store), and the float <-> GF quantization bridge;
- `pool`       — `ProtectedPagePool` / `PooledStore`: a shared page pool
                 with block tables, copy-on-write and per-owner scrubs
                 (the multi-tenant serving engine's storage);
- `packing`    — the byte <-> GF(p) symbolization;
- `campaign`   — the semi-analytic BER campaign: NB-LDPC against Hamming
                 SECDED, a modulo checksum and no code (the paper's
                 post-decode BER comparison).
"""
from .array import ProtectedMemoryArray, StoredTensor
from .campaign import (HammingSECDEDScheme, ModuloParityScheme,
                       NBLDPCScheme, ResidualProfile, UnprotectedScheme,
                       binom_pmf, conditional_residual_profile,
                       default_max_errors, mix_post_ber, paper_schemes,
                       post_ber_from_profile, run_campaign,
                       select_acceptance_row)
from .channel import (Channel, Compose, LevelTransition, PlusMinusOne,
                      ReadDisturb, RetentionDrift, StuckAt,
                      asymmetric_adjacent, uniform_flip, validate_transition)
from .controller import (ControllerStats, MemoryController, ScrubController,
                         WritebackController, make_controller)
from .packing import desymbolize_u8, digits_per_byte, symbolize_u8
from .paged import (PagedProtectedStore, QuantizedTensor, dequantize_tensor,
                    quantize_tensor, words_for_tensor)
from .pool import PooledStore, PoolExhausted, ProtectedPagePool
from .repair import RepairQueue

__all__ = [
    "ProtectedMemoryArray", "StoredTensor",
    "Channel", "Compose", "LevelTransition", "PlusMinusOne", "ReadDisturb",
    "RetentionDrift", "StuckAt", "asymmetric_adjacent", "uniform_flip",
    "validate_transition",
    "ControllerStats", "MemoryController", "ScrubController",
    "WritebackController", "make_controller",
    "desymbolize_u8", "digits_per_byte", "symbolize_u8",
    "PagedProtectedStore", "QuantizedTensor", "dequantize_tensor",
    "quantize_tensor", "words_for_tensor",
    "PoolExhausted", "PooledStore", "ProtectedPagePool",
    "RepairQueue",
    "ResidualProfile", "NBLDPCScheme", "HammingSECDEDScheme",
    "ModuloParityScheme", "UnprotectedScheme", "binom_pmf", "mix_post_ber",
    "default_max_errors", "conditional_residual_profile",
    "post_ber_from_profile", "run_campaign", "paper_schemes",
    "select_acceptance_row",
]
