"""repro_torch.analysis — the runtime sanitizer (`use_sanitizer`): eager
checks on the GF and attention entry points that turn silent arithmetic
corruption into `SanitizerError`. The JAX package's static lint rules
(`repro.analysis`'s RPL rules) target JAX idioms and are not ported."""
from .sanitizer import (SanitizerError, check_finite, check_gf_symbols,
                        check_quant_scales, sanitizer_enabled, use_sanitizer)

__all__ = ["use_sanitizer", "sanitizer_enabled", "check_gf_symbols",
           "check_finite", "check_quant_scales", "SanitizerError"]
