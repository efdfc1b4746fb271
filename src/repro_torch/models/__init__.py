"""The model stacks of every config and their protected KV-cache serving
path."""
from .kv import (ProtectedKVCaches, ProtectedKVConfig, ProtectedKVLayer,
                 protected_overhead)
from .lm import (LM, decode_step, encode_params_for_pim, forward,
                 init_caches, init_params, loss_fn, prefill)

__all__ = ["ProtectedKVCaches", "ProtectedKVConfig", "ProtectedKVLayer",
           "protected_overhead", "LM", "decode_step", "encode_params_for_pim",
           "forward", "init_caches", "init_params", "loss_fn", "prefill"]
