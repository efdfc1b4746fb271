"""Neural-network layers of the dense attention-only model (the protected
KV-cache serving path): norms, rotary embeddings, the gated MLP, GQA
attention over a dense cache or a `KVSource`."""
from .kv_source import KVSource
from .layers import (CDT, MLP, Attention, Block, RMSNorm, attend_paged,
                     rope)

__all__ = ["KVSource", "CDT", "MLP", "Attention", "Block", "RMSNorm",
           "attend_paged", "rope"]
