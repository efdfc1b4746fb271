"""Neural-network layers of the model stacks: norms, rotary embeddings,
the gated MLP, GQA attention (self, cross, the encoder's bidirectional)
over a dense cache or a `KVSource`, the MoE FFN (`moe`), the mamba block
(`mamba`) and `Block`, one layer of any kind."""
from .kv_source import KVSource
from .layers import (CDT, MLP, Attention, Block, RMSNorm, attend_paged,
                     rope)
from .mamba import Mamba, MambaState
from .moe import MoE

__all__ = ["KVSource", "CDT", "MLP", "Attention", "Block", "RMSNorm",
           "attend_paged", "rope", "Mamba", "MambaState", "MoE"]
