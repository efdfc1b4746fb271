"""Multi-tenant protected serving: continuous batching over a shared
NB-LDPC-protected page pool (`repro_torch.serving.engine`)."""
from .engine import (BatchedDenseKV, BatchedPagedKV, EngineCaches,
                     SequenceState, ServingEngine)

__all__ = ["BatchedDenseKV", "BatchedPagedKV", "EngineCaches",
           "SequenceState", "ServingEngine"]
