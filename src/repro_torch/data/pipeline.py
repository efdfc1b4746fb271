"""Deterministic, shard-aware, resumable synthetic token pipeline.

The port's own copy of the JAX package's `data/pipeline.py` (numpy only,
no framework), so both packages draw bit-identical batches.

Production framing: every data-parallel host pulls *its* slice of the global
batch, derived purely from (seed, step, shard_index) — so (a) any host can be
restarted at any step with zero coordination, (b) elastic re-sharding (resume
on a different data-parallel degree) re-partitions the same global stream,
and (c) the pipeline state is one integer (the step), which the checkpoint
manifest records.

The synthetic stream is a Zipf-weighted order-2 Markov chain over the vocab —
enough structure that the end-to-end training example shows a real loss curve
(a pure-uniform stream would bottom out at log V immediately).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # Zipf exponent for unigram skew
    markov_states: int = 64      # order-2 chain folded into this many states


class TokenPipeline:
    """Iterator of {tokens, labels} with exact-resume semantics."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1, step: int = 0):
        assert cfg.global_batch % num_shards == 0, \
            f"global_batch {cfg.global_batch} % shards {num_shards} != 0"
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.step = step
        self._build_chain()

    def _build_chain(self):
        c = self.cfg
        rng = np.random.default_rng(c.seed)
        V, S = c.vocab_size, c.markov_states
        # Zipf unigram over vocab; per-state sparse next-token preferences
        ranks = np.arange(1, V + 1, dtype=np.float64)
        uni = ranks ** (-c.zipf_a)
        self._uni = uni / uni.sum()
        self._state_shift = rng.integers(0, V, size=S)   # state-dep. rotation
        self._mix = 0.5                                   # chain vs unigram

    def _sample_batch(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        bs = c.global_batch // self.num_shards
        # key derived from (seed, step, shard): restart-stable, shard-disjoint
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, self.shard_index]))
        V = c.vocab_size
        toks = np.empty((bs, c.seq_len + 1), np.int64)
        toks[:, 0] = rng.choice(V, size=bs, p=self._uni)
        u = rng.random((bs, c.seq_len))
        fresh = rng.choice(V, size=(bs, c.seq_len), p=self._uni)
        for t in range(1, c.seq_len + 1):
            state = toks[:, t - 1] % self._state_shift.size
            chained = (toks[:, t - 1] + self._state_shift[state]) % V
            toks[:, t] = np.where(u[:, t - 1] < self._mix,
                                  chained, fresh[:, t - 1])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        batch = self._sample_batch(self.step)
        self.step += 1
        return batch

    # -- resume protocol ----------------------------------------------------

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, shard_index: int = 0,
                num_shards: int = 1) -> "TokenPipeline":
        assert state["seed"] == cfg.seed, "resuming with a different data seed"
        return cls(cfg, shard_index, num_shards, step=state["step"])
