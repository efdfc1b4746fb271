"""KVSource — the decode-time KV provider protocol behind
`Attention.forward`.

Anything that can append a step's K/V and be attended over implements
`KVSource`, and attention dispatches on `isinstance` (a plain
{"k", "v"} dict is the dense decode cache). In this package:
`repro_torch.models.kv.ProtectedKVLayer` (kind "protected"), whose
`attend` takes the fused `attend_protected` kernel and keeps `pages()`
as the streaming reference read.

The default `attend` streams `pages()` through the page-granular online
softmax (`repro_torch.nn.layers.attend_paged`), so a minimal source only
provides `append` and `pages`. That default is a plain read and takes CPU
tensors only; a source that serves on the card overrides `attend` with a
kernel.
"""
from __future__ import annotations

import abc


class KVSource(abc.ABC):
    """A decode-time KV provider attention can attend over."""

    #: coarse provenance tag ("dense" | "protected")
    kind: str = "dense"

    @abc.abstractmethod
    def append(self, k, v) -> None:
        """Ingest one step's (B, t, Hkv, D) K/V (RoPE already applied)."""

    @abc.abstractmethod
    def pages(self):
        """Yield (k_page (B, T, Hkv, D), v_page, valid_tokens) steps for
        the streaming online softmax."""

    def attend(self, q, softcap=0.0):
        """(B, Sq, Hq, D) query block -> attention output over this
        source's K/V: the default streams `pages()` through the
        page-granular online softmax; fused sources override it."""
        from .layers import attend_paged
        return attend_paged(q, self.pages(), softcap)
