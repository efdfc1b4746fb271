"""`ProtectedMemoryArray`: NB-LDPC-protected tensor storage (memory mode).

Arbitrary tensors are packed into GF(p) codewords on write — bytes are
symbolized as base-p digits (6 trits/byte for GF(3), see `packing`) and
encoded with the array's systematic code — and decoded on read under a
pluggable controller policy (`controller`). Device faults are injected
through the `channel` models, never by hand-editing stored words.

The stored cells of every tensor are one (n_words, n) int8 tensor (a
wider `symbol_dtype(p)` for GF(p) past int8) on the array's device (the
card by default), so the write encode (the gf_matmul kernel), the read
and scrub scans (the scan kernel) and the decodes of flagged words (FBP)
all run where the cells are; only the bytes a read returns cross to the
host.

    mem = ProtectedMemoryArray("wl1024_r08", controller="writeback")
    mem.write("kv", kv_cache)
    mem.inject(asymmetric_adjacent(3, 1e-3, 5e-4), key=0)
    kv = mem.read("kv")                   # corrected transparently
    mem.controller.stats.corrected        # accounting per policy
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.codes import get_code
from ..core.construction import LDPCCode
from ..core.encode import encode_words
from ..core.gf import symbol_dtype
from ..device import generator, resolve_device
from .channel import Channel
from .controller import MemoryController, make_controller
from .packing import desymbolize_u8, digits_per_byte, symbolize_u8

__all__ = ["ProtectedMemoryArray", "StoredTensor"]


@dataclasses.dataclass
class StoredTensor:
    """One tensor's protected representation: (n_words, n) cell levels."""

    enc: torch.Tensor              # (n_words, n) levels in [0, p), int8
                                   # while p <= 128
    dtype: str                     # numpy dtype name of the stored tensor
    shape: tuple
    nbytes: int


def _raw_bytes(array, device: torch.device):
    """A tensor or array -> (flat uint8 tensor on `device`, numpy dtype
    name, shape)."""
    if isinstance(array, torch.Tensor):
        t = array.detach()
        dtype = np.dtype(str(t.dtype).removeprefix("torch.")).name
        raw = t.contiguous().reshape(-1).view(torch.uint8).to(device)
        return raw, dtype, tuple(t.shape)
    arr = np.asarray(array)          # a 0-d array keeps its shape ()
    flat = np.ascontiguousarray(arr).reshape(-1)
    raw = torch.from_numpy(flat.view(np.uint8).copy())
    return raw.to(device), arr.dtype.name, arr.shape


class ProtectedMemoryArray:
    """A named store of tensors held as NB-LDPC codewords of one code."""

    def __init__(self, code: str | LDPCCode = "wl1024_r08", *,
                 controller: str | MemoryController | None = "basic",
                 channel: Channel | None = None, key: int = 0, device=None,
                 **ctrl_kw):
        self.device = resolve_device(device)
        self.code = get_code(code) if isinstance(code, str) else code
        if isinstance(controller, MemoryController):
            self.controller = controller
        else:
            self.controller = make_controller(controller, device=self.device,
                                              **ctrl_kw)
        self.channel = channel
        self._store: dict[str, StoredTensor] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(key)

    # -- introspection ------------------------------------------------------

    @property
    def names(self):
        return sorted(self._store)

    @property
    def stats(self):
        return self.controller.stats

    def stored(self, name: str) -> StoredTensor:
        return self._store[name]

    def import_stored(self, name: str, st: StoredTensor) -> None:
        """Adopt an externally persisted protected tensor (numpy levels or
        a tensor) without re-encoding."""
        enc = torch.as_tensor(np.asarray(st.enc) if not isinstance(
            st.enc, torch.Tensor) else st.enc)
        self._store[name] = StoredTensor(
            enc.to(device=self.device,
                   dtype=symbol_dtype(self.code.p)).contiguous(),
            str(st.dtype), tuple(st.shape), int(st.nbytes))

    def discard(self, name: str) -> None:
        """Drop a tensor's stored codewords (streaming save/restore keeps
        one leaf resident at a time instead of the whole checkpoint)."""
        self._store.pop(name, None)

    # -- write / read -------------------------------------------------------

    def write(self, name: str, array) -> StoredTensor:
        """Store a numpy array or a tensor: symbolize its bytes, encode on
        the array's device."""
        raw, dtype, shape = _raw_bytes(array, self.device)
        code = self.code
        syms = symbolize_u8(raw, code.p).reshape(-1)
        words = F.pad(syms, (0, (-syms.numel()) % code.k)).reshape(-1, code.k)
        enc = encode_words(words, code)
        st = StoredTensor(enc, dtype, shape, int(raw.numel()))
        self._store[name] = st
        self.controller.note_write(enc.shape[0])
        self.controller.tick(code, self._store)
        return st

    def read(self, name: str, *, correct: bool = True) -> np.ndarray:
        """The stored tensor as a numpy array, corrected by the controller
        (or as stored, with `correct=False`)."""
        st = self._store[name]
        if correct:
            levels = self.controller.read(self.code, self._store, name)
        else:
            levels = torch.remainder(st.enc, self.code.p)
        D = digits_per_byte(self.code.p)
        digits = levels[:, :self.code.k].reshape(-1)[:st.nbytes * D]
        raw = desymbolize_u8(digits.reshape(-1, D), self.code.p)
        out = raw.cpu().numpy().view(np.dtype(st.dtype)).reshape(st.shape)
        self.controller.tick(self.code, self._store)
        return out

    # -- fault injection / maintenance --------------------------------------

    def inject(self, channel: Channel | None = None,
               key: int | torch.Generator | None = None, *, t: float = 0.0,
               n_reads: int = 0) -> int:
        """Corrupt the stored words in place through a channel model. `key`
        is a seed or a generator on the array's device; without one the
        array's own generator is drawn on, so repeated injections
        accumulate (aging). Returns the number of cells changed."""
        ch = channel if channel is not None else self.channel
        if ch is None:
            raise ValueError("no channel: pass one or construct the array "
                             "with channel=...")
        if ch.p != self.code.p:
            raise ValueError(f"channel alphabet {ch.p} != GF({self.code.p})")
        gen = generator(key, self._gen, self.device)
        changed = torch.zeros((), dtype=torch.int64, device=self.device)
        for name in self.names:
            st = self._store[name]
            new = ch.apply(gen, st.enc, t=t, n_reads=n_reads).to(
                st.enc.dtype)
            changed += (new != st.enc).sum()
            st.enc = new
        return int(changed)

    def iter_pages(self, page_words: int | None = None):
        """Writable (b, n) pages over the stored words (`page_words` rows
        per page; one page per tensor when None)."""
        return self.controller.iter_pages(self._store, page_words)

    def scrub(self, *, page_words: int | None = None, **kw) -> dict:
        """Explicit full sweep (any policy): scan + repair storage.
        `page_words` streams the sweep in fixed-size pages; other keywords
        (`scan_ahead=`, `drain_words=`) reach
        `MemoryController.scrub_pages`."""
        return self.controller.scrub(self.code, self._store,
                                     page_words=page_words, **kw)

    def scrub_pages(self, pages, **kw) -> dict:
        """Sweep an explicit page iterator (see `iter_pages`) through this
        array's code and controller."""
        return self.controller.scrub_pages(self.code, pages, **kw)
