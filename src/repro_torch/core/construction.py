"""NB-LDPC code construction.

Progressive Edge Growth (PEG) construction of a sparse check matrix H_C over
GF(p) (paper cites PEG [26] / PCEG [11]), followed by derivation of a systematic
generator G = [I | P] with G · H_Cᵀ = 0 (paper Eq. 2).

The returned `LDPCCode` carries both the dense matrices (encode / syndrome) and
padded edge arrays + GF-permutation gather tables consumed by the vectorized
decoder (`repro_torch.core.decode`) and the CUDA kernels
(`repro_torch.kernels`). Construction is numpy and gives the same arrays as
the JAX package's `repro.core.construction` for the same parameters; the
code object also caches its arrays as torch tensors per device.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque

import numpy as np
import torch

from . import gf

__all__ = ["LDPCCode", "peg_construct", "build_code"]


@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """A systematic NB-LDPC code over GF(p).

    Layout: codeword = [k info symbols | n-k check symbols].
    """
    p: int
    n: int                     # codeword length (symbols); paper's word length l
    k: int                     # info symbols; paper's m
    H: np.ndarray              # (c, n) check matrix, c = n - k (systematic col order)
    G: np.ndarray              # (k, n) generator [I_k | P]
    P: np.ndarray              # (k, c) check-symbol generator
    # CN-centric padded edge arrays (decoder):
    cn_vns: np.ndarray         # (c, dc_max) int32 vn index, -1 padding
    cn_coefs: np.ndarray       # (c, dc_max) int32 edge coefficient, 1 padding
    cn_mask: np.ndarray        # (c, dc_max) bool, True = real edge
    perm_to_contrib: np.ndarray  # (c, dc_max, p) int32 gather idx: msg_hat[k]=msg[idx[...,k]]
    perm_to_sym: np.ndarray      # (c, dc_max, p) int32 gather idx back to symbol space
    dv: int                    # nominal VN degree
    dc_max: int
    _tensors: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    @property
    def c(self) -> int:
        return self.n - self.k

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def n_edges(self) -> int:
        return int(self.cn_mask.sum())

    @functools.cached_property
    def vn_edges(self) -> np.ndarray:
        """VN-centric gather table: for each VN, the flat edge ids
        (cn*dc_max + slot) of its incident edges, padded with `c*dc_max`
        (a dedicated zero row), so the VN total is a gather and a sum."""
        c, dc = self.cn_vns.shape
        deg = np.zeros(self.n, dtype=np.int64)
        np.add.at(deg, self.cn_vns[self.cn_mask], 1)
        dv_max = int(deg.max()) if self.n else 0
        table = np.full((self.n, dv_max), c * dc, dtype=np.int64)
        fill = np.zeros(self.n, dtype=np.int64)
        for ci, s in zip(*np.nonzero(self.cn_mask), strict=True):
            v = self.cn_vns[ci, s]
            table[v, fill[v]] = ci * dc + s
            fill[v] += 1
        return table

    def tensor(self, name: str, device, dtype=None) -> torch.Tensor:
        """The array `name` (a field such as "H" or "P", "vn_edges", or a
        transpose such as "H.T") as a contiguous tensor on `device`, built
        once per (name, device, dtype). An integer `dtype` that cannot hold
        every entry (GF(257)'s H in int8) raises instead of wrapping."""
        device = torch.device(device)
        key = (name, str(device), dtype)
        t = self._tensors.get(key)
        if t is None:
            arr = (getattr(self, name[:-2]).T if name.endswith(".T")
                   else getattr(self, name))
            if (dtype is not None and arr.size and not dtype.is_floating_point
                    and dtype != torch.bool):
                info = torch.iinfo(dtype)
                if arr.min() < info.min or arr.max() > info.max:
                    raise ValueError(
                        f"{name} of GF({self.p}) has entries in "
                        f"[{arr.min()}, {arr.max()}], outside {dtype}")
            t = torch.as_tensor(np.ascontiguousarray(arr), device=device)
            if dtype is not None:
                t = t.to(dtype)
            self._tensors[key] = t
        return t


def peg_construct(n: int, c: int, dv: int, p: int, seed: int = 0) -> np.ndarray:
    """Progressive Edge Growth: build a (c, n) sparse parity matrix over GF(p).

    For each VN (in order) place `dv` edges; each edge goes to the check node
    that is farthest from the VN in the current Tanner graph (maximizing local
    girth), breaking ties by lowest CN degree then randomly.
    """
    rng = np.random.default_rng(seed)
    # adjacency: vn -> set of cns, cn -> set of vns
    vn_adj = [[] for _ in range(n)]
    cn_adj = [[] for _ in range(c)]
    cn_deg = np.zeros(c, dtype=np.int64)

    def bfs_cn_distances(root_vn: int) -> np.ndarray:
        """Distance (in edges/2) from root VN to every CN; -1 = unreachable."""
        dist = np.full(c, -1, dtype=np.int64)
        seen_vn = np.zeros(n, dtype=bool)
        seen_vn[root_vn] = True
        frontier = deque([root_vn])
        depth = 0
        while frontier:
            depth += 1
            nxt = deque()
            for v in frontier:
                for cc in vn_adj[v]:
                    if dist[cc] == -1:
                        dist[cc] = depth
                        for v2 in cn_adj[cc]:
                            if not seen_vn[v2]:
                                seen_vn[v2] = True
                                nxt.append(v2)
            frontier = nxt
        return dist

    H = np.zeros((c, n), dtype=np.int64)
    nonzero = np.arange(1, p)
    for v in range(n):
        for e in range(dv):
            if e == 0 and not vn_adj[v]:
                cand = np.flatnonzero(cn_deg == cn_deg.min())
            else:
                dist = bfs_cn_distances(v)
                unreachable = np.flatnonzero(dist == -1)
                if unreachable.size:
                    cand = unreachable
                else:
                    far = dist.max()
                    cand = np.flatnonzero(dist == far)
                # exclude CNs already connected to v (parallel edges illegal)
                cand = np.array([cc for cc in cand if cc not in vn_adj[v]],
                                dtype=np.int64)
                if cand.size == 0:   # fully connected corner case
                    cand = np.array([cc for cc in range(c) if cc not in vn_adj[v]],
                                    dtype=np.int64)
            mindeg = cn_deg[cand].min()
            cand = cand[cn_deg[cand] == mindeg]
            cc = int(rng.choice(cand))
            vn_adj[v].append(cc)
            cn_adj[cc].append(v)
            cn_deg[cc] += 1
            H[cc, v] = int(rng.choice(nonzero))
    return H


def _systematize(H: np.ndarray, p: int, rng: np.random.Generator):
    """Column-permute H so its last c columns are invertible; return
    (H_sys, perm) with H_sys = H[:, perm]."""
    c, n = H.shape
    rref, piv = gf.gf_rref(H, p)
    if len(piv) < c:
        raise np.linalg.LinAlgError("H is rank deficient")
    piv = list(piv)
    info = [j for j in range(n) if j not in set(piv)]
    perm = np.array(info + piv, dtype=np.int64)
    return H[:, perm] % p, perm


@functools.lru_cache(maxsize=64)
def build_code(n: int, k: int, p: int = 3, dv: int = 3, seed: int = 0) -> LDPCCode:
    """Construct a systematic NB-LDPC code: PEG graph + random GF coefficients.

    Retries with fresh coefficient draws if H comes out rank-deficient.
    """
    assert gf.is_prime(p), f"p must be prime, got {p}"
    assert 0 < k < n
    c = n - k
    rng = np.random.default_rng(seed ^ 0x5EED)
    H = None
    for attempt in range(8):
        Hc = peg_construct(n, c, dv, p, seed=seed + 1000 * attempt)
        if gf.gf_rank(Hc, p) == c:
            H = Hc
            break
    if H is None:
        raise RuntimeError(f"PEG failed to produce full-rank H for n={n},k={k},p={p}")

    H_sys, _ = _systematize(H, p, rng)
    A, B = H_sys[:, :k], H_sys[:, k:]
    Binv = gf.gf_mat_inv(B, p)
    # H [w | r]^T = 0  =>  r = -B^{-1} A w
    P = ((-(gf.gf_matmul_np(Binv, A, p)) % p).T) % p      # (k, c)
    G = np.concatenate([np.eye(k, dtype=np.int64), P], axis=1) % p
    assert not (gf.gf_matmul_np(G, H_sys.T, p)).any(), "G.H^T != 0"

    # ---- CN-centric edge arrays -------------------------------------------
    dc_all = (H_sys != 0).sum(axis=1)
    dc_max = int(dc_all.max())
    cn_vns = np.full((c, dc_max), -1, dtype=np.int32)
    cn_coefs = np.ones((c, dc_max), dtype=np.int32)
    cn_mask = np.zeros((c, dc_max), dtype=bool)
    for i in range(c):
        vns = np.flatnonzero(H_sys[i])
        cn_vns[i, :vns.size] = vns
        cn_coefs[i, :vns.size] = H_sys[i, vns]
        cn_mask[i, :vns.size] = True

    # GF-axis permutation gather tables (paper Eq. 6).
    # to contribution space: msg_hat[j] = msg[(h^{-1} j) % p]
    # back to symbol space:  msg[k]     = L''[(h k) % p]
    invs = gf.inv_table(p)
    ks = np.arange(p, dtype=np.int64)
    hinv = invs[cn_coefs % p].astype(np.int64)            # (c, dc_max)
    perm_to_contrib = ((hinv[..., None] * ks) % p).astype(np.int32)
    perm_to_sym = ((cn_coefs[..., None].astype(np.int64) * ks) % p).astype(np.int32)

    return LDPCCode(
        p=p, n=n, k=k, H=H_sys % p, G=G, P=P,
        cn_vns=cn_vns, cn_coefs=cn_coefs, cn_mask=cn_mask,
        perm_to_contrib=perm_to_contrib, perm_to_sym=perm_to_sym,
        dv=dv, dc_max=dc_max,
    )
