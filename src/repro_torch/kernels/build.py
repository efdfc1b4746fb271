"""Build and load the port's CUDA kernels.

Every `.cu` under `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`) into
one shared library with a plain C interface, which is loaded with ctypes
(no PyTorch headers, so a build takes seconds, not minutes). The sources
are compiled in parallel, one `nvcc` each, then linked. The library lands
in `_build/` beside this file (git-ignored), named by a hash of the sources
and flags, so an edited source is rebuilt at its next use and an unchanged
one is loaded as it is.

Each C entry point takes raw device pointers, sizes and a `cudaStream_t`
(PyTorch's current stream) and returns `cudaGetLastError()`; `launch`
calls one with its operands' device current and raises on anything but
0. `LAUNCHES` counts kernel launches per kernel
name: a wrapper adds one where it launches its kernel, and nowhere else.
`at_position` tags the launches a thread enqueues with a mesh position,
and `by_position` collects them (and the flash calls' head counts,
`note_heads`) by position: how a tensor-parallel step reports each
(data, model) position's launches.
The wrappers' shared operand helpers (`route`, `exact_matmul`,
`int8_operand`) live here too.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes (pointers and the stream as c_void_p, so ctypes
# never cuts a 64-bit address to a 32-bit int)
SIGNATURES = {
    "rt_gf_matmul": [_P, _P, _P] + [_I] * 7 + [_P],
    "rt_scan_syndromes": [_P, _P, _P] + [_I] * 6 + [_P],
    "rt_pim_mac": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rt_fbp_cn": [_P, _P, _I, _I, _I, _I, _P],
    "rt_attend_protected": [_P] * 11 + [_I] * 17 + [_F, _P],
    "rt_flash_fwd": [_P] * 5 + [_I] * 7 + [_F, _F, _P],
    "rt_flash_bwd_dq": [_P] * 7 + [_I] * 7 + [_F, _F, _P],
    "rt_flash_bwd_dkv": [_P] * 8 + [_I] * 7 + [_F, _F, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None
# nvcc's output per source of the last build made with verbose=True (with
# -Xptxas -v: each kernel's registers, spills and static shared memory)
build_logs: dict[str, str] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


_POSITION = threading.local()
_LOGS: list = []
_count_lock = threading.Lock()     # autograd's device threads count too


@contextlib.contextmanager
def at_position(pos):
    """Tag the launches this thread makes inside with mesh position `pos`
    (a tuple; None clears the tag)."""
    prev = getattr(_POSITION, "pos", None)
    _POSITION.pos = pos
    try:
        yield
    finally:
        _POSITION.pos = prev


def current_position():
    return getattr(_POSITION, "pos", None)


class PositionLog:
    """`launches[pos]`: a Counter of the launches tagged `pos`;
    `heads[pos]`: the (kernel, query heads, KV heads) of the flash calls
    made at `pos` (on any device: the CPU's plain calls too)."""

    def __init__(self):
        self.launches = collections.defaultdict(collections.Counter)
        self.heads = collections.defaultdict(set)


@contextlib.contextmanager
def by_position():
    """A `PositionLog` of what is tagged while the block runs (in any
    thread: autograd's backward threads tag theirs too)."""
    log = PositionLog()
    with _count_lock:
        _LOGS.append(log)
    try:
        yield log
    finally:
        with _count_lock:
            _LOGS.remove(log)


def note_heads(name: str, hq: int, hkv: int) -> None:
    """Record a flash call's head counts at the current position."""
    pos = current_position()
    if pos is not None:
        with _count_lock:
            for log in _LOGS:
                log.heads[pos].add((name, hq, hkv))


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, verbose: bool) -> None:
    """nvcc every .cu in parallel into `out`'s directory, then link."""
    nvcc = _nvcc()
    work = out.parent
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _obj, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            build_logs[src.name] = log
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
         *(str(o) for _s, o, _p in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built from the sources on first use."""
    global _lib, build_seconds
    if _lib is not None:               # every launch asks: skip the lock
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                out = Path(tmp) / target.name
                _compile(out, verbose)
                os.replace(out, target)      # atomic: racing builds agree
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def launch(name: str, entry: str, device, *args) -> None:
    """Call the C entry point `entry` with `args` and PyTorch's current
    `cudaStream_t` on `device` (a CUDA device or its index), with `device`
    the CUDA runtime's current device: the C side launches, and sets
    shared-memory attributes, on the current device, so an operand on
    another card would otherwise get that card's stream refused. The
    caller's current device is restored; the switch is skipped when
    `device` is already current. Raises when the launch fails, else adds
    one to `LAUNCHES[name]`. The raw stream query (as Triton's launcher
    makes it) costs about a microsecond, where building a
    `torch.cuda.Stream` object costs about ten."""
    index = device if isinstance(device, int) else device.index
    fn = getattr(library(), entry)
    prev = torch._C._cuda_getDevice()
    if prev == index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        torch.cuda.set_device(index)
        try:
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        finally:
            torch.cuda.set_device(prev)
    check(err, name)
    pos = current_position()
    with _count_lock:
        LAUNCHES[name] += 1
        if pos is not None:
            for log in _LOGS:
                log.launches[pos][name] += 1


@functools.cache
def sm_count(device) -> int:
    """The SMs of a CUDA device (a device or a CUDA device index): the grid
    a persistent kernel fills, asked of each device once (every launch of
    a persistent kernel reads it)."""
    index = device if isinstance(device, int) else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route(name: str, *tensors) -> str:
    """"cpu" when every operand lies on the CPU (the plain version runs),
    "cuda" when every operand lies on one CUDA device (the kernel runs);
    anything else raises, so nothing falls back from kernel to plain."""
    index = tensors[0].get_device()
    if tensors[0].is_cuda and all(t.is_cuda and t.get_device() == index
                                  for t in tensors):
        return "cuda"                  # the launches' path, kept short
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device type {kind!r}")
    return kind


def exact_matmul(a, b, bound: int):
    """Integer product a @ b (any leading batch dims) without an integer
    matmul, which CUDA lacks: float32 is exact while every partial sum is
    below 2^24 (`bound` is a cap on |sum|), else int64 on the CPU and
    float64 (exact below 2^53) on the card. TF32 is off for the product,
    so the float32 one is a true float32 product; the caller's TF32
    setting is restored after it. Returns int64."""
    if bound < 2 ** 24:
        dtype = torch.float32
    elif a.device.type == "cpu":
        return a.to(torch.int64) @ b.to(torch.int64)
    else:
        if bound >= 2 ** 53:
            raise ValueError(f"integer product bound {bound} >= 2^53")
        dtype = torch.float64
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (a.to(dtype) @ b.to(dtype)).to(torch.int64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# the largest field whose symbols, [0, p), an int8 operand holds
INT8_FIELD_MAX = 128


def int8_operand(x, p: int | None = None):
    """A contiguous int8 view of an integer operand. With `p` the operand
    holds GF(p) symbols: a field past INT8_FIELD_MAX raises (its symbols
    would wrap in int8), and other dtypes are reduced mod p first (floored,
    so negatives land in [0, p)), which leaves every mod-p result
    unchanged. Without `p` the operand must already be int8."""
    if p is not None and p > INT8_FIELD_MAX:
        raise ValueError(f"GF({p}) symbols do not fit int8 (p > "
                         f"{INT8_FIELD_MAX}): the int8 kernels cannot take "
                         f"them; route the product to exact_matmul")
    if x.dtype == torch.int8:
        return x.contiguous()
    if p is None:
        raise TypeError(f"kernel operand must be int8, got {x.dtype}")
    if x.is_floating_point() or x.dtype == torch.bool:
        raise TypeError(f"kernel operand must be an integer, got {x.dtype}")
    return torch.remainder(x, p).to(torch.int8).contiguous()
