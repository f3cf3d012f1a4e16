"""The native runtime (counterpart of mfa_tpu/utils/native.py): ctypes over
mfa_tpu_torch/csrc/runtime.cpp, the scheduler's host bookkeeping in C++
(page allocation, admission, block-table packing, cu_seqlens) behind a
plain C ABI with no CUDA.

load() builds it at first use with g++ (-O2 -std=c++17 -fPIC -shared)
into mfa_tpu_torch/_build/<key>/, where the key hashes the source, the
compiler and the flags, so a changed source never loads a stale library.
The library is written to a temporary file and moved into place, so
processes that build at once never load a half-written file. nvcc never
sees this source (kernels/_build.py builds the .cu files only).

Unlike mfa_tpu's, nothing here falls back to Python: a library that cannot
be built or loaded raises RuntimeError. The scheduler (serve/scheduler.py)
allocates and admits through NativeAllocator and admit; pack_block_table
and cu_seqlens are the rest of mfa_tpu's public surface.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "runtime.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
# seconds the last build took; 0.0 when the library was built before, None
# until load() has run
build_seconds: Optional[float] = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.mfa_alloc_create.restype = ctypes.c_void_p
    lib.mfa_alloc_create.argtypes = [ctypes.c_int32]
    lib.mfa_alloc_destroy.restype = None
    lib.mfa_alloc_destroy.argtypes = [ctypes.c_void_p]
    lib.mfa_alloc_free_count.restype = ctypes.c_int32
    lib.mfa_alloc_free_count.argtypes = [ctypes.c_void_p]
    lib.mfa_alloc_pages.restype = ctypes.c_int32
    lib.mfa_alloc_pages.argtypes = [ctypes.c_void_p, ctypes.c_int32, i32p]
    lib.mfa_free_pages.restype = None
    lib.mfa_free_pages.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32]
    lib.mfa_admit.restype = ctypes.c_int32
    lib.mfa_admit.argtypes = [i32p, ctypes.c_int32, ctypes.c_int32,
                              ctypes.c_int32, ctypes.c_int32, i32p]
    lib.mfa_pack_block_table.restype = None
    lib.mfa_pack_block_table.argtypes = [i32p, i32p, ctypes.c_int32,
                                         ctypes.c_int32, i32p]
    lib.mfa_cu_seqlens.restype = None
    lib.mfa_cu_seqlens.argtypes = [i32p, ctypes.c_int32, i32p]
    return lib


def _build_key() -> str:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def _build(so: str) -> None:
    """Compile SOURCE into `so` through a temporary file; raise with the
    compiler's output on failure."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        res = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native runtime: cannot run {CXX}: {e}") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native runtime: {CXX} failed on {SOURCE}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """The loaded runtime, built on first use. Raises RuntimeError when it
    cannot be built or loaded."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = os.path.join(BUILD_ROOT, _build_key(), "libmfa_runtime.so")
        t0 = time.perf_counter()
        built = not os.path.exists(so)
        if built:
            _build(so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError(f"native runtime: cannot load {so}: {e}") from e
        _LIB = _declare(lib)
        build_seconds = time.perf_counter() - t0 if built else 0.0
        return _LIB


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeAllocator:
    """C++ free-list page allocator (page 0 reserved), with the interface
    and the page order of cache/paged_cache.py:PageAllocator."""

    def __init__(self, num_pages: int):
        self._lib = load()
        self.num_pages = num_pages
        self._h = ctypes.c_void_p(self._lib.mfa_alloc_create(num_pages))

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.mfa_alloc_destroy(h)
            self._h = None

    @property
    def free_pages(self) -> int:
        return int(self._lib.mfa_alloc_free_count(self._h))

    def alloc(self, n: int) -> List[int]:
        out = np.empty((max(n, 0),), np.int32)
        if self._lib.mfa_alloc_pages(self._h, n, _ptr(out)) < 0:
            raise MemoryError(
                f"paged KV cache out of pages: need {n}, have {self.free_pages}")
        return [int(x) for x in out]

    def free(self, pages: Sequence[int]) -> None:
        arr = _i32(list(pages))
        self._lib.mfa_free_pages(self._h, _ptr(arr), len(arr))


def admit(prompt_lens: Sequence[int], free_slots: int, free_pages: int,
          page_size: int) -> Tuple[int, List[int]]:
    """-> (n_admitted, pages_needed list): FIFO admission while a slot is
    free and the prompt's pages plus one decode page fit (mfa_tpu's
    Python rule, in C++)."""
    lens = _i32(prompt_lens)
    lib = load()
    if not len(lens):
        return 0, []
    out = np.zeros((len(lens),), np.int32)
    n = lib.mfa_admit(_ptr(lens), len(lens), free_slots, free_pages,
                      page_size, _ptr(out))
    return int(n), [int(x) for x in out[:n]]


def pack_block_table(pages_per_req, pages_per_seq: int) -> np.ndarray:
    """[[page ids]...] -> dense [n, pages_per_seq] int32 table, zero-filled,
    each row cut to pages_per_seq."""
    lib = load()
    n = len(pages_per_req)
    counts = _i32([len(p) for p in pages_per_req])
    flat = _i32([p for row in pages_per_req for p in row])
    if flat.size == 0:
        flat = np.zeros((1,), np.int32)
    out = np.zeros((n, pages_per_seq), np.int32)
    if n:
        lib.mfa_pack_block_table(_ptr(flat), _ptr(counts), n, pages_per_seq,
                                 _ptr(out))
    return out


def cu_seqlens(lens) -> np.ndarray:
    """Lengths -> their exclusive prefix sum with a leading 0, int32."""
    lens = _i32(lens)
    lib = load()
    out = np.zeros((len(lens) + 1,), np.int32)
    lib.mfa_cu_seqlens(_ptr(lens), len(lens), _ptr(out))
    return out
