"""Build and load the hand-written CUDA kernels, and count their launches.

Each source in mfa_tpu_torch/csrc/*.cu is compiled on its own by nvcc for
sm_90a into a shared library with a plain C interface and loaded with
ctypes (no PyTorch headers: a build takes seconds, not minutes). All
sources build in parallel at first use into mfa_tpu_torch/_build/<key>/,
where the key hashes the sources and the flags, so a changed source never
loads a stale library. Nothing is built at import time.

`launches` counts kernel launches by name. A wrapper adds one right after
its launch and nowhere else, so a run can show which kernels it went
through; `reset_launches()` zeroes the counts.

`split_counters` owns the ticket counters of the split-KV decode launches
(kernels 5 and 6), one persistent buffer per device.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("prefill.cu", "decode.cu", "paged.cu", "paged_prefill.cu",
           "backward.cu", "blockmask.cu", "bound.cu", "wmatmul.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

# dtype codes of csrc/common.cuh (fp32: the fp32 tiles of csrc/flash_fwd_f32.cuh)
DTYPE_CODES = {torch.float16: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float32: 5}
# page-format codes of quantized KV pages (csrc/common.cuh). int4 pages are
# int8 storage, so a launcher takes the code from the format the caller
# names (kernels/quant.py:page_format), never from the pages' dtype.
KV_CODES = {"int8": 2, "fp8": 3, "int4": 4}


def kv_code(fmt, pages: torch.Tensor) -> int:
    """The kv_dtype code of a paged kernel: the quantized format's, or the
    16-bit pages' dtype code."""
    return KV_CODES[fmt] if fmt else DTYPE_CODES[pages.dtype]


def launch_key(name: str, dtype: torch.dtype) -> str:
    """The launch-count name of a kernel for inputs of `dtype`: fp32 inputs
    run the fp32 tile and count as `<name>_fp32`."""
    return f"{name}_fp32" if dtype == torch.float32 else name


launches: collections.Counter = collections.Counter()

# The split-KV decode merges its splits in its one launch: the last block
# of each (batch, kv head, row block) to finish takes the last ticket of its
# int32 counter, merges, and zeroes the counter again. A launch takes one
# counter per (batch, kv head, row block), SPLIT_COUNTERS at most.
SPLIT_COUNTERS = 1 << 16
_counters: Dict[torch.device, torch.Tensor] = {}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None


def reset_launches() -> None:
    launches.clear()


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's zeroed int32 ticket counters for a split-KV decode
    launch of n (batch x kv head x row block) merges (kernels/decode.py,
    kernels/paged.py). Allocated at the device's first split launch and
    never reallocated, since a captured CUDA graph keeps its address; each
    launch leaves them zero, so a replay needs no memset. Launches that take
    them must not run at once on two streams of one device (the engine runs
    one stream a device). Raises ValueError past SPLIT_COUNTERS merges, and
    RuntimeError if the first use comes inside a CUDA graph capture."""
    if n > SPLIT_COUNTERS:
        raise ValueError(f"a split decode launch of {n} (batch x kv head x row "
                         f"block) merges exceeds the {SPLIT_COUNTERS} counters")
    buf = _counters.get(device)
    if buf is None:
        cuda = device.type == "cuda"
        if cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the split decode's counters are allocated at the "
                               "device's first split launch, which must not be "
                               "inside a CUDA graph capture: run one step eagerly")
        buf = torch.zeros(SPLIT_COUNTERS, dtype=torch.int32, device=device)
        if cuda:
            torch.cuda.synchronize(device)  # zero before any stream launches on it
        _counters[device] = buf
    return buf


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_all() -> float:
    """Compile every source (one nvcc per source, all started together) and
    load the libraries. Returns the seconds the build took (0 when the
    libraries for these sources were built before)."""
    global build_seconds
    if len(_libs) == len(SOURCES):
        return build_seconds or 0.0
    out_dir = os.path.join(BUILD_ROOT, _build_key())
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in SOURCES:
        so = os.path.join(out_dir, f"lib{src[:-3]}.so")
        if os.path.exists(so):
            continue
        tmp = so + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for src, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_seconds = time.perf_counter() - t0 if procs else 0.0
    for src in SOURCES:
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{src[:-3]}.so"))
        lib.mfa_error_string.restype = ctypes.c_char_p
        lib.mfa_error_string.argtypes = [ctypes.c_int]
        _libs[src[:-3]] = lib
    return build_seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (building all sources once)."""
    if name not in _libs:
        build_all()
    return _libs[name]


def function(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """A launch function of csrc/<lib>.cu with its C signature declared
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = getattr(library(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(lib: str, rc: int) -> None:
    """Raise on a launch the runtime refused (cudaGetLastError != 0)."""
    if rc != 0:
        msg = library(lib).mfa_error_string(rc).decode()
        raise RuntimeError(f"{lib} kernel launch failed ({rc}): {msg}")


def stream_of(t: torch.Tensor) -> int:
    """The current stream of the tensor's device, as the C side's
    cudaStream_t."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def dense(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte-aligned start: the kernels read rows as
    16-byte vectors, and a view that starts mid-vector would fault."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd would record a graph through these tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """A kernel launch builds no autograd graph: raise instead of returning
    an output whose gradient would be silently missing."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is not differentiable and an input "
            f"requires grad; use mfa_tpu_torch.kernels.autodiff "
            f"(flash_attention_grad, flash_attn_func_grad, "
            f"flash_attn_varlen_func_grad), or call under torch.no_grad()")


def same_device(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({t.device} vs {dev})")


def expect_shape(name: str, what: str, t: torch.Tensor, shape) -> None:
    """A kernel indexes with the shapes it is given: refuse a mismatch
    before it becomes an out-of-bounds read."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
