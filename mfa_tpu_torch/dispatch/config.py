"""Host-side kernel configuration for the Hopper port.

Counterpart of mfa_tpu/dispatch/config.py. The TPU tile tables and the
TPU split constants do not carry over; the split heuristic here is the
reference's own rule (SM count and wave efficiency, SURVEY.md §2.2,
csrc/mfa/api.cpp:269-302) for the H100's 132 SMs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

MAX_HEAD_DIM = 256
# head dims the attention kernels are instantiated at (csrc/*.cu); any other
# d <= 256 runs the next one up, its rows read at their stored width
KERNEL_HEAD_DIMS = (64, 128, 256)
# bytes a TMA tensor map's rows must be a multiple of (cuTensorMapEncodeTiled's
# global stride rule)
TMA_ROW_BYTES = 16
# storage bits a feature of each row format: 16-bit rows (None) and the
# quantized KV page formats (kernels/quant.py)
_FEATURE_BITS = {None: 16, "int8": 8, "fp8": 8, "int4": 4}

# H100 SXM: streaming multiprocessors per card.
H100_SMS = 132


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class HeadDimPlan:
    """How a kernel takes rows of `head_dim` features (`head_dim_plan`)."""

    head_dim: int     # the true d: the softmax scale's d and the caller's width
    kernel_dim: int   # D, the instantiated head dim the kernel runs at
    stored: int       # features of a row as the kernel's tensor maps read it

    @property
    def padded(self) -> bool:
        """True when a row must be stored wider than d (a padded copy, or
        pages created at the stored width)."""
        return self.stored != self.head_dim


def head_dim_plan(head_dim: int, fmt: Optional[str] = None) -> HeadDimPlan:
    """The head-dim plan shared by every attention wrapper and the CPU tests.

    fmt: None for 16-bit rows, or a KV page format ("int8", "fp8", "int4").
    The kernel's D is the smallest of KERNEL_HEAD_DIMS at least d. A row is
    stored at its true width when its bytes are a multiple of
    TMA_ROW_BYTES, else at the smallest wider width whose bytes are (d 80:
    160 B bf16 and 80 B int8 rows kept, 40 B int4 rows stored 48 B wide;
    d 100 bf16: 208 B). The extra features are zeros, inert in Q K^T and
    P V; TMA fills a box's columns past the stored width with zeros up to
    D. The softmax scale stays d ** -0.5 of the true d: never the stored
    width's or D's.
    """
    d = int(head_dim)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be in [1, {MAX_HEAD_DIM}], got {d}")
    if fmt not in _FEATURE_BITS:
        raise ValueError(f"unsupported row format {fmt!r}")
    stored = round_up(d, TMA_ROW_BYTES * 8 // _FEATURE_BITS[fmt])
    kernel_dim = next(k for k in KERNEL_HEAD_DIMS if k >= stored)
    return HeadDimPlan(d, kernel_dim, stored)


def pad_features(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with its last dim zero-padded to `width` (x itself if it has it)."""
    extra = width - x.shape[-1]
    return x if extra == 0 else torch.nn.functional.pad(x, (0, extra))


def unpad_features(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """A kernel's output at a stored width -> its first head_dim features
    (contiguous; x itself when it has no others)."""
    return x if x.shape[-1] == head_dim else x[..., :head_dim].contiguous()


def num_splits_heuristic(
    batch: int,
    num_kv_heads: int,
    seqlen_k: int,
    block_k: int,
    max_splits: int = 128,
    num_sms: int = H100_SMS,
    blocks_per_sm: int = 2,
) -> int:
    """Split count for flash decoding (one block per batch x kv head x split).

    The reference rule (api.cpp:269-302): with `blocks_per_sm` resident
    blocks per SM (the kernel's own residency), a grid that already fills
    80% of a wave needs no split; otherwise pick the smallest split count
    whose wave efficiency n_waves / ceil(n_waves) exceeds 0.9, else the most
    efficient one. Never more splits than KV blocks, so every split has
    work.
    """
    n_blocks = cdiv(seqlen_k, block_k)
    if n_blocks <= 1:
        return 1
    units = blocks_per_sm * num_sms
    work = batch * num_kv_heads
    if work >= 0.8 * units:
        return 1
    best, best_eff = 1, 0.0
    for s in range(1, min(max_splits, num_sms, n_blocks) + 1):
        n_waves = work * s / units
        eff = n_waves / math.ceil(n_waves)
        if eff > 0.9:
            return s
        if eff > best_eff:
            best, best_eff = s, eff
    return best


def validate_attention_inputs(q, k, v, *, api_name: str) -> None:
    """Shape/dtype validation mirroring csrc/mfa/api.cpp:126-162."""
    if q.dtype not in (torch.float16, torch.bfloat16, torch.float32):
        raise ValueError(
            f"{api_name}: dtype must be fp16/bf16/fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{api_name}: q/k/v dtypes must match")
    if q.shape[-1] != k.shape[-1] or q.shape[-1] != v.shape[-1]:
        raise ValueError(f"{api_name}: head_dim mismatch")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{api_name}: head_dim must be <= {MAX_HEAD_DIM}")
    num_heads = q.shape[-2]
    num_kv_heads = k.shape[-2]
    if v.shape[-2] != num_kv_heads:
        raise ValueError(f"{api_name}: k/v head count mismatch")
    if num_heads % num_kv_heads != 0:
        raise ValueError(
            f"{api_name}: num_heads ({num_heads}) must be divisible by "
            f"num_kv_heads ({num_kv_heads})"
        )


def softmax_scale_default(head_dim: int) -> float:
    return 1.0 / math.sqrt(head_dim)


def resolve_device(device) -> torch.device:
    """Device for entry points that create state: "cuda" unless the caller
    asks for another; a CUDA device without a GPU raises instead of
    quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def host_to_device(values, dtype, device) -> torch.Tensor:
    """Host values (a list, numpy array or CPU tensor) as a `dtype` tensor
    on `device`. On a CUDA device the copy is staged in pinned memory and
    enqueued without waiting for the stream (a pageable copy would wait for
    every kernel in flight, and is refused inside a graph capture); the
    pinned block is not reused before the copy has run."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# KV length (pages_per_seq * page_size) from which kernel 6 reads int4 pages
# faster than int8 pages on an H100 (scripts/time_kv_formats.py's lens
# sweep, 512 to 32768 tokens at the 8B heads, batch 16): int4 never lost
# there, so this is the smallest length swept (at 512 int4 took 0.986 of
# int8's time; 0.93-0.95 from 2048 on). Below it int8 keeps its finer
# steps.
INT4_KV_CROSSOVER_TOKENS = 512


def recommend_kv_quant(
    expected_kv_len: int,
    *,
    memory_bound: bool = False,
    quality_floor: bool = False,
    outlier_tolerant: bool = False,
) -> str:
    """Pick the KV-cache storage format for a serving config
    (mfa_tpu/dispatch/config.py:recommend_kv_quant's rule).

    expected_kv_len: the cache capacity a sequence can reach
    (pages_per_seq * page_size). `memory_bound=True` forces int4 (half of
    int8's bytes: capacity over precision); `quality_floor=True` refuses
    int4. `outlier_tolerant=True` (KV rows with outlier channels, which
    crush a per-row int8 scale) takes fp8 at the 8-bit operating points:
    e4m3 keeps its relative precision whatever the row's absmax. Otherwise
    int4 from INT4_KV_CROSSOVER_TOKENS on, int8 below.
    """
    eight_bit = "fp8" if outlier_tolerant else "int8"
    if quality_floor:
        return eight_bit
    if memory_bound or expected_kv_len >= INT4_KV_CROSSOVER_TOKENS:
        return "int4"
    return eight_bit
