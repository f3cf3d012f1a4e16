"""Host-side kernel configuration for the Hopper port.

Counterpart of mfa_tpu/dispatch/config.py. The TPU tile tables and the
TPU split constants do not carry over; the split heuristic here is the
reference's own rule (SM count and wave efficiency, SURVEY.md §2.2,
csrc/mfa/api.cpp:269-302) for the H100's 132 SMs.
"""

from __future__ import annotations

import math

import torch

MAX_HEAD_DIM = 256

# H100 SXM: streaming multiprocessors per card.
H100_SMS = 132


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


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
