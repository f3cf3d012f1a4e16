"""KV-cache quantization, int8 per-row (counterpart of mfa_tpu/kernels/quant.py).

One fp32 scale per (kv head, token row). The paged kernel applies K scales
to score columns after QK^T and folds V scales into the probabilities, so
dequantization is O(tokens). Plain PyTorch: these run once per appended
row, far from the cost of the cache read. fp8 and int4 KV come in a later
slice and raise for now.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quant_max(quant_dtype: str) -> float:
    if quant_dtype == "int8":
        return 127.0
    if quant_dtype in ("fp8", "int4"):
        raise NotImplementedError(f"{quant_dtype} KV is not ported yet")
    raise ValueError(f"unsupported quant dtype {quant_dtype!r}")


def storage_dtype(quant_dtype: str) -> torch.dtype:
    quant_max(quant_dtype)
    return torch.int8


def quantize_rows(x: torch.Tensor, quant_dtype: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., head_dim] float -> (int8 payload [..., head_dim], fp32 scales
    [...]). Symmetric: payload = round(x / scale), scale = absmax / 127.
    torch.round rounds half to even, as jnp.round does, so payloads match
    the JAX package byte for byte."""
    qmax = quant_max(quant_dtype)
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / qmax)
    payload = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
    return payload.to(torch.int8), scale


def dequantize_rows(payload: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_rows (test/oracle path)."""
    return (payload.float() * scales[..., None]).to(dtype)
