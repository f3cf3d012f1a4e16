"""KV-cache quantization: int8, fp8 (e4m3) and int4 per-row (counterpart of
mfa_tpu/kernels/quant.py).

One fp32 scale per (kv head, token row). The paged kernels apply K scales
to score columns after QK^T and fold V scales into the probabilities, so
dequantization is O(tokens). Plain PyTorch: these run once per appended
row, far from the cost of the cache read.

Storage: int8 payloads as int8, fp8 as the native torch.float8_e4m3fn,
int4 as int8 bytes of two features each (pack_int4: byte c of a row holds
feature 2c in its low nibble and feature 2c + 1 in its high nibble, as
two's-complement 4-bit values). The JAX package pairs tokens in a byte
instead (a TPU lane trick); feature pairs keep tokens in natural order, so
an append is a plain row write and a byte is one bf16x2 operand of Q K^T.
quantize_rows returns int4 values unpacked; the cache packs them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mfa_tpu_torch.dispatch.config import head_dim_plan

KV_QUANT_DTYPES = ("int8", "fp8", "int4")
FP8 = torch.float8_e4m3fn


def quant_max(quant_dtype: str) -> float:
    if quant_dtype == "int8":
        return 127.0
    if quant_dtype == "int4":
        return 7.0
    if quant_dtype == "fp8":
        return float(torch.finfo(FP8).max)  # 448 for e4m3fn
    raise ValueError(f"unsupported quant dtype {quant_dtype!r}")


def storage_dtype(quant_dtype: str) -> torch.dtype:
    quant_max(quant_dtype)
    return FP8 if quant_dtype == "fp8" else torch.int8


def row_width(quant_dtype: Optional[str], head_dim: int) -> int:
    """Stored elements of a page row at the head-dim plan's stored width
    (dispatch/config.py:head_dim_plan): its features, or half of them in
    bytes for int4 (d 80: 80 features, int4 48 bytes). The JAX package
    pads rows to 128 lanes instead, for the TPU's DMA."""
    stored = head_dim_plan(head_dim, quant_dtype).stored
    return stored // 2 if quant_dtype == "int4" else stored


def page_features(quant_dtype: Optional[str], pages: torch.Tensor) -> int:
    """Features a stored page row holds (int4: two a byte)."""
    return 2 * pages.shape[-1] if quant_dtype == "int4" else pages.shape[-1]


def scale_of(absmax: torch.Tensor, qmax: float,
             reciprocal: bool = False) -> torch.Tensor:
    """fp32 scales absmax / qmax (1 where absmax is 0) by the rule of the
    mfa_tpu caller the port's quantizer stands for. Eager jnp divides;
    inside jax.jit XLA turns the division by the constant into absmax *
    f32(1 / qmax), the reciprocal rounded to fp32 (reciprocal=True). Both
    operands are tensors, so the card and the CPU compute the same float:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, its CPU division divides."""
    if reciprocal:
        inv = (torch.ones((), dtype=torch.float32)
               / torch.full((), qmax, dtype=torch.float32)).item()
        scale = absmax * torch.full_like(absmax, inv)
    else:
        scale = absmax / torch.full_like(absmax, qmax)
    return torch.where(absmax == 0.0, torch.ones_like(absmax), scale)


def quantize_rows(x: torch.Tensor, quant_dtype: str, reciprocal: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., head_dim] float -> (payload [..., head_dim], fp32 scales
    [...]). Symmetric, scale = absmax / quant_max (1 for an all-zero row;
    reciprocal: by mfa_tpu's jitted rule, `scale_of`). int8/int4: payload
    = round(x / scale) clipped (torch.round rounds half to even, as
    jnp.round does), int8 storage, int4 values UNPACKED in [-7, 7]; fp8: x
    / scale clipped to +-448, cast to e4m3 (round to nearest even).
    Payloads match the JAX package byte for byte: eager quantize_rows
    without reciprocal, the one inside its jitted steps with it."""
    qmax = quant_max(quant_dtype)
    xf = x.float()
    scale = scale_of(xf.abs().amax(dim=-1), qmax, reciprocal)
    scaled = xf / scale[..., None]
    if quant_dtype == "fp8":
        return torch.clamp(scaled, -qmax, qmax).to(FP8), scale
    payload = torch.clamp(torch.round(scaled), -qmax, qmax)
    return payload.to(torch.int8), scale


def pack_int4(vals: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., d] -> int8 bytes [..., d / 2]: byte c
    = feature 2c (low nibble) | feature 2c + 1 (high nibble)."""
    v = vals.to(torch.int16)
    lo = v[..., 0::2] & 0x0F
    hi = (v[..., 1::2] & 0x0F) << 4
    b = lo | hi  # 0..255
    return torch.where(b > 127, b - 256, b).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: int8 [..., d / 2] -> int8 values [..., d],
    sign-extended."""
    b = packed.to(torch.int16) & 0xFF
    lo = ((b & 0x0F) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def page_values(pages: torch.Tensor, quant_dtype: Optional[str]
                ) -> torch.Tensor:
    """Stored pages -> their payload values (int4 unpacked to head_dim
    wide), in a dtype whose .float() is exact."""
    return unpack_int4(pages) if quant_dtype == "int4" else pages


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """fp8 tensors are written through a uint8 view (index_put_ and cat
    need not exist for float8 on every device); others as they are."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def dequantize_rows(payload: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_rows (test/oracle path; int4 payloads unpacked)."""
    return (payload.float() * scales[..., None]).to(dtype)


def page_format(quant_dtype: Optional[str], k_pages: torch.Tensor,
                k_scales: Optional[torch.Tensor], head_dim: int
                ) -> Optional[str]:
    """The format of a paged kernel's pages, checked: None (16/32-bit
    pages), "int8", "fp8" or "int4". quant_dtype None takes it from the
    pages (int8 with scales, float8_e4m3fn); int4 pages are int8 storage,
    so they must be named: never read from the dtype alone."""
    fmt = quant_dtype
    if fmt is None and k_scales is not None:
        fmt = "fp8" if k_pages.dtype == FP8 else "int8"
    if fmt is not None and fmt not in KV_QUANT_DTYPES:
        raise ValueError(f"unsupported quant dtype {quant_dtype!r}")
    if (fmt is None) != (k_scales is None) or (
            fmt is None and k_pages.dtype in (torch.int8, FP8)):
        raise ValueError("quantized pages need k_scales/v_scales, and only "
                         "they")
    if fmt is not None and k_pages.dtype != storage_dtype(fmt):
        raise ValueError(f"{fmt} pages are stored as {storage_dtype(fmt)}, "
                         f"got {k_pages.dtype}")
    # the stored width, or unpadded rows (int4: an even head_dim's halves)
    widths = {row_width(fmt, head_dim)}
    if fmt != "int4" or head_dim % 2 == 0:
        widths.add(head_dim // 2 if fmt == "int4" else head_dim)
    if k_pages.shape[-1] not in widths:
        raise ValueError(f"page width {k_pages.shape[-1]} not in "
                         f"{sorted(widths)} ({fmt or 'unquantized'} pages of "
                         f"head_dim {head_dim}: stored or unpadded)")
    return fmt
