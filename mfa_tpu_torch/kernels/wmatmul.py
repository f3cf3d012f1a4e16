"""int8-weight matmul (counterpart of mfa_tpu/kernels/wmatmul.py).

Kernel 10 of the port: csrc/wmatmul.cu `mfa_int8_matmul`, x [m, K] @
(qw [K, N] int8 * scale [N]) with fp32 accumulation, the scale applied to
the accumulator and the result rounded once. In JAX this kernel is a
baseline beside XLA's fused convert; eager PyTorch fuses nothing, so here
it carries every int8 projection. A CUDA tensor runs the kernel (or
raises); a CPU tensor runs `_int8_matmul_plain`, the graph of mfa_tpu's
qmm, `(x @ qw.to(x.dtype)) * scale.to(x.dtype)`: in fp32 the two are the
same function. x is bf16, fp16 or fp32; fp32 x (out fp32, launch names
`wmatmul_fp32`, `wmatmul_bank_fp32`) is split by a pre-pass kernel into
three bf16 parts that add back to it exactly (`_split_bf16x3_plain` is
its plain version), whose three products run on the same tile against
one conversion of W.

The kernel (wgmma + TMA) computes the product transposed: a block owns 128
weight columns and `block_m(m)` rows of x. When those tiles cannot fill
the card (decode-sized m) K is split over a thread-block cluster whose
blocks reduce the splits in shared memory: one launch either way.

`int8_bank_matmul` is the same kernel over an int8 MoE expert bank [E, K,
N] (csrc/wmatmul.cu `mfa_int8_bank_matmul`, launch name `wmatmul_bank`),
the expert on the grid beside the K splits: the dense form (every expert
over the same rows, or over rows of its own: mfa_tpu's _moe_dense_int8
einsums) and the grouped form (expert e over its rows offs[e]:offs[e + 1]
of expert-sorted x: mfa_tpu's ragged_qmm). Neither is a Pallas kernel in
JAX; on the card the bank is kernel 10's operand, so one launch a
projection replaces E launches or a dequantized bf16 bank. The grouped
launch reads offs on the device and covers the most rows an expert can
own, so it needs no host read and can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import H100_SMS, cdiv
from mfa_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, qw, scale, out, x3, dtype, out_f32, M, K, N, splits,
# k_steps_per_split, stream
_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]
# x, qw, scale, out, offs, x3, dtype, M, K, N, experts, x_per_expert, bm,
# m_tiles, splits, k_steps_per_split, stream
_BANK_ARGTYPES = [_P] * 6 + [_I] * 10 + [_P]
BLOCK_N, BLOCK_K = 128, 64  # csrc/wmatmul.cu's tile: 128 weight columns, K steps of 64
# K splits of one output tile form a cluster: at most the portable size
MAX_SPLITS = 8


def block_m(m: int, f32: bool = False) -> int:
    """Rows of x a block (wgmma's n side): the smallest of 16, 32, 64 that
    holds m, else 128 below 256 and 256 from there; fp32 x (f32) at most
    128 (its per-step accumulator doubles the registers)."""
    for bm in (16, 32, 64):
        if m <= bm:
            return bm
    return 128 if m < 256 or f32 else 256


def split_k(m: int, K: int, N: int, experts: int = 1, f32: bool = False) -> tuple:
    """-> (splits, K steps of 64 per split) for an m x K x N product (of
    each of `experts` matrices): no split once the output tiles cover the
    SMs (one block an SM); else as many splits as keep every block
    resident, at most MAX_SPLITS."""
    tiles = experts * cdiv(m, block_m(m, f32)) * cdiv(N, BLOCK_N)
    steps = cdiv(K, BLOCK_K)
    if tiles >= H100_SMS or steps <= 1:
        return 1, steps
    want = min(MAX_SPLITS, steps, max(1, H100_SMS // tiles))
    per = cdiv(steps, want)
    return cdiv(steps, per), per


def _int8_matmul_plain(x, qw, scale, out_dtype):
    return ((x @ qw.to(x.dtype)) * scale.to(x.dtype)).to(out_dtype)


def _split_bf16x3_plain(x):
    """The plain version of csrc/wmatmul.cu's split3_kernel: fp32 x -> bf16
    (hi, mid, lo), hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
    mid), each difference exact in fp32, so hi + mid + lo == x for normal
    values (8 + 8 + 8 bits of fp32's 24)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _x3_scratch(x):
    """fp32 x's bf16 parts [3, rows, K] for the kernel to fill, else None."""
    if x.dtype != torch.float32:
        return None
    return torch.empty((3,) + tuple(x.reshape(-1, x.shape[-1]).shape),
                       dtype=torch.bfloat16, device=x.device)


def _int8_matmul_cuda(x, qw, scale, out_dtype):
    _check_operands("int8_matmul", x, qw, scale)
    if out_dtype not in (x.dtype, torch.float32):
        raise NotImplementedError(f"the int8 matmul kernel writes {x.dtype} or "
                                  f"float32, not {out_dtype}")
    m, K = x.shape
    N = qw.shape[1]
    _build.same_device("int8_matmul", x, qw, scale)
    x, qw, scale = _build.dense(x), _build.dense(qw), _build.dense(scale)
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    x3 = _x3_scratch(x)
    splits, per = split_k(m, K, N, f32=x3 is not None)
    fn = _build.function("wmatmul", "mfa_int8_matmul", _ARGTYPES)
    rc = fn(x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _build.ptr(x3), _build.DTYPE_CODES[x.dtype],
            int(out_dtype == torch.float32), m, K, N, splits, per,
            _build.stream_of(x))
    _build.check("wmatmul", rc)
    _build.launches[_build.launch_key("wmatmul", x.dtype)] += 1
    return out


def _check_operands(name, x, qw, scale):
    _build.refuse_grad(name, x)
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise NotImplementedError(f"the int8 matmul kernel takes bf16/fp16/fp32 "
                                  f"x, got {x.dtype}")
    if qw.dtype != torch.int8 or scale.dtype != torch.float32:
        raise NotImplementedError(f"the int8 matmul kernel takes int8 weights "
                                  f"and fp32 scales, got {qw.dtype} and "
                                  f"{scale.dtype}")
    K, N = qw.shape[-2:]
    if K % 16 or N % 16:
        raise NotImplementedError(f"the int8 matmul kernel takes K and N that "
                                  f"are multiples of 16, got K={K} N={N}")


def _bank_plain(x, qw, scale, offs, out_dtype):
    """mfa_tpu's graph per expert, (x_e @ qw_e.to(x.dtype)) * scale_e: dense
    by broadcasting, grouped over the host's copy of offs (rows past
    offs[E], which no expert owns, come out zero)."""
    if offs is None:
        return ((x @ qw.to(x.dtype)) * scale[:, None, :].to(x.dtype)).to(out_dtype)
    bounds = offs.tolist()
    parts = [_int8_matmul_plain(x[bounds[e]:bounds[e + 1]], qw[e], scale[e],
                                out_dtype) for e in range(qw.shape[0])]
    if bounds[-1] < x.shape[0]:
        parts.append(x.new_zeros((x.shape[0] - bounds[-1], qw.shape[-1]),
                                 dtype=out_dtype))
    return torch.cat(parts)


def _bank_cuda(x, qw, scale, offs, max_rows, out_dtype):
    _check_operands("int8_bank_matmul", x, qw, scale)
    if out_dtype != x.dtype:
        raise NotImplementedError(f"the bank launch writes x's dtype {x.dtype}, "
                                  f"not {out_dtype}")
    E, K, N = qw.shape
    _build.same_device("int8_bank_matmul", x, qw, scale,
                       *(() if offs is None else (offs,)))
    if offs is not None and offs.dtype != torch.int32:
        raise NotImplementedError(f"offs must be int32, got {offs.dtype}")
    x, qw, scale = _build.dense(x), _build.dense(qw), _build.dense(scale)
    x3 = _x3_scratch(x)
    f32 = x3 is not None
    if offs is None:
        M = x.shape[-2]
        bm = block_m(M, f32)
        m_tiles = cdiv(M, bm)
        splits, per = split_k(M, K, N, E, f32)
        out = torch.empty((E, M, N), dtype=out_dtype, device=x.device)
    else:
        offs = _build.dense(offs)
        M = x.shape[0]
        # tiles sized by the mean group; the grid covers the largest one
        bm = block_m(cdiv(M, E), f32)
        m_tiles = cdiv(max_rows, bm)
        splits, per = split_k(cdiv(M, E), K, N, E, f32)
        out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    fn = _build.function("wmatmul", "mfa_int8_bank_matmul", _BANK_ARGTYPES)
    rc = fn(x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _build.ptr(offs), _build.ptr(x3), _build.DTYPE_CODES[x.dtype], M, K,
            N, E, int(offs is None and x.dim() == 3), bm, m_tiles, splits, per,
            _build.stream_of(x))
    _build.check("wmatmul", rc)
    _build.launches[_build.launch_key("wmatmul_bank", x.dtype)] += 1
    return out


def int8_bank_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                     offs: Optional[torch.Tensor] = None,
                     max_rows: Optional[int] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ (qw[e] int8 * scale[e]) for every expert e of a bank qw [E, K, N]
    with scale [E, N].

    Dense form (offs None): x [T, K], the same rows for every expert, or
    [E, T, K], rows of each expert's own -> [E, T, N].
    Grouped form: x [R, K] sorted by expert, offs [E + 1] int32 (offs[0] = 0,
    nondecreasing, offs[E] = R), expert e over rows offs[e]:offs[e + 1] ->
    [R, N]; max_rows (default R) bounds the rows of one expert, and the
    launch covers that many for each.
    On the card: x bf16, fp16 or fp32, out in x's dtype, K and N multiples
    of 16."""
    if qw.dim() != 3 or tuple(scale.shape) != (qw.shape[0], qw.shape[2]):
        raise ValueError(f"int8_bank_matmul: qw {tuple(qw.shape)} and scale "
                         f"{tuple(scale.shape)} are not a bank [E, K, N], [E, N]")
    E, K, _ = qw.shape
    if offs is None:
        if x.dim() not in (2, 3) or x.shape[-1] != K or (
                x.dim() == 3 and x.shape[0] != E):
            raise ValueError(f"int8_bank_matmul: x {tuple(x.shape)} is neither "
                             f"[T, {K}] nor [{E}, T, {K}]")
    elif x.dim() != 2 or x.shape[1] != K or tuple(offs.shape) != (E + 1,):
        raise ValueError(f"int8_bank_matmul: grouped x {tuple(x.shape)} must be "
                         f"[R, {K}] with offs [{E + 1}], got {tuple(offs.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return _bank_plain(x, qw, scale, offs, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_bank_matmul: unsupported device {x.device}")
    return _bank_cuda(x, qw, scale, offs, x.shape[0] if max_rows is None
                      else max_rows, out_dtype)


def int8_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [m, K] @ (qw [K, N] int8 * scale [N]) -> [m, N] in out_dtype
    (default x.dtype). On the card: any m, K and N multiples of 16, x bf16,
    fp16 or fp32, out in x's dtype or fp32."""
    if x.dim() != 2 or qw.dim() != 2:
        raise ValueError(f"int8_matmul takes 2-D x and qw, got {tuple(x.shape)} "
                         f"and {tuple(qw.shape)}")
    if x.shape[1] != qw.shape[0] or tuple(scale.shape) != (qw.shape[1],):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, qw {tuple(qw.shape)} "
                         f"and scale {tuple(scale.shape)} do not agree")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return _int8_matmul_plain(x, qw, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return _int8_matmul_cuda(x, qw, scale, out_dtype)
