"""Flash-attention prefill forward (counterpart of mfa_tpu/kernels/prefill.py).

Kernel 1 of the port: csrc/prefill.cu, one classic online-softmax forward
that replaces the TPU's classic (_prefill_body), zero-shift flagged and
repair kernels, which all compute this same function. A CUDA tensor runs
the kernel (or raises); a CPU tensor runs `_prefill_plain`, the same
function in fp32 PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import softmax_scale_default
from mfa_tpu_torch.kernels import _build

_LOG2E = math.log2(math.e)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _F, _F, _F, _P]
KERNEL_HEAD_DIMS = (64, 128)


def _prefill_plain(q, k, v, scale, window_left, window_right, softcap,
                   return_lse):
    """fp32 reference of the kernel: same band, softcap and dead-row rules;
    LSE is the natural log of the scaled (capped) logits."""
    _, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = q.float() @ kf.transpose(-1, -2)
    if softcap:
        s = torch.tanh(s * (scale / softcap)) * softcap
    else:
        s = s * scale
    row = torch.arange(sq, device=q.device)[:, None]
    col = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if window_right >= 0:
        mask &= col <= row + window_right
    if window_left >= 0:
        mask &= col >= row - window_left
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    out = (p @ vf).to(q.dtype)
    return (out, lse) if return_lse else out


def _prefill_cuda(q, k, v, scale, window_left, window_right, softcap,
                  return_lse):
    _build.refuse_grad("prefill_attention", q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"the prefill kernel takes bf16/fp16, got {q.dtype}")
    batch, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the prefill kernel takes head_dim in "
                                  f"{KERNEL_HEAD_DIMS}, got {d}")
    _build.same_device("prefill_attention", q, k, v)
    _build.expect_shape("prefill_attention", "k", k, (batch, hkv, sk, d))
    _build.expect_shape("prefill_attention", "v", v, k.shape)
    q, k, v = _build.dense(q), _build.dense(k), _build.dense(v)
    out = torch.empty_like(q)
    lse = (torch.empty((batch, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    scale_log2e = _LOG2E if softcap else scale * _LOG2E
    fn = _build.function("prefill", "mfa_prefill_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.ptr(lse), _build.DTYPE_CODES[q.dtype], batch, hq, hkv, sq,
            sk, d, window_left, window_right, scale_log2e, float(softcap),
            scale / softcap if softcap else 0.0, _build.stream_of(q))
    _build.check("prefill", rc)
    _build.launches["prefill"] += 1
    return (out, lse) if return_lse else out


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    return_lse: bool = False,
    logit_softcap: float = 0.0,
    sink_tokens: int = 0,
    alibi_slopes: Optional[torch.Tensor] = None,
    kv_position_offset: int = 0,
):
    """Flash-attention forward on the [batch, heads, seq, head_dim] layout.

    q: [b, hq, sq, d]; k/v: [b, hkv, sk, d] with hq % hkv == 0 (q head h
    reads kv head h // (hq // hkv)). Causal is top-left aligned (col > row
    masked) and equals window (-1, 0); window_size is (left, right) around
    each row, -1 = unbounded. logit_softcap > 0 applies
    tanh(s * scale / cap) * cap to the logits.

    Returns O [b, hq, sq, d] in q's dtype and, with return_lse, the fp32
    natural-log LSE [b, hq, sq] (-inf on rows that see no column).
    ALiBi, attention sinks and kv_position_offset are not ported yet.
    """
    if alibi_slopes is not None or sink_tokens or kv_position_offset:
        raise NotImplementedError(
            "alibi_slopes, sink_tokens and kv_position_offset are not "
            "ported yet")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num_heads ({q.shape[1]}) must be divisible by "
                         f"num_kv_heads ({k.shape[1]})")
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    window_left, window_right = (int(w) for w in window_size)
    if causal:
        window_right = 0
    args = (q, k, v, scale, window_left, window_right, float(logit_softcap),
            return_lse)
    if q.device.type == "cpu":
        return _prefill_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    return _prefill_cuda(*args)
