"""Differentiable flash attention (counterpart of mfa_tpu/kernels/autodiff.py).

`torch.autograd.Function`s whose forward is the port's prefill or packed
varlen kernel with its LSE, and whose backward is the flash backward of
kernels/backward.py (the fused kernel, or the varlen split). They save q,
k, v, O and LSE, as the JAX custom VJP does, and never the score matrix.
On CPU tensors both directions run the plain versions.

Non-tensor arguments (causal, scale, window, softcap, sinks, the
cu_seqlens tables) get no gradient; ALiBi slopes get zeros, as in JAX
(a bias of positions only).
"""

from __future__ import annotations

from typing import Optional

import torch

from mfa_tpu_torch.kernels.backward import (flash_attention_bwd,
                                            varlen_attention_bwd)
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.kernels.varlen import varlen_attention


def _zero_slopes(slopes):
    return None if slopes is None else torch.zeros_like(slopes)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, alibi_slopes, causal, softmax_scale,
                window_size, logit_softcap, sink_tokens):
        out, lse = prefill_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, logit_softcap=logit_softcap,
            sink_tokens=sink_tokens, alibi_slopes=alibi_slopes,
            return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.slopes = alibi_slopes
        ctx.opts = dict(causal=causal, softmax_scale=softmax_scale,
                        window_size=window_size, logit_softcap=logit_softcap,
                        sink_tokens=sink_tokens)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         alibi_slopes=ctx.slopes, **ctx.opts)
        return (dq, dk, dv, _zero_slopes(ctx.slopes)) + (None,) * 5


def flash_attention_grad(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    logit_softcap: float = 0.0,
    sink_tokens: int = 0,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable attention on the [batch, heads, seq, head_dim] layout
    (the arguments of kernels/prefill.prefill_attention). Forward: the
    prefill engines with return_lse; backward: flash_attention_bwd (fused
    kernel). sink_tokens (with a left window) and alibi_slopes [heads] as
    in the forward; the slopes' gradient is zero."""
    return _FlashAttention.apply(q, k, v, alibi_slopes, bool(causal),
                                 softmax_scale, tuple(window_size),
                                 float(logit_softcap), int(sink_tokens))


class _VarlenAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, alibi_slopes, cu_q, cu_k, max_seqlen_q,
                max_seqlen_k, causal, softmax_scale, window_size,
                logit_softcap):
        out, lse = varlen_attention(
            q, k, v, cu_q, cu_k, max_seqlen_q, max_seqlen_k, causal=causal,
            softmax_scale=softmax_scale, window_size=window_size,
            logit_softcap=logit_softcap, alibi_slopes=alibi_slopes,
            return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, cu_q, cu_k)
        ctx.slopes = alibi_slopes
        ctx.opts = dict(causal=causal, softmax_scale=softmax_scale,
                        window_size=window_size, logit_softcap=logit_softcap,
                        max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, cu_q, cu_k = ctx.saved_tensors
        dq, dk, dv = varlen_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                          cu_q, cu_k, alibi_slopes=ctx.slopes,
                                          **ctx.opts)
        return (dq, dk, dv, _zero_slopes(ctx.slopes)) + (None,) * 8


def flash_attn_varlen_func_grad(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int,
    max_seqlen_k: int,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    logit_softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable flash_attn_varlen_func on the packed layout: q
    [total_q, heads, head_dim], k/v [total_k, kv_heads, head_dim],
    cu_seqlens [batch + 1]. Forward: the packed varlen kernel with its LSE;
    backward: varlen_attention_bwd (the varlen split). alibi_slopes
    [heads] on each sequence's positions, zero gradient. The paged
    (block_table) route is inference-only, as in JAX."""
    cu_q = torch.as_tensor(cu_seqlens_q, device=q.device).to(torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=q.device).to(torch.int32)
    return _VarlenAttention.apply(q, k, v, alibi_slopes, cu_q, cu_k,
                                  int(max_seqlen_q),
                                  int(max_seqlen_k), bool(causal),
                                  softmax_scale, tuple(window_size),
                                  float(logit_softcap))


def flash_attn_func_grad(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    window_size: tuple = (-1, -1),
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable flash_attn_func on the public [b, s, h, d] layout."""
    out = flash_attention_grad(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal, softmax_scale,
                               tuple(window_size), 0.0, 0, alibi_slopes)
    return out.transpose(1, 2)
