"""Differentiable flash attention (counterpart of mfa_tpu/kernels/autodiff.py).

`torch.autograd.Function`s whose forward is the port's prefill or packed
varlen kernel with its LSE, and whose backward is the flash backward of
kernels/backward.py (the fused kernel, or the varlen split). They save q,
k, v, O and LSE, as the JAX custom VJP does, and never the score matrix.
On CPU tensors both directions run the plain versions.

Non-tensor arguments (causal, scale, window, softcap, the cu_seqlens
tables) get no gradient. ALiBi and attention sinks are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from mfa_tpu_torch.kernels.backward import (flash_attention_bwd,
                                            varlen_attention_bwd)
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.kernels.varlen import varlen_attention


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale, window_size,
                logit_softcap):
        out, lse = prefill_attention(
            q, k, v, causal=causal, softmax_scale=softmax_scale,
            window_size=window_size, logit_softcap=logit_softcap,
            return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, softmax_scale=softmax_scale,
                        window_size=window_size, logit_softcap=logit_softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None


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
    (the arguments of kernels/prefill.prefill_attention). Forward: kernel 1
    with return_lse; backward: flash_attention_bwd (fused kernel)."""
    if alibi_slopes is not None or sink_tokens:
        raise NotImplementedError("alibi_slopes and sink_tokens are not "
                                  "ported yet")
    return _FlashAttention.apply(q, k, v, bool(causal), softmax_scale,
                                 tuple(window_size), float(logit_softcap))


class _VarlenAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, max_seqlen_q, max_seqlen_k, causal,
                softmax_scale, window_size, logit_softcap):
        out, lse = varlen_attention(
            q, k, v, cu_q, cu_k, max_seqlen_q, max_seqlen_k, causal=causal,
            softmax_scale=softmax_scale, window_size=window_size,
            logit_softcap=logit_softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, cu_q, cu_k)
        ctx.opts = dict(causal=causal, softmax_scale=softmax_scale,
                        window_size=window_size, logit_softcap=logit_softcap,
                        max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, cu_q, cu_k = ctx.saved_tensors
        dq, dk, dv = varlen_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                          cu_q, cu_k, **ctx.opts)
        return (dq, dk, dv) + (None,) * 8


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
    backward: varlen_attention_bwd (the varlen split). The paged
    (block_table) route is inference-only, as in JAX."""
    if alibi_slopes is not None:
        raise NotImplementedError("alibi_slopes is not ported yet")
    cu_q = torch.as_tensor(cu_seqlens_q, device=q.device).to(torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=q.device).to(torch.int32)
    return _VarlenAttention.apply(q, k, v, cu_q, cu_k, int(max_seqlen_q),
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
