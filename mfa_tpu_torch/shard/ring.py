"""Ring attention: context-parallel prefill and training over the "ctx"
axis (counterpart of mfa_tpu/shard/ring.py).

Q and KV are sharded along the sequence: each rank holds one chunk of
[batch, heads, seq, head_dim]. KV chunks rotate around the ring
(ring_shift: batch_isend_irecv to the next rank), and each rank folds
every visiting chunk into its running (O fp32, LSE) pair with the
max-normalized merge of the split-KV combine. Every pair is one call of
the port's prefill kernel (kernels 1-4) with kv_position_offset and
return_lse; the training backward is a second ring pass of the fused
backward kernel (kernel 11) with the same offsets.

Causal handling of a visiting chunk from rank src (mine: my):
  src <  my : visible up to the window -> the kernel at offset step*chunk
  src == my : the diagonal             -> the causal kernel at offset 0
  src >  my : in the future            -> skipped (O 0, LSE -inf)
Every rank still forwards the KV it holds at every step, so the ranks
enter every collective in the same order. A causal left window stops the
rotation after the last step that can hold a visible column; a
non-causal band (window_left, window_right) runs two streams, the chunks
behind rotating forward and the chunks ahead backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from mfa_tpu_torch.kernels.backward import flash_attention_bwd
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.shard.mesh import (CTX_AXIS, axis_index, axis_size,
                                      reduce_from, ring_shift)


def _merge(o1, lse1, o2, lse2):
    """Merge two normalized partial attention results (fp32)."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w1 = torch.where(torch.isneginf(lse1), torch.zeros_like(lse1),
                     torch.exp(lse1 - m_safe))
    w2 = torch.where(torch.isneginf(lse2), torch.zeros_like(lse2),
                     torch.exp(lse2 - m_safe))
    denom = w1 + w2
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / denom_safe[..., None]
    lse = torch.where(denom == 0.0, torch.full_like(denom, float("-inf")),
                      m_safe + torch.log(denom_safe))
    return o, lse


def _ring_live_steps(n_ring: int, chunk: int, window_left: int) -> int:
    """Ring steps (the diagonal step 0 included) whose KV chunk can hold a
    visible column under a causal left window: step t is live iff t *
    chunk <= window_left + chunk - 1. Unbounded window -> n_ring."""
    if window_left < 0:
        return n_ring
    return min(n_ring, (window_left + chunk - 1) // chunk + 1)


def _band_hops(n_ring: int, chunk: int, w: int) -> int:
    """Hops in ONE direction whose visiting chunk can hold a visible column
    under band half-width w: hop t's nearest column is (t - 1) * chunk + 1
    positions away, so t is live iff (t - 1) * chunk < w. Unbounded (w <
    0) -> every other chunk."""
    if w < 0:
        return n_ring - 1
    return min(n_ring - 1, (w - 1) // chunk + 1)


def _masked(q):
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32,
                       device=q.device))


def _pair(q, k, v, scale, **kw):
    o, lse = prefill_attention(q, k, v, softmax_scale=scale, return_lse=True,
                               **kw)
    return o.float(), lse


def _ring_forward_banded(q, k, v, mesh, ctx_axis: str, scale,
                         window_left: int, window_right: int):
    """The non-causal band over the ring, two streams. An ahead pair is the
    mirror of a behind pair: flipping the q rows and the kv columns and
    swapping the window sides maps "kv h hops ahead" onto the positive
    kv_position_offset the kernel takes."""
    n, my, chunk = axis_size(mesh, ctx_axis), axis_index(mesh, ctx_axis), q.shape[2]
    q_rev = torch.flip(q, [2])

    def behind(kv, t):
        if t and my < t:  # a wrapped source is outside the sequence
            return _masked(q)
        return _pair(q, kv[0], kv[1], scale, causal=False,
                     window_size=(window_left, window_right),
                     kv_position_offset=t * chunk)

    def ahead(kv, h):
        if my + h >= n:
            return _masked(q)
        o, lse = _pair(q_rev, torch.flip(kv[0], [2]), torch.flip(kv[1], [2]),
                       scale, causal=False,
                       window_size=(window_right, window_left),
                       kv_position_offset=h * chunk)
        return torch.flip(o, [2]), torch.flip(lse, [2])

    back_hops = _band_hops(n, chunk, window_left)
    fwd_hops = _band_hops(n, chunk, window_right)
    o_acc, lse_acc = behind((k, v), 0)
    kv_b = kv_f = (k, v)
    for t in range(1, max(back_hops, fwd_hops) + 1):
        if t <= back_hops:
            kv_b = ring_shift(kv_b, mesh, ctx_axis, 1)
            o_acc, lse_acc = _merge(o_acc, lse_acc, *behind(kv_b, t))
        if t <= fwd_hops:
            kv_f = ring_shift(kv_f, mesh, ctx_axis, -1)
            o_acc, lse_acc = _merge(o_acc, lse_acc, *ahead(kv_f, t))
    return o_acc.to(q.dtype), lse_acc


def _ring_forward(q, k, v, mesh, ctx_axis: str, causal: bool, scale,
                  window_left: int = -1, window_right: int = -1):
    """The rotating-KV forward on this rank's [b, h, s / n, d] chunks ->
    (O in q's dtype, the global LSE fp32). Shared by ring_attention_prefill
    and the training Function."""
    if not causal and (window_left >= 0 or window_right >= 0):
        return _ring_forward_banded(q, k, v, mesh, ctx_axis, scale,
                                    window_left, window_right)
    n, my, chunk = axis_size(mesh, ctx_axis), axis_index(mesh, ctx_axis), q.shape[2]

    def partial_attn(kv, step):
        if not causal:
            return _pair(q, kv[0], kv[1], scale, causal=False)
        if step and my < step:  # the source is in this chunk's future
            return _masked(q)
        return _pair(q, kv[0], kv[1], scale, causal=True,
                     window_size=(window_left, -1),
                     kv_position_offset=step * chunk)

    kv = (k, v)
    o_acc, lse_acc = partial_attn(kv, 0)
    for step in range(1, _ring_live_steps(n, chunk, window_left)):
        kv = ring_shift(kv, mesh, ctx_axis, 1)
        o_acc, lse_acc = _merge(o_acc, lse_acc, *partial_attn(kv, step))
    return o_acc.to(q.dtype), lse_acc


def ring_attention_prefill(mesh, causal: bool = True,
                           softmax_scale: Optional[float] = None,
                           ctx_axis: str = CTX_AXIS, window_left: int = -1,
                           window_right: int = -1):
    """-> f(q, k, v) on this rank's chunk of [batch, heads, seq, head_dim]
    (seq sharded on ctx_axis in rank order), returning its chunk of O.
    window_left (causal) slides a window across the ring and the rotation
    stops after the window's last reachable chunk; causal=False with a
    (window_left, window_right) band is bidirectional local attention
    (two streams; either side -1 = unbounded)."""

    def fn(q, k, v):
        return _ring_forward(q, k, v, mesh, ctx_axis, causal, softmax_scale,
                             window_left, window_right)[0]

    return fn


class _RingAttention(torch.autograd.Function):
    """Differentiable ring attention on this rank's chunks. The forward is
    the rotating-KV schedule, keeping the global LSE. With the global LSE
    (and delta = rowsum(dO * O), which has no KV dependence) each visiting
    chunk's (dQ part, dK, dV) is the dense backward kernel on that block:
    a second ring pass, dK/dV accumulating in fp32 while they ride along
    with their chunk, and one closing shift brings them home."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, ctx_axis, causal, scale, window_left):
        out, lse = _ring_forward(q, k, v, mesh, ctx_axis, causal, scale,
                                 window_left)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (mesh, ctx_axis, causal, scale, window_left)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, ctx_axis, causal, scale, window_left = ctx.opts
        n, my, chunk = axis_size(mesh, ctx_axis), axis_index(mesh, ctx_axis), q.shape[2]
        lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
        do = do.contiguous()

        def partial_bwd(k_blk, v_blk, step):
            if not causal:
                return flash_attention_bwd(q, k_blk, v_blk, out, lse_safe, do,
                                           causal=False, softmax_scale=scale)
            if step and my < step:
                return None
            return flash_attention_bwd(
                q, k_blk, v_blk, out, lse_safe, do, causal=True,
                window_size=(window_left, -1), kv_position_offset=step * chunk,
                softmax_scale=scale)

        # dK/dV ride the ring in fp32 (bf16 += would lose low bits across
        # the partial sums)
        k_blk, v_blk = k, v
        dk_t = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_t = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        live = _ring_live_steps(n, chunk, window_left)
        for step in range(live):
            if step:
                k_blk, v_blk, dk_t, dv_t = ring_shift(
                    (k_blk, v_blk, dk_t, dv_t), mesh, ctx_axis, 1)
            grads = partial_bwd(k_blk, v_blk, step)
            if grads is not None:
                dq += grads[0].float()
                dk_t = dk_t + grads[1].float()
                dv_t = dv_t + grads[2].float()
        # after live - 1 shifts this rank holds the accumulators of the
        # chunk live - 1 back: ONE shift by live - 1 hops home
        dk_t, dv_t = ring_shift((dk_t, dv_t), mesh, ctx_axis, -(live - 1))
        return (dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype),
                None, None, None, None, None)


def ring_attention_grad(mesh, causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        ctx_axis: str = CTX_AXIS, window_left: int = -1):
    """Differentiable ring attention (mfa_tpu's custom VJP, _RingAttention)
    on this rank's chunk of [batch, heads, seq, head_dim]: context /
    sequence-parallel training. window_left (causal only): a sliding
    window across the ring, the rotation stopping at its edge in both
    passes."""
    if not causal and window_left >= 0:
        raise NotImplementedError(
            "non-causal windowed ring attention is inference-only "
            "(ring_attention_prefill); the backward ring schedule is causal")

    def fn(q, k, v):
        return _RingAttention.apply(q, k, v, mesh, ctx_axis, causal,
                                    softmax_scale, window_left)

    return fn


def sequence_parallel_loss_fn(params, tokens, cfg, mesh,
                              ctx_axis: str = CTX_AXIS):
    """Next-token cross entropy with the activations sequence-sharded on
    ctx_axis and every layer's attention the differentiable ring: long
    context training where one card cannot hold the sequence.

    tokens [b, s] are the same on every rank. Each rank embeds its own
    slice of tokens[:, :-1] (RoPE at the slice's absolute positions) and
    runs every layer on its [b, (s - 1) / n, dim] activations; the targets
    are the replicated tokens at offset + 1, so the next-token shift needs
    no activation traffic beyond the ring. The loss is summed over the
    axis and equals llama.loss_fn on every rank; loss.backward() gives
    every rank the full gradients (the params' gradients are summed over
    the axis). Uniform layer stacks and causal attention with an optional
    sliding window only."""
    from mfa_tpu_torch.models import llama

    n = axis_size(mesh, ctx_axis)
    batch, seq = tokens.shape
    if (seq - 1) % n:
        raise ValueError(f"seq-1 ({seq - 1}) must divide over {n} context "
                         "shards")
    if cfg.layer_pattern is not None or cfg.moe_hetero:
        raise ValueError("sequence-parallel training needs a uniform layer "
                         "stack")
    if cfg.attn_softcap or cfg.attn_sinks:
        raise ValueError("sequence-parallel training supports causal "
                         "attention with an optional sliding window only "
                         "(no softcap / sinks)")
    llama._refuse_qweights(params, "sequence_parallel_loss_fn")
    chunk = (seq - 1) // n
    start = axis_index(mesh, ctx_axis) * chunk
    ring = ring_attention_grad(mesh, True, cfg.attn_scale, ctx_axis,
                               cfg.window_left)
    # the params' gradients sum over the axis (the transpose of mfa_tpu's
    # replicated in_specs)
    p = llama._tree_copy_to(params, mesh, ctx_axis)
    tokens = torch.as_tensor(tokens, device=p["final_norm"].device).long()
    inp = tokens[:, start:start + chunk]
    tgt = tokens[:, start + 1:start + 1 + chunk]
    x = llama._embed(p, inp, cfg)
    positions = start + torch.arange(chunk, device=x.device)[None]
    for lp, (_, rope) in zip(p["layers"], llama._layer_ropes(cfg, positions)):
        h = llama._rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = llama._qkv(h, lp, cfg, batch, chunk)
        q, k = llama._apply_rope(q, *rope), llama._apply_rope(k, *rope)
        attn = ring(q.transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2)).transpose(1, 2)
        x = llama._attn_residual(x, attn.reshape(batch, chunk, -1), lp, cfg)
        x = llama._mlp(x, lp, cfg)
    x = llama._rms_norm(x, p["final_norm"], cfg)
    logits = llama._unembed(p, x, cfg)
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1), reduction="sum")
    return reduce_from(nll, mesh, ctx_axis) / (batch * (seq - 1))
