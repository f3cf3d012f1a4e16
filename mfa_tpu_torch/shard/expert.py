"""Expert parallelism (EP) for MoE layers (counterpart of
mfa_tpu/shard/expert.py).

- The banks [E, d, f] / [E, f, d] are sharded on the "expert" axis (a
  rank holds E / ep experts), optionally with "model" tensor parallelism
  on the ffn dim (llama.param_shardings).
- The router is replicated and every rank computes the same global top-k
  routing, so routing costs no traffic.
- expert_parallel_moe (serving): each rank runs its local experts over the
  token assignments that landed on them, and one psum of the [T, d]
  output over "expert" (and "model") combines. Assignments sort stably
  with the other ranks' keyed last, so the local groups are an exact
  prefix of one grouped launch a projection (wquant.bank_grouped: kernel
  10's expert launch on int8 banks); at most _MOE_DENSE_MAX_T rows, and
  in graphed steps, every local expert runs over every row
  (wquant.bank_dense), with no host read.
- expert_parallel_moe_a2a (training): tokens sharded on "expert", each
  rank routes its own, ships them to the owning rank in capacity-bounded
  slots (all_to_all), runs its experts, and a second all_to_all returns
  the results for the weighted combine. Assignments past a peer's
  capacity drop. Every step is differentiable; the exchange's backward is
  the reverse all_to_all.
"""

from __future__ import annotations

import math

import torch

from mfa_tpu_torch.models.wquant import bank_dense, bank_grouped
from mfa_tpu_torch.shard.mesh import (EXPERT_AXIS, MODEL_AXIS, all_to_all,
                                      axis_index, axis_size, copy_to,
                                      reduce_from)


def use_expert_parallel(mesh) -> bool:
    return axis_size(mesh, EXPERT_AXIS) > 1


def _local_experts(t, weg, weu, wed, loc, valid, w_top, cfg, dense: bool):
    """Routed output of this rank's experts: loc [T, k] local expert ids,
    valid [T, k] whether the assignment is local."""
    from mfa_tpu_torch.models.llama import _act, _slot_sum

    T, k = loc.shape
    e_local = weg.shape[0]
    if dense:
        g = _act(bank_dense(t, weg), cfg.hidden_act)
        o = bank_dense(g * bank_dense(t, weu), wed)  # [E_l, T, d]
        key = torch.where(valid, loc, torch.full_like(loc, e_local))
        mw = torch.zeros((T, e_local + 1), dtype=torch.float32,
                         device=t.device).scatter(1, key, w_top)[:, :e_local]
        return torch.einsum("etd,te->td", o, mw.to(o.dtype))
    key = torch.where(valid, loc, torch.full_like(loc, e_local)).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    gathered = t[order // k]
    offs = torch.searchsorted(sorted_key, torch.arange(
        e_local + 1, device=t.device, dtype=sorted_key.dtype)).to(torch.int32)
    gate = _act(bank_grouped(gathered, weg, offs, T), cfg.hidden_act)
    down = bank_grouped(gate * bank_grouped(gathered, weu, offs, T), wed, offs, T)
    # rows past the local prefix are unspecified: they contribute nothing
    down = torch.where(valid.reshape(-1)[order][:, None], down,
                       torch.zeros_like(down))
    return _slot_sum(down, w_top, order)


def expert_parallel_moe(mesh, cfg, dense: bool = False):
    """-> f(t, w_router, we_gate, we_up, we_down) -> [T, d], the routed
    expert output (no shared expert, no residual) on every rank: t [T, d]
    and w_router [d, E] the same on every rank, the banks this rank's
    block (E / ep experts; the ffn dim on "model" under TP). dense: every
    local expert over every row (graphed steps; also at most
    _MOE_DENSE_MAX_T rows)."""
    k = cfg.n_active_experts

    def fn(t, w_router, weg, weu, wed):
        from mfa_tpu_torch.models.llama import _MOE_DENSE_MAX_T, _moe_route

        w_top, idx = _moe_route(t, w_router, k, cfg.norm_topk)
        loc = idx - axis_index(mesh, EXPERT_AXIS) * weg.shape[0]
        valid = (loc >= 0) & (loc < weg.shape[0])
        out = _local_experts(t, weg, weu, wed, loc, valid, w_top, cfg,
                             dense or t.shape[0] <= _MOE_DENSE_MAX_T)
        return reduce_from(out, mesh, (EXPERT_AXIS, MODEL_AXIS))

    return fn


class _AllToAll(torch.autograd.Function):
    """all_to_all over the expert axis; its transpose is itself."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_to_all(x, mesh, EXPERT_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad.contiguous(), ctx.mesh, EXPERT_AXIS), None


def expert_parallel_moe_a2a(mesh, cfg, capacity_factor: float = 2.0):
    """Training-shaped EP (module docstring) -> f(t, w_router, we_gate,
    we_up, we_down) -> [Tl, d] with t this rank's Tl = T / ep tokens (in
    rank order) and the banks its E / ep experts. A rank sends each peer
    cap = ceil(Tl * k / ep * capacity_factor) slots; assignments beyond a
    peer's capacity are dropped (the dropless serving path is
    expert_parallel_moe)."""
    k = cfg.n_active_experts
    ep = axis_size(mesh, EXPERT_AXIS)
    has_tp = axis_size(mesh, MODEL_AXIS) > 1

    def fn(t, w_router, weg, weu, wed):
        from mfa_tpu_torch.models.llama import _act, _moe_route, _slot_sum

        Tl, d = t.shape
        e_local = weg.shape[0]
        A = Tl * k
        cap = max(1, int(math.ceil(A / ep * capacity_factor)))
        dev = t.device
        w_top, idx = _moe_route(t, w_router, k, cfg.norm_topk)
        flat_e = idx.reshape(-1)
        dest_s, order = torch.sort(flat_e // e_local, stable=True)
        le_s = (flat_e % e_local)[order]
        tok_s = order // k
        first = torch.searchsorted(dest_s, torch.arange(ep, device=dev,
                                                        dtype=dest_s.dtype))
        slot = torch.arange(A, device=dev) - first[dest_s]
        keep = slot < cap
        tgt = torch.where(keep, dest_s * cap + slot,
                          torch.full_like(slot, ep * cap))  # the dropped row
        send_x = torch.zeros((ep * cap + 1, d), dtype=t.dtype, device=dev
                             ).index_put((tgt,), t[tok_s])[:-1]
        send_le = torch.full((ep * cap + 1,), e_local, dtype=torch.long,
                             device=dev).index_put((tgt,), le_s)[:-1]
        xa = _AllToAll.apply(send_x.reshape(ep, cap, d), mesh).reshape(ep * cap, d)
        lea = all_to_all(send_le.reshape(ep, cap), mesh, EXPERT_AXIS).reshape(-1)
        valid = lea < e_local  # unfilled slots are excluded
        sorted_key, order2 = torch.sort(lea, stable=True)
        xs = xa[order2]
        if has_tp:  # replicated over "model", each rank a partial gradient
            xs = copy_to(xs, mesh, MODEL_AXIS)
        offs = torch.searchsorted(sorted_key, torch.arange(
            e_local + 1, device=dev, dtype=sorted_key.dtype)).to(torch.int32)
        rows = ep * cap
        gate = _act(bank_grouped(xs, weg, offs, rows), cfg.hidden_act)
        down = bank_grouped(gate * bank_grouped(xs, weu, offs, rows), wed,
                            offs, rows)
        down = torch.where(valid[order2][:, None], down, torch.zeros_like(down))
        if has_tp:  # the ffn dim is TP-sharded: partial sums
            down = reduce_from(down, mesh, MODEL_AXIS)
        ya = torch.zeros_like(down).index_put((order2,), down)
        back = _AllToAll.apply(ya.reshape(ep, cap, d), mesh).reshape(rows, d)
        # a kept assignment's result is at its send slot; a dropped one adds 0
        contrib = back[tgt.clamp(max=rows - 1)]
        contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
        return _slot_sum(contrib, w_top, order)

    return fn
