"""Pipeline parallelism (GPipe) over a "pipe" mesh axis (counterpart of
mfa_tpu/shard/pipeline.py).

mfa_tpu runs the whole schedule as one scan in which every stage executes
the same tick program, gated by `where` on its axis index. Here each rank
runs only its own contiguous block of L / S layers, and holds only those
(rank p of S holds layers [p L / S, (p + 1) L / S), llama.stage_layers,
beside the embedding, final norm and head): stage 0 embeds microbatch m, each stage
receives m's activations from the stage before (recv_from), runs its
block and sends them on (send_to), and the last stage takes the final
norm, the head and the loss. Stage p works on microbatch m at tick m + p,
so M microbatches cross S stages in M + S - 1 ticks (efficiency M / (M + S
- 1)). The backward runs the same way in reverse: the last stage starts
each microbatch's backward from its loss, and each stage sends the
gradient of its received activations back. The embedding's gradient lands
on stage 0 and the head's on the last stage; both are summed over "pipe"
by all-reduce, so every rank holds them.

Uniform layer stacks only (no sliding pattern or MoE interleave, whose
periods would have to divide the stage boundary), as in mfa_tpu.
"""

from __future__ import annotations

from typing import Optional

import torch

from mfa_tpu_torch.shard.mesh import (PIPE_AXIS, axis_index, axis_size, psum,
                                      recv_from, send_to)

_SHARED = ("embed", "final_norm", "lm_head")


def _plan(params, tokens, cfg, mesh, n_micro):
    """Validate -> (stages, microbatches, this rank's layer range)."""
    from mfa_tpu_torch.models import llama

    mine = llama.stage_layers(cfg, mesh)
    if cfg.layer_pattern is not None or cfg.moe_hetero:  # at one stage too
        raise ValueError("pipeline stages need a uniform layer stack")
    if len(params["layers"]) != len(mine):
        raise ValueError(f"params hold {len(params['layers'])} layers, the "
                         f"stage {len(mine)}: give a rank its stage's tree "
                         "(init_params / params_from_numpy / shard_params "
                         "with the mesh)")
    n_stages = axis_size(mesh, PIPE_AXIS)
    n_micro = n_micro or n_stages
    if tokens.shape[0] % n_micro:
        raise ValueError(f"batch {tokens.shape[0]} must divide into "
                         f"{n_micro} microbatches")
    return n_stages, n_micro, mine


def _run(params, tokens, cfg, mesh, n_micro, backward: bool):
    """The GPipe schedule on this rank (module docstring) -> the loss (fp32
    scalar, the same on every rank). backward: also run the backward
    schedule, leaving this rank's gradients in .grad."""
    from mfa_tpu_torch.models import llama

    n_stages, n_micro, mine = _plan(params, tokens, cfg, mesh, n_micro)
    p = axis_index(mesh, PIPE_AXIS)
    first, last = p == 0, p == n_stages - 1
    dev = params["final_norm"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    batch, seq = tokens.shape
    micro = tokens.reshape(n_micro, batch // n_micro, seq)
    shape = (batch // n_micro, seq - 1, cfg.dim)
    dtype = cfg.dtype
    positions = torch.arange(seq - 1, device=dev)[None]
    plan = llama._layer_ropes(cfg, positions)
    layers = [(lp, *plan[i]) for lp, i in zip(params["layers"], mine)]
    n_tokens = batch * (seq - 1)
    received, outs = [], []
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for m in range(n_micro):
        with torch.set_grad_enabled(backward):
            x_in = None
            if first:
                x = llama._embed(params, micro[m][:, :-1], cfg)
            else:
                x = x_in = recv_from(shape, dtype, dev, mesh, PIPE_AXIS, p - 1)
                x_in.requires_grad_(backward)
            for lp, wl, rope in layers:
                x = llama._train_layer(x, lp, wl, rope, cfg)
            if last:
                h = llama._rms_norm(x, params["final_norm"], cfg)
                logits = llama._unembed(params, h, cfg)
                out = torch.nn.functional.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]),
                    micro[m][:, 1:].reshape(-1), reduction="sum") / n_tokens
                loss_sum = loss_sum + out.detach()
            else:
                send_to(x.detach(), mesh, PIPE_AXIS, p + 1)
                out = x
        received.append(x_in)
        outs.append(out)
    if backward:
        for m in reversed(range(n_micro)):
            if last:
                outs[m].backward()
            else:
                outs[m].backward(recv_from(shape, dtype, dev, mesh, PIPE_AXIS,
                                           p + 1))
            if not first:
                send_to(received[m].grad, mesh, PIPE_AXIS, p - 1)
            outs[m] = received[m] = None
    return psum(loss_sum, mesh, PIPE_AXIS)


def pipeline_loss_fn(params, tokens, cfg, mesh,
                     n_micro: Optional[int] = None) -> torch.Tensor:
    """Next-token cross entropy of tokens [b, s] (the same on every rank),
    pipelined over "pipe" with n_micro microbatches (default: one a
    stage). Equal to llama.loss_fn; the same on every rank. params: the
    rank's stage tree (llama.stage_layers: init_params, params_from_numpy
    or shard_params with the mesh), its own layers and the embedding,
    final norm and head. Forward only: the gradients come from
    pipeline_value_and_grad."""
    with torch.no_grad():
        return _run(params, tokens, cfg, mesh, n_micro, backward=False)


def _local_leaves(params):
    leaves = [w for lp in params["layers"] for w in lp.values()]
    return leaves + [params[k] for k in _SHARED]


def pipeline_value_and_grad(params, tokens, cfg, mesh,
                            n_micro: Optional[int] = None):
    """-> (loss, grads): the forward and backward GPipe schedules. grads
    mirrors the stage tree: its layers' gradients and the embedding's,
    final norm's and head's, summed over "pipe" (every rank holds them),
    equal to the unsharded gradients. They are also left in the params'
    .grad."""
    from mfa_tpu_torch.models import llama

    llama._refuse_qweights(params, "pipeline_value_and_grad")
    _plan(params, tokens, cfg, mesh, n_micro)
    for w in _local_leaves(params):
        w.requires_grad_(True)
        w.grad = None
    loss = _run(params, tokens, cfg, mesh, n_micro, backward=True)
    grads = {}
    for k in _SHARED:
        g = params[k].grad
        params[k].grad = grads[k] = psum(
            torch.zeros_like(params[k]) if g is None else g, mesh, PIPE_AXIS)
    grads["layers"] = [{k: w.grad for k, w in lp.items()}
                       for lp in params["layers"]]
    return loss, grads


def pipeline_train_step(params, tokens, cfg, mesh,
                        n_micro: Optional[int] = None, lr: float = 1e-3):
    """One SGD step through the pipelined loss -> (params, loss). A rank
    updates its stage tree in place: its layers, and the embedding, final
    norm and head (the same on every rank after the all-reduce)."""
    loss, grads = pipeline_value_and_grad(params, tokens, cfg, mesh, n_micro)
    with torch.no_grad():
        for k in _SHARED:
            params[k].sub_(lr * grads[k].to(params[k].dtype))
        for lp, g in zip(params["layers"], grads["layers"]):
            for k, w in lp.items():
                w.sub_(lr * g[k].to(w.dtype))
    return params, loss.detach()
