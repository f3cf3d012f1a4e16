"""INT8 weight quantization for serving (counterpart of mfa_tpu/models/wquant.py).

A `QWeight` holds an int8 payload and one fp32 scale per output channel
(symmetric absmax). Matmul weights [in, out] quantize along the input axis
(axis=-2: one scale per output column), embedding tables per row
(axis=-1). `qmm` is the one matmul entry of models/llama.py: for a QWeight
it computes (x @ qw) * scale, which is exact because the per-column scale
commutes with the contraction; on the card that is kernel 10
(kernels/wmatmul.py), on the CPU its plain version. `qtake` gathers
embedding rows and dequantizes only them, in bf16 whatever the model
dtype, as JAX does. Gradients are not defined through QWeight: serving
only.

MoE expert banks are 3-D: a QWeight [E, K, N] with scale [E, N],
quantized one expert slice at a time. `bank_dense` (every expert over the
same rows or rows of its own) and `bank_grouped` (expert e over its rows
of expert-sorted x) take a QWeight bank to kernel 10's expert launch
(kernels/wmatmul.int8_bank_matmul) and a bf16 bank to torch.matmul;
`ragged_qmm` is mfa_tpu's entry point over group sizes.

Meshes: `adapt_shardings` rewrites a per-param Sharding tree
(llama.param_shardings) for a quantized params tree: a QWeight's qw takes
the param's spec, its scale the spec with the reduced axis dropped
(`adapt`). llama.shard_params then slices each tensor, so kernel 10 runs
on the rank's columns (N / tp for wq, w_gate, w_up) or rows (K / tp for
wo, w_down) with their own scales.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mfa_tpu_torch.kernels.quant import scale_of
from mfa_tpu_torch.kernels.wmatmul import int8_bank_matmul, int8_matmul
from mfa_tpu_torch.shard.mesh import Sharding

__all__ = [
    "QWeight",
    "quantize_weight",
    "stack_bank",
    "dequantize_weight",
    "qmm",
    "qtake",
    "bank_dense",
    "bank_grouped",
    "ragged_qmm",
    "quantize_params",
    "adapt",
    "adapt_shardings",
    "params_nbytes",
]


@dataclasses.dataclass
class QWeight:
    """Per-channel symmetric int8 weight. qw: int8; scale: fp32, qw's shape
    with `axis` removed; axis: the reduced axis as a negative index (-2 for
    [in, out] matmul weights, -1 for embedding tables)."""

    qw: torch.Tensor
    scale: torch.Tensor
    axis: int = -2

    @property
    def shape(self):
        return self.qw.shape

    @property
    def ndim(self):
        return self.qw.ndim

    def to(self, device) -> "QWeight":
        return QWeight(self.qw.to(device), self.scale.to(device), self.axis)


def _quantize_body(w, axis: int):
    wf = w.float()
    # mfa_tpu's _quantize_body is jitted: absmax * f32(1 / 127)
    scale = scale_of(wf.abs().amax(dim=axis), 127.0, reciprocal=True)
    qw = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127)
    return qw.to(torch.int8), scale


def quantize_weight(w: torch.Tensor, axis: int = -2) -> QWeight:
    """Symmetric absmax int8 quantization along `axis`: scale = absmax *
    f32(1 / 127) as mfa_tpu's jitted body computes it (1 where absmax is
    0), round half to even, clip to +-127. A large 2-D
    tensor quantizes in slices along its other axis, which caps the fp32
    transient (a 128k-vocab table is 2.1 GB in fp32); an expert bank [E, K,
    N] (axis -2) one expert at a time (Mixtral's is 1.9 GB in fp32)."""
    axis = axis if axis < 0 else axis - w.ndim
    if w.ndim == 3 and axis == -2:
        return stack_bank((w[e] for e in range(w.shape[0])), w.shape[0], True)
    chunk_elems = 64 * 1024 * 1024
    if w.ndim == 2 and w.numel() > chunk_elems:
        split = 0 if axis == -1 else 1  # slice a dim that is not reduced
        n = w.shape[split]
        step = max(1, chunk_elems // max(1, w.numel() // n))
        pieces = [_quantize_body(w.narrow(split, lo, min(step, n - lo)), axis)
                  for lo in range(0, n, step)]
        return QWeight(qw=torch.cat([p[0] for p in pieces], dim=split),
                       scale=torch.cat([p[1] for p in pieces]), axis=axis)
    qw, scale = _quantize_body(w, axis)
    return QWeight(qw=qw, scale=scale, axis=axis)


def stack_bank(slices, n: int, quantize: bool) -> Any:
    """An expert bank [n, K, N] from n expert slices [K, N] taken one at a
    time from the iterable: a QWeight quantized slice by slice (scale [n,
    N]) under quantize, else a tensor. Only one slice exists beside the
    bank, so a bank drawn or read slice by slice never exists in 16 bits
    (let alone fp32) as a whole."""
    out = scale = None
    for e, w in enumerate(slices):
        if quantize:
            q = quantize_weight(w, axis=-2)
            w = q.qw
        if out is None:
            out = torch.empty((n, *w.shape), dtype=w.dtype, device=w.device)
            if quantize:
                scale = torch.empty((n, w.shape[1]), dtype=torch.float32,
                                    device=w.device)
        out[e] = w
        if quantize:
            scale[e] = q.scale
    return QWeight(qw=out, scale=scale, axis=-2) if quantize else out


def dequantize_weight(w: QWeight, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.qw.float() * w.scale.unsqueeze(w.axis)).to(dtype)


def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a plain tensor, or x [..., K] @ QWeight [K, N] (axis -2)
    through kernel 10 on the card and its plain version on the CPU."""
    if not isinstance(w, QWeight):
        return x @ w
    if w.axis != -2 or w.qw.ndim != 2:
        raise ValueError("qmm needs a 2-D per-output-channel QWeight (axis=-2)")
    lead = x.shape[:-1]
    out = int8_matmul(x.reshape(-1, x.shape[-1]), w.qw, w.scale)
    return out.reshape(*lead, out.shape[-1])


def qtake(w: Any, idx: torch.Tensor) -> torch.Tensor:
    """Embedding lookup w[idx] for a plain tensor or a row-quantized
    QWeight (axis -1): gathers int8 rows and their scales and dequantizes
    only those, in bf16."""
    if not isinstance(w, QWeight):
        return w[idx]
    if w.axis != -1:
        raise ValueError("qtake needs a per-row QWeight (axis=-1)")
    return (w.qw[idx].to(torch.bfloat16)
            * w.scale[idx][..., None].to(torch.bfloat16))


def bank_dense(x: torch.Tensor, w: Any) -> torch.Tensor:
    """out[e] = x_e @ w[e] for every expert of a bank w [E, K, N] (QWeight
    or tensor): x [T, K] (the same rows for every expert) or [E, T, K] ->
    [E, T, N]. A QWeight bank is one launch of kernel 10's expert launch on
    the card, mfa_tpu's _moe_dense_int8 einsums on the CPU."""
    if isinstance(w, QWeight):
        return int8_bank_matmul(x, w.qw, w.scale)
    return torch.matmul(x, w)


def bank_grouped(x: torch.Tensor, w: Any, offs: torch.Tensor,
                 max_rows: int) -> torch.Tensor:
    """Expert e of a bank w [E, K, N] over rows offs[e]:offs[e + 1] of
    expert-sorted x [R, K] -> [R, N]. offs: [E + 1] int32 on x's device;
    max_rows: the most rows one expert can own. Rows past offs[E] (the
    other ranks' assignments under expert parallelism) are unspecified. A
    QWeight bank is one launch of kernel 10's expert launch (no host
    read); a bf16 bank one torch.matmul an expert after one host read of
    offs (eager only), those rows zero."""
    if isinstance(w, QWeight):
        return int8_bank_matmul(x, w.qw, w.scale, offs=offs, max_rows=max_rows)
    bounds = offs.tolist()
    parts = [x[bounds[e]:bounds[e + 1]] @ w[e] for e in range(w.shape[0])]
    if bounds[-1] < x.shape[0]:
        parts.append(x.new_zeros((x.shape[0] - bounds[-1], w.shape[-1])))
    return torch.cat(parts)


def ragged_qmm(x: torch.Tensor, w: Any, group_sizes: torch.Tensor) -> torch.Tensor:
    """mfa_tpu's ragged_qmm: x [R, K] sorted by expert, group_sizes [E] rows
    an expert -> [R, N] through bank_grouped."""
    offs = torch.cat([group_sizes.new_zeros(1), torch.cumsum(group_sizes, 0)])
    return bank_grouped(x, w, offs.to(torch.int32), x.shape[0])


# Matmul weights quantized per output channel (mfa_tpu's _MATMUL_KEYS) and
# the expert banks; w_router (fp32, routing decides on near-ties) and the
# Qwen2-MoE w_shared_gate ([d, 1]) stay in full precision, as do norms and
# biases.
_MATMUL_KEYS = frozenset((
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "ws_gate", "ws_up", "ws_down", "lm_head",
))
_EXPERT_KEYS = frozenset(("we_gate", "we_up", "we_down"))


def quantize_params(params: dict, include_embed: bool = True,
                    include_experts: bool = False) -> dict:
    """A new params tree with the big projections (and, with include_embed,
    the embedding table per row; with include_experts, the MoE banks per
    expert and output channel) as QWeight; other leaves and leaves that
    are already QWeight pass through. Walks dicts and the list of layers."""

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, QWeight) or not isinstance(node, torch.Tensor):
            return node
        if key in _MATMUL_KEYS or (include_experts and key in _EXPERT_KEYS):
            return quantize_weight(node, axis=-2)
        if key == "embed" and include_embed:
            return quantize_weight(node, axis=-1)
        return node

    return walk(dict(params))


def adapt(sh: Sharding, w: Any) -> Any:
    """A param's Sharding for its value: the Sharding itself for a tensor;
    for a QWeight, QWeight(qw=sh, scale=sh without the reduced axis)."""
    if not isinstance(w, QWeight):
        return sh
    spec = list(sh.spec) + [None] * (w.qw.ndim - len(sh.spec))
    ax = w.axis + w.qw.ndim
    return QWeight(qw=sh, scale=Sharding(sh.mesh, tuple(spec[:ax] + spec[ax + 1:])),
                   axis=w.axis)


def adapt_shardings(shardings: Any, params: Any) -> Any:
    """A per-param Sharding tree (llama.param_shardings: dicts and the list
    of layers) rewritten for a possibly quantized params tree of the same
    structure (adapt at every leaf)."""
    if isinstance(shardings, dict):
        return {k: adapt_shardings(shardings[k], params[k]) for k in params}
    if isinstance(shardings, list):
        return [adapt_shardings(s, p) for s, p in zip(shardings, params)]
    return adapt(shardings, params)


def params_nbytes(params: Any) -> int:
    """Bytes of every tensor of the tree (a QWeight counts qw and scale)."""
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_nbytes(v) for v in params)
    if isinstance(params, QWeight):
        return params_nbytes([params.qw, params.scale])
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
