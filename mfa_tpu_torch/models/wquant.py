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

Not ported yet: `ragged_qmm` (MoE) and `adapt_shardings` (meshes).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mfa_tpu_torch.kernels.wmatmul import int8_matmul

__all__ = [
    "QWeight",
    "quantize_weight",
    "dequantize_weight",
    "qmm",
    "qtake",
    "quantize_params",
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
    absmax = wf.abs().amax(dim=axis)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / 127.0)
    qw = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127)
    return qw.to(torch.int8), scale


def quantize_weight(w: torch.Tensor, axis: int = -2) -> QWeight:
    """Symmetric absmax int8 quantization along `axis`: scale = absmax / 127
    (1 where absmax is 0), round half to even, clip to +-127. A large 2-D
    tensor quantizes in slices along its other axis, which caps the fp32
    transient (a 128k-vocab table is 2.1 GB in fp32)."""
    axis = axis if axis < 0 else axis - w.ndim
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


# Matmul weights quantized per output channel (mfa_tpu's _MATMUL_KEYS; the
# MoE keys wait for MoE); norms stay as they are.
_MATMUL_KEYS = frozenset((
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "ws_gate", "ws_up", "ws_down", "lm_head",
))


def quantize_params(params: dict, include_embed: bool = True) -> dict:
    """A new params tree with the big projections (and, with include_embed,
    the embedding table per row) as QWeight; other leaves and leaves that
    are already QWeight pass through. Walks dicts and the list of layers."""

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, QWeight) or not isinstance(node, torch.Tensor):
            return node
        if key in _MATMUL_KEYS:
            return quantize_weight(node, axis=-2)
        if key == "embed" and include_embed:
            return quantize_weight(node, axis=-1)
        return node

    return walk(dict(params))


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
