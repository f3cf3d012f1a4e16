"""Flash prefill under image-block masks (counterpart of mfa_tpu/kernels/blockmask.py).

Gemma3 multimodal prompts attend with

    visible(row, col) = (causal AND window)(row, col) OR same_image_run(row, col)

(transformers' token_type_ids or-mask): image tokens see their whole
contiguous <image> run in both directions, text stays causal. The kernel,
csrc/blockmask.cu, is the mma.sync forward tile of csrc/flash_fwd.cuh
(kernel 1's before it moved to wgmma) with a same-run visibility policy,
one block per (q tile of 64, q head, batch) visiting only the KV tiles
[kv_first, kv_last] that some row of its tile can see (`kv_tile_bounds`,
computed here with torch ops from `image_run_bounds`). A CUDA tensor runs the kernel (or raises); a CPU
tensor runs `_image_block_plain`, the dense fp32 masked softmax of
models/llama.py:_attention_dense_masked. No gradient: inference only, as
in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mfa_tpu_torch.dispatch.config import cdiv, softmax_scale_default
from mfa_tpu_torch.kernels import _build

_LOG2E = math.log2(math.e)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
KERNEL_HEAD_DIMS = (64, 128, 256)
TILE = 64  # q rows and KV rows per kernel tile (csrc/flash_fwd.cuh FA_BM, FA_BN)


def image_run_bounds(block_ids: torch.Tensor):
    """Per-token run extents from [b, s] image-run ids (-1 = text).

    Returns (run_start, run_end) [b, s] int32: for image tokens the first
    and last index of their contiguous run; for text tokens the token's
    own index."""
    b, s = block_ids.shape
    ids = block_ids.long()
    idx = torch.arange(s, device=ids.device)[None].expand(b, s)
    is_img = ids >= 0
    pad = torch.full((b, 1), -1, dtype=ids.dtype, device=ids.device)
    prev = torch.cat([pad, ids[:, :-1]], dim=1)
    nxt = torch.cat([ids[:, 1:], pad], dim=1)
    starts = is_img & (prev != ids)
    ends = is_img & (nxt != ids)
    run_start = torch.cummax(torch.where(starts, idx, -1), dim=1).values
    run_end = torch.cummin(torch.where(ends, idx, s).flip(1), dim=1).values.flip(1)
    run_start = torch.where(is_img, run_start, idx)
    run_end = torch.where(is_img, run_end, idx)
    return run_start.int(), run_end.int()


def kv_tile_bounds(block_ids: torch.Tensor, window_left: int, tile: int = TILE):
    """(kv_first, kv_last) [b, ceil(s / tile)] int32: the KV tiles that
    the rows of each q tile can see. Row r sees [min(max(r - wl, 0),
    run_start(r)), max(r, run_end(r))] (run_end >= r); padded rows past s
    are text with their own index, clipped into [0, s)."""
    b, s = block_ids.shape
    nt = cdiv(s, tile)
    ids = torch.nn.functional.pad(block_ids.int(), (0, nt * tile - s), value=-1)
    run_start, run_end = image_run_bounds(ids)
    kv_last = run_end.clamp(max=s - 1).reshape(b, nt, tile).amax(dim=2) // tile
    if window_left >= 0:
        idx = torch.arange(nt * tile, device=ids.device, dtype=torch.int32)[None]
        lo = torch.minimum((idx - window_left).clamp(min=0), run_start)
        kv_first = lo.reshape(b, nt, tile).amin(dim=2) // tile
    else:
        kv_first = torch.zeros_like(kv_last)
    return torch.minimum(kv_first, kv_last).int(), kv_last.int()


def block_mask(block_ids: torch.Tensor, window_left: int) -> torch.Tensor:
    """The dense [b, s, s] visibility of the image-block mask."""
    s = block_ids.shape[1]
    row = torch.arange(s, device=block_ids.device)[:, None]
    col = torch.arange(s, device=block_ids.device)[None, :]
    band = col <= row
    if window_left >= 0:
        band &= col >= row - window_left
    ids = block_ids.long()
    same = (ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0)
    return band[None] | same


def dense_masked_attention(q, k, v, visible, scale):
    """Dense fp32 softmax attention on [b, h, s, d] under a [b, s, s]
    boolean visibility (masked logits -1e30, as the JAX reference); output
    in q's dtype."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    sc = (q.float() @ kf.transpose(-1, -2)) * scale
    sc = torch.where(visible[:, None], sc, torch.full((), -1e30, device=q.device))
    return (torch.softmax(sc, dim=-1) @ vf).to(q.dtype)


def _image_block_plain(q, k, v, block_ids, scale, window_left):
    return dense_masked_attention(q, k, v, block_mask(block_ids, window_left),
                                  scale)


def _image_block_cuda(q, k, v, block_ids, scale, window_left):
    _build.refuse_grad("image_block_prefill", q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"the image-block kernel takes bf16/fp16, got {q.dtype}")
    batch, hq, s, d = q.shape
    hkv = k.shape[1]
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the image-block kernel takes head_dim in "
                                  f"{KERNEL_HEAD_DIMS}, got {d}")
    name = "image_block_prefill"
    _build.same_device(name, q, k, v, block_ids)
    _build.expect_shape(name, "k", k, (batch, hkv, s, d))
    _build.expect_shape(name, "v", v, k.shape)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v dtypes differ")
    q, k, v = _build.dense(q), _build.dense(k), _build.dense(v)
    ids = block_ids.to(torch.int32).contiguous()
    kv_first, kv_last = kv_tile_bounds(ids, window_left)
    out = torch.empty_like(q)
    fn = _build.function("blockmask", "mfa_image_block_fwd", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ids.data_ptr(), kv_first.data_ptr(), kv_last.data_ptr(),
            _build.DTYPE_CODES[q.dtype], batch, hq, hkv, s, d, window_left,
            scale * _LOG2E, _build.stream_of(q))
    _build.check("blockmask", rc)
    _build.launches["blockmask"] += 1
    return out


def image_block_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_ids: torch.Tensor,
    *,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
) -> torch.Tensor:
    """Flash attention with mask (causal AND window) OR same-image-run.

    q: [b, hq, s, d]; k/v: [b, hkv, s, d] (equal q and kv lengths, top-left
    aligned: the multimodal prefill layout) with hq % hkv == 0; block_ids:
    [b, s] int32 contiguous image-run id per token, -1 for text and
    padding. window_left bounds the causal band (-1 = unbounded); a run
    is visible to its own rows whatever the window. Returns [b, hq, s, d]
    in q's dtype."""
    if q.shape[2] != k.shape[2]:
        raise ValueError("image-block prefill is whole-prompt (sq == sk), got "
                         f"sq {q.shape[2]} and sk {k.shape[2]}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"num_heads ({q.shape[1]}) must be divisible by "
                         f"num_kv_heads ({k.shape[1]})")
    _build.expect_shape("image_block_prefill", "block_ids", block_ids,
                        (q.shape[0], q.shape[2]))
    scale = float(softmax_scale if softmax_scale is not None
                  else softmax_scale_default(q.shape[-1]))
    args = (q, k, v, block_ids, scale, int(window_left))
    if q.device.type == "cpu":
        return _image_block_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"image_block_prefill: unsupported device {q.device}")
    return _image_block_cuda(*args)
