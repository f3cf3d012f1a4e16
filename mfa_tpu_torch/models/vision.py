"""SigLIP vision tower + Gemma3 multimodal glue (counterpart of mfa_tpu/models/vision.py).

Numerics follow the JAX package, which mirrors transformers'
`SiglipVisionModel` + `Gemma3MultiModalProjector` +
`Gemma3Model.get_image_features`. As there, the tower and the projector
are plain tensor code: dense [tokens, hidden] matmuls (`@`, as the JAX
package leaves them to XLA), the stride == kernel patch "convolution" as
a reshape and one matmul, and the tower's dense attention as matmul + fp32
softmax. The kernel of this path is the text stack's: image tokens
attend bidirectionally within their contiguous <image> run while text
stays causal, which prefill runs through the image-block kernel
(kernels/blockmask.py, fed the [b, s] run ids of
`image_block_ids_from_tokens` through llama.forward / prefill_batch).
Decode after the prompt is ordinary causal.

Params are a plain dict (layers a list of per-layer dicts), in the dtype
given; the projector norm is Gemma's (1 + w) RMSNorm, stored as w.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from mfa_tpu_torch.dispatch.config import resolve_device

_LAYER_KEYS = ("ln1_w", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo",
               "bo", "ln2_w", "ln2_b", "fc1", "fc1_b", "fc2", "fc2_b")
_TOP_KEYS = ("patch_w", "patch_b", "pos", "post_ln_w", "post_ln_b",
             "mm_norm", "mm_proj")


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    """The tower of google/gemma-3-4b-it (vision_config): hidden 1152,
    intermediate 4304, 27 layers, 16 heads, 896-pixel images in 14-pixel
    patches, and 256 soft tokens per image out of the projector."""
    hidden: int = 1152
    intermediate: int = 4304
    n_layers: int = 27
    n_heads: int = 16
    image_size: int = 896
    patch_size: int = 14
    eps: float = 1e-6
    # Gemma3 projector
    mm_tokens_per_image: int = 256

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads


VisionParams = Dict[str, Any]


def init_vision_params(vcfg: SiglipVisionConfig, text_dim: int, seed: int = 0,
                       device="cuda", dtype=torch.bfloat16) -> VisionParams:
    """Random weights from a seeded torch.Generator on the device, in the
    layout of mfa_tpu's init_vision_params: projections normal * fan_in^-0.5,
    biases zero, layer norms at identity, position table normal * 0.02,
    projector norm zero (applied 1 + w)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, ffn, p = vcfg.hidden, vcfg.intermediate, vcfg.patch_size

    def lin(i, o):
        return torch.randn((i, o), generator=gen, device=dev,
                           dtype=dtype).mul_(i ** -0.5)

    def zeros(n):
        return torch.zeros((n,), device=dev, dtype=dtype)

    def ones(n):
        return torch.ones((n,), device=dev, dtype=dtype)

    layers = []
    for _ in range(vcfg.n_layers):
        layers.append(dict(
            ln1_w=ones(h), ln1_b=zeros(h),
            wq=lin(h, h), bq=zeros(h), wk=lin(h, h), bk=zeros(h),
            wv=lin(h, h), bv=zeros(h), wo=lin(h, h), bo=zeros(h),
            ln2_w=ones(h), ln2_b=zeros(h),
            fc1=lin(h, ffn), fc1_b=zeros(ffn), fc2=lin(ffn, h), fc2_b=zeros(h),
        ))
    return dict(
        patch_w=lin(3 * p * p, h), patch_b=zeros(h),
        pos=torch.randn((vcfg.num_patches, h), generator=gen, device=dev,
                        dtype=dtype).mul_(0.02),
        layers=layers, post_ln_w=ones(h), post_ln_b=zeros(h),
        mm_norm=zeros(h), mm_proj=lin(h, text_dim))


def vision_params_from_numpy(tree, vcfg: SiglipVisionConfig, device,
                             dtype=torch.float32) -> VisionParams:
    """mfa_tpu's vision params pytree (numpy arrays, layers stacked [L, ...])
    -> this port's params, so both packages compute the same function."""
    dev = torch.device(device)

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.tensor(a, dtype=dtype, device=dev)

    stacked = tree["layers"]
    layers = [{k: t(stacked[k][i]) for k in _LAYER_KEYS}
              for i in range(vcfg.n_layers)]
    return dict(layers=layers, **{k: t(tree[k]) for k in _TOP_KEYS})


def _layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def siglip_encode(vparams: VisionParams, pixel_values: torch.Tensor,
                  vcfg: SiglipVisionConfig) -> torch.Tensor:
    """pixel_values [b, 3, H, W] (channel-first) -> patch features [b,
    num_patches, hidden], post layer norm applied (SiglipVisionModel
    without its pooling head, as Gemma3 builds it)."""
    b = pixel_values.shape[0]
    p, nps = vcfg.patch_size, vcfg.patches_per_side
    x = pixel_values.reshape(b, 3, nps, p, nps, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, nps * nps, 3 * p * p)
    x = x.to(vparams["patch_w"].dtype) @ vparams["patch_w"]
    x = x + vparams["patch_b"] + vparams["pos"][None]
    nh, hd = vcfg.n_heads, vcfg.head_dim
    scale = hd ** -0.5
    for lp in vparams["layers"]:
        h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"], vcfg.eps)
        q = (h @ lp["wq"] + lp["bq"]).reshape(b, -1, nh, hd).transpose(1, 2)
        k = (h @ lp["wk"] + lp["bk"]).reshape(b, -1, nh, hd).transpose(1, 2)
        v = (h @ lp["wv"] + lp["bv"]).reshape(b, -1, nh, hd).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) * scale
        a = torch.softmax(s.float(), dim=-1).to(v.dtype)
        o = (a @ v).transpose(1, 2).reshape(b, -1, nh * hd)
        x = x + (o @ lp["wo"] + lp["bo"])
        h2 = _layer_norm(x, lp["ln2_w"], lp["ln2_b"], vcfg.eps)
        x = x + (torch.nn.functional.gelu(h2 @ lp["fc1"] + lp["fc1_b"],
                                          approximate="tanh")
                 @ lp["fc2"] + lp["fc2_b"])
    return _layer_norm(x, vparams["post_ln_w"], vparams["post_ln_b"], vcfg.eps)


def project_image_features(vparams: VisionParams, vision_out: torch.Tensor,
                           vcfg: SiglipVisionConfig) -> torch.Tensor:
    """Gemma3MultiModalProjector: average-pool the patch grid down to
    mm_tokens_per_image soft tokens, Gemma RMSNorm in fp32, project to the
    text width. [b, num_patches, vh] -> [b, mm_tokens_per_image, text_dim]."""
    b, _, vh = vision_out.shape
    pp = vcfg.patches_per_side
    tps = int(vcfg.mm_tokens_per_image ** 0.5)
    ksz = pp // tps
    x = vision_out.transpose(1, 2).reshape(b, vh, tps, ksz, tps, ksz)
    x = x.mean(dim=(3, 5)).reshape(b, vh, tps * tps).transpose(1, 2)
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    normed = xf * torch.rsqrt(var + vcfg.eps) * (1.0 + vparams["mm_norm"].float())
    return (normed @ vparams["mm_proj"].float()).to(vision_out.dtype)


def gemma3_image_features(vparams: VisionParams, pixel_values: torch.Tensor,
                          vcfg: SiglipVisionConfig) -> torch.Tensor:
    """[n_images, 3, H, W] -> [n_images, mm_tokens_per_image, text_dim]."""
    return project_image_features(
        vparams, siglip_encode(vparams, pixel_values, vcfg), vcfg)


def merge_image_embeds(text_embeds: torch.Tensor, tokens: torch.Tensor,
                       image_feats: torch.Tensor, image_token_id: int):
    """Scatter projected image features over the <image> placeholder rows.

    text_embeds [b, s, d] (already embed-scaled: image rows bypass the
    sqrt(dim) scale, as in transformers' Gemma3TextScaledWordEmbedding),
    tokens [b, s], image_feats [n_images, mm, d] in placeholder order: the
    k-th placeholder (row-major over [b, s]) takes feature row k."""
    b, s, d = text_embeds.shape
    mask = (tokens == image_token_id).reshape(-1)
    flat = image_feats.reshape(-1, d).to(text_embeds.dtype)
    idx = (torch.cumsum(mask.long(), 0) - 1).clamp(0, flat.shape[0] - 1)
    merged = torch.where(mask[:, None], flat[idx], text_embeds.reshape(-1, d))
    return merged.reshape(b, s, d)


def image_block_ids_from_tokens(tokens: torch.Tensor,
                                image_token_id: int) -> torch.Tensor:
    """[b, s] int32: contiguous <image>-run id per token (-1 = text), the
    input of the image-block kernel (kernels/blockmask.py)."""
    is_img = tokens == image_token_id
    prev = torch.cat([torch.zeros_like(is_img[:, :1]), is_img[:, :-1]], dim=1)
    group = torch.cumsum((is_img & ~prev).int(), dim=1) - 1
    return torch.where(is_img, group, torch.full_like(group, -1)).int()


def image_bidir_mask(tokens: torch.Tensor, image_token_id: int) -> torch.Tensor:
    """[b, s, s] OR-mask: tokens of the same image run see each other
    (transformers' token_type_ids mask function); the dense form of
    image_block_ids_from_tokens, for llama._attention_dense_masked."""
    group = image_block_ids_from_tokens(tokens, image_token_id)
    same = group[:, :, None] == group[:, None, :]
    return same & (group[:, :, None] >= 0)


def multimodal_forward(params, vparams: VisionParams, tokens, pixel_values,
                       cfg, vcfg: SiglipVisionConfig,
                       image_token_id: int) -> torch.Tensor:
    """Gemma3 conditional-generation forward -> logits [b, s, vocab] fp32.

    tokens [b, s] with mm_tokens_per_image placeholders per image;
    pixel_values [n_images, 3, H, W] in placeholder order."""
    from mfa_tpu_torch.models import llama

    feats = gemma3_image_features(vparams, pixel_values, vcfg)
    embeds = merge_image_embeds(llama._embed(params, tokens, cfg), tokens,
                                feats, image_token_id)
    bids = image_block_ids_from_tokens(tokens, image_token_id)
    return llama.forward(params, tokens, cfg, input_embeds=embeds,
                         image_block_ids=bids)


def multimodal_generate_greedy(params, vparams: VisionParams, tokens,
                               pixel_values, cfg, vcfg: SiglipVisionConfig,
                               image_token_id: int, max_new_tokens: int):
    """Greedy decode by full-forward recomputation (the parity harness of
    the tests; serving uses the paged engine). Returns the new tokens of
    row 0."""
    toks = tokens
    out = []
    for _ in range(max_new_tokens):
        logits = multimodal_forward(params, vparams, toks, pixel_values, cfg,
                                    vcfg, image_token_id)
        nxt = logits[:, -1].argmax(dim=-1)
        out.append(int(nxt[0]))
        toks = torch.cat([toks, nxt[:, None].to(toks.dtype)], dim=1)
    return out
