"""Llama-style transformer: serving and training (counterpart of mfa_tpu/models/llama.py).

Params are a plain dict of tensors: `layers` is a list of per-layer dicts
(wq, wk, wv, wo, attn_norm, mlp_norm, w_gate, w_up, w_down; Gemma3 adds
q_norm, k_norm, post_attn_norm, post_mlp_norm), plus embed, final_norm and
lm_head. Projections go through models/wquant.qmm: plain `@` for bf16
weights (as the JAX package leaves them to XLA), the int8 matmul kernel
(kernels/wmatmul.py) for QWeight weights (init_params(quantize="int8") or
wquant.quantize_params); the embedding through qtake. Attention runs
through the port's kernels: prefill_batch -> kernels/prefill.py (the
default engine: the zero-shift kernel with its poison flag, then the
repair kernel), or kernels/blockmask.py (the image-block kernel) for image
prompts, prefill_chunk_batch -> kernels/paged_prefill.py, decode_step ->
kernels/paged.py, over the int8 or bf16 paged cache; forward / loss_fn /
train_step -> kernels/autodiff.flash_attention_grad (the default prefill
engine forward, the fused backward kernel), or the image-block kernel
under image_block_ids (inference only).

Gemma3 (LlamaConfig.gemma3_4b): (1 + w) RMSNorms, per-head q/k norms, post
norms on the attention and MLP outputs, gelu-tanh, sqrt(dim)-scaled
embeddings, query_pre_attn_scalar, and a per-layer pattern of sliding
(window, local RoPE theta, unscaled positions) and global (full causal,
global theta, linear position scale) layers: each layer passes its own
window to the kernels (_layer_plan).

decode_step keeps the JAX package's DEFERRED-APPEND structure: each layer
attends over the stored cache with pos_offset=1 and return_lse=True, the
token's own K/V row is merged by exact LSE (_merge_deferred: the quantized
row contracts in bf16 and its scale applies after the contraction), and
ONE append after the layer loop writes every layer's row. In PyTorch the
XLA copy-insertion reason for it does not exist, but it defines the
reference numerics.

Not ported yet (raise NotImplementedError): MoE, logit softcaps, meshes.
int8 weights serve only: loss_fn and train_step raise on them, as JAX
defines no gradient through QWeight.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from mfa_tpu_torch.cache.paged_cache import (StackedKVCache,
                                             create_stacked_cache,
                                             pack_pages_payload,
                                             scatter_span_rows)
from mfa_tpu_torch.dispatch.config import host_to_device, resolve_device
from mfa_tpu_torch.kernels.autodiff import flash_attention_grad
from mfa_tpu_torch.kernels.blockmask import (dense_masked_attention,
                                             image_block_prefill)
from mfa_tpu_torch.kernels.paged import paged_attention
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.kernels.quant import quantize_rows
from mfa_tpu_torch.models.wquant import (QWeight, qmm, qtake, quantize_params,
                                         quantize_weight)
from mfa_tpu_torch.serve.sampling import sample, token_logprobs


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # Mistral-style uniform sliding window (None = full causal).
    sliding_window: Optional[int] = None
    # linear RoPE position scaling, and the non-linear inv_freq rescale
    # tuple ("llama3", ...) / ("yarn", ...) of mfa_tpu's LlamaConfig. With
    # a dual RoPE config (rope_theta_local set) both apply to the global
    # layers only (_sub_rope).
    rope_scale: float = 1.0
    rope_scaling: Optional[tuple] = None
    # Gemma family knobs (mfa_tpu's LlamaConfig):
    head_dim_override: Optional[int] = None  # head_dim != dim / n_heads
    hidden_act: str = "silu"                 # "silu" | "gelu_tanh"
    norm_offset: bool = False                # RMSNorm x * (1 + w)
    embed_scale: bool = False                # embeddings * sqrt(dim)
    query_scale: Optional[float] = None      # softmax scale override
    post_norms: bool = False                 # norms on attn / MLP outputs
    qk_norm: bool = False                    # RMSNorm per q/k head
    # per-layer sliding flags, repeating (True = sliding window, local
    # RoPE); Gemma3-4B gives all 34 since its period 6 does not divide 34
    layer_pattern: Optional[tuple] = None
    rope_theta_local: Optional[float] = None  # RoPE theta of sliding layers
    # family knobs of the JAX config that the port does not serve yet
    n_experts: int = 0
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None

    def __post_init__(self):
        if self.n_experts or self.attn_softcap or self.logit_softcap:
            raise NotImplementedError(
                "MoE and logit softcaps are not ported yet")
        if self.hidden_act not in ("silu", "gelu_tanh"):
            raise ValueError(f"hidden_act {self.hidden_act!r}")
        if self.layer_pattern is not None and (
                not self.layer_pattern or self.n_layers % len(self.layer_pattern)):
            raise ValueError(f"layer pattern period {len(self.layer_pattern)} "
                             f"must divide n_layers {self.n_layers}")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads

    @property
    def attn_scale(self) -> float:
        return (self.query_scale if self.query_scale is not None
                else self.head_dim ** -0.5)

    @property
    def window_left(self) -> int:
        return -1 if self.sliding_window is None else self.sliding_window - 1

    @property
    def sliding_pattern(self) -> Optional[tuple]:
        """Repeating per-layer sliding flags, or None (uniform layers)."""
        return None if self.layer_pattern is None else tuple(self.layer_pattern)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """meta-llama/Meta-Llama-3-8B config.json: 32 layers, dim 4096,
        32 q / 8 kv heads, ffn 14336, vocab 128256, rope_theta 5e5."""
        return LlamaConfig(vocab_size=128256)

    @staticmethod
    def gemma3_4b() -> "LlamaConfig":
        """google/gemma-3-4b-it text_config: 34 layers, dim 2560, 8 q / 4
        kv heads of head_dim 256, ffn 10240, vocab 262208, rms_norm_eps
        1e-6, query_pre_attn_scalar 256, gelu_pytorch_tanh; sliding window
        1024 with 5 sliding layers to 1 global (layer i global iff (i + 1)
        % 6 == 0, as layer_types gives them); rope_theta 1e6 with linear
        scaling 8 on the global layers, rope_local_base_freq 1e4 on the
        sliding ones; no softcaps. The fields mfa_tpu's
        convert.config_from_hf derives from that config."""
        return LlamaConfig(
            vocab_size=262208, dim=2560, n_layers=34, n_heads=8, n_kv_heads=4,
            ffn_dim=10240, rope_theta=1000000.0, norm_eps=1e-6,
            sliding_window=1024, rope_scale=8.0, head_dim_override=256,
            hidden_act="gelu_tanh", norm_offset=True, embed_scale=True,
            query_scale=256.0 ** -0.5, post_norms=True, qk_norm=True,
            layer_pattern=tuple((i + 1) % 6 != 0 for i in range(34)),
            rope_theta_local=10000.0)

    @staticmethod
    def tiny(vocab=256, dim=128, layers=2, heads=4, kv_heads=2, ffn=256,
             dtype=torch.float32, **kw) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab, dim=dim, n_layers=layers, n_heads=heads,
            n_kv_heads=kv_heads, ffn_dim=ffn, dtype=dtype, **kw,
        )


Params = Dict[str, Any]
_NORMS = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm",
          "post_attn_norm", "post_mlp_norm")
_LAYER_KEYS = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm", "w_gate",
               "w_up", "w_down")
_GEMMA_KEYS = ("q_norm", "k_norm", "post_attn_norm", "post_mlp_norm")


def _layer_keys(cfg: LlamaConfig) -> tuple:
    """The per-layer weight names of this config, in a fixed order."""
    extra = (("q_norm", "k_norm") if cfg.qk_norm else ()) + (
        ("post_attn_norm", "post_mlp_norm") if cfg.post_norms else ())
    return _LAYER_KEYS + extra


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda",
                quantize: Optional[str] = None) -> Params:
    """Random weights in cfg.dtype from a seeded torch.Generator on the
    device (normal * fan_in^-0.5, embed * 0.02; fp32 norms at their
    identity: one, or zero under norm_offset, which applies 1 + w).

    quantize="int8": every matmul weight and the embedding become QWeight
    (models/wquant.py), each layer and table quantized as soon as it is
    built, so the bf16 model never exists whole (peak: the int8 tree and
    one bf16 table). The same seed gives the weights quantize_params would
    give for the bf16 init."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported weight quantization {quantize!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hd = cfg.dim, cfg.head_dim

    def dense(shape, scale=None):
        w = torch.randn(shape, generator=gen, device=dev, dtype=cfg.dtype)
        return w.mul_(scale if scale is not None else shape[-2] ** -0.5)

    def norm(width=d):
        fill = torch.zeros if cfg.norm_offset else torch.ones
        return fill((width,), dtype=torch.float32, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        lp = dict(
            wq=dense((d, cfg.n_heads * hd)),
            wk=dense((d, cfg.n_kv_heads * hd)),
            wv=dense((d, cfg.n_kv_heads * hd)),
            wo=dense((cfg.n_heads * hd, d)),
            attn_norm=norm(),
            mlp_norm=norm(),
            w_gate=dense((d, cfg.ffn_dim)),
            w_up=dense((d, cfg.ffn_dim)),
            w_down=dense((cfg.ffn_dim, d)),
        )
        if cfg.qk_norm:
            lp.update(q_norm=norm(hd), k_norm=norm(hd))
        if cfg.post_norms:
            lp.update(post_attn_norm=norm(), post_mlp_norm=norm())
        layers.append(quantize_params(lp) if quantize else lp)
    embed = dense((cfg.vocab_size, d), 0.02)
    if quantize:
        embed = quantize_weight(embed, axis=-1)
    lm_head = dense((d, cfg.vocab_size))
    if quantize:
        lm_head = quantize_weight(lm_head, axis=-2)
    return dict(layers=layers, embed=embed, final_norm=norm(), lm_head=lm_head)


def params_from_numpy(tree, cfg: LlamaConfig, device) -> Params:
    """The JAX package's params pytree (numpy arrays; layers stacked
    [L, ...] as mfa_tpu's init_params builds them) -> this port's params,
    so both packages compute the same function in the tests. A quantized
    leaf (mfa_tpu's QWeight, read by its qw, scale and axis attributes)
    becomes this port's QWeight."""
    dev = torch.device(device)

    def t(a, name, layer=None):
        if hasattr(a, "qw") and hasattr(a, "scale"):
            qw, sc = np.asarray(a.qw), np.asarray(a.scale, np.float32)
            if layer is not None:
                qw, sc = qw[layer], sc[layer]
            return QWeight(qw=torch.tensor(qw, device=dev),
                           scale=torch.tensor(sc, device=dev), axis=int(a.axis))
        a = np.asarray(a if layer is None else a[layer])
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        dtype = torch.float32 if name in _NORMS else cfg.dtype
        return torch.tensor(a, dtype=dtype, device=dev)

    stacked = tree["layers"]
    keys = _layer_keys(cfg)
    extra = set(stacked) - set(keys)
    if extra:
        raise NotImplementedError(f"layer params {sorted(extra)} are not "
                                  f"ported yet")
    layers = [{k: t(stacked[k], k, i) for k in keys}
              for i in range(cfg.n_layers)]
    return dict(layers=layers, embed=t(tree["embed"], "embed"),
                final_norm=t(tree["final_norm"], "final_norm"),
                lm_head=t(tree["lm_head"], "lm_head"))


def _rms_norm(x, w, cfg: LlamaConfig):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    if cfg.norm_offset:  # Gemma: the weight is stored as w, applied 1 + w
        w = 1.0 + w
    return (xf * torch.rsqrt(var + cfg.norm_eps) * w).to(x.dtype)


def _qkv(h, lp, cfg: LlamaConfig, *lead):
    hd = cfg.head_dim
    q = qmm(h, lp["wq"]).reshape(*lead, cfg.n_heads, hd)
    k = qmm(h, lp["wk"]).reshape(*lead, cfg.n_kv_heads, hd)
    v = qmm(h, lp["wv"]).reshape(*lead, cfg.n_kv_heads, hd)
    if cfg.qk_norm:  # each head normalized before RoPE
        q = _rms_norm(q, lp["q_norm"], cfg)
        k = _rms_norm(k, lp["k_norm"], cfg)
    return q, k, v


def _act(x, hidden_act: str):
    """The family activation on the gate projection (gelu_tanh: Gemma)."""
    if hidden_act == "gelu_tanh":
        return torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu(x)


def _mlp(x, lp, cfg: LlamaConfig):
    h = _rms_norm(x, lp["mlp_norm"], cfg)
    gate = _act(qmm(h, lp["w_gate"]), cfg.hidden_act)
    out = qmm(gate * qmm(h, lp["w_up"]), lp["w_down"])
    if cfg.post_norms:
        out = _rms_norm(out, lp["post_mlp_norm"], cfg)
    return x + out


def _attn_residual(x, attn_flat, lp, cfg: LlamaConfig):
    """o-projection (+ post-attention norm) + residual. attn_flat: [...,
    n_heads*head_dim]."""
    out = qmm(attn_flat.to(x.dtype), lp["wo"])
    if cfg.post_norms:
        out = _rms_norm(out, lp["post_attn_norm"], cfg)
    return x + out


def _embed(params, tokens, cfg: LlamaConfig):
    x = qtake(params["embed"], tokens)
    if cfg.embed_scale:  # Gemma: sqrt(dim) rounded to the activation dtype
        x = x * float(torch.tensor(cfg.dim ** 0.5, dtype=x.dtype))
    return x


def _unembed(params, x, cfg: LlamaConfig):
    return qmm(x, params["lm_head"]).float()


def _scaled_inv_freq(scaling: tuple, inv_freq: np.ndarray, hd: int,
                     theta: float):
    """Rescale base inv_freq per LlamaConfig.rope_scaling (pure numpy).
    Returns (inv_freq, mscale) where mscale multiplies cos/sin. Mirrors
    transformers' "llama3" and "yarn" rope init functions."""
    kind = scaling[0]
    if kind == "llama3":
        _, factor, low_ff, high_ff, orig_ctx = scaling
        low_wavelen = orig_ctx / low_ff
        high_wavelen = orig_ctx / high_ff
        wavelen = 2 * math.pi / inv_freq
        smooth = (orig_ctx / wavelen - low_ff) / (high_ff - low_ff)
        blended = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        out = np.where(wavelen < high_wavelen, inv_freq,
                       np.where(wavelen > low_wavelen, inv_freq / factor,
                                blended))
        return out.astype(np.float32), 1.0
    if kind == "yarn":
        _, factor, attention_factor, beta_fast, beta_slow, orig_ctx = scaling
        half = hd // 2

        def correction_dim(num_rot):
            return (hd * math.log(orig_ctx / (num_rot * 2 * math.pi))
                    ) / (2 * math.log(theta))

        low = max(math.floor(correction_dim(beta_fast)), 0)
        high = min(math.ceil(correction_dim(beta_slow)), hd - 1)
        ramp = (np.arange(half, dtype=np.float32) - low) / max(high - low,
                                                               0.001)
        extrapolation_factor = 1 - np.clip(ramp, 0, 1)
        out = (inv_freq / factor * (1 - extrapolation_factor)
               + inv_freq * extrapolation_factor)
        return out.astype(np.float32), float(attention_factor)
    raise NotImplementedError(f"rope_scaling kind {kind!r}")


@functools.lru_cache(maxsize=None)
def _inv_freq(hd: int, theta: float, scale: float, scaling: Optional[tuple],
              device: torch.device):
    """(inv_freq [hd/2] fp32 on device, mscale), computed once in numpy
    fp32 exactly as the JAX package does, then kept on the device (a
    per-call host-to-device copy would stall the stream every layer)."""
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    mscale = 1.0
    if scaling is not None:
        freqs, mscale = _scaled_inv_freq(scaling, freqs, hd, theta)
    if scale != 1.0:
        freqs = freqs / scale
    return torch.as_tensor(np.asarray(freqs, np.float32), device=device), mscale


def _rope_tables(positions, hd: int, theta: float, scale: float = 1.0,
                 scaling: Optional[tuple] = None):
    """(cos, sin) [..., seq, 1, hd/2] fp32 for positions [..., seq]."""
    freqs, mscale = _inv_freq(hd, theta, scale, scaling, positions.device)
    angles = positions[..., None].float() * freqs
    return (torch.cos(angles)[..., None, :] * mscale,
            torch.sin(angles)[..., None, :] * mscale)


def _apply_rope(x, cos, sin):
    """Split-half rotation in fp32. x: [..., seq, heads, head_dim]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _rope(x, positions, theta: float, scale: float = 1.0,
          scaling: Optional[tuple] = None):
    """Rotary embedding, split-half rotation with fp32 angles.
    x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta, scale,
                                        scaling))


def _sub_rope(cfg: LlamaConfig, sliding: bool):
    """(theta, linear position scale, freq rescaling) of a layer. With a
    dual RoPE config (rope_theta_local set: Gemma3's local 1e4 / global
    1e6) sliding layers use the local theta with unscaled positions, and
    the scalings apply to the global layers only; otherwise every layer
    shares one rotary."""
    if sliding and cfg.rope_theta_local is not None:
        return (cfg.rope_theta_local, 1.0, None)
    return (cfg.rope_theta, cfg.rope_scale, cfg.rope_scaling)


def _layer_plan(cfg: LlamaConfig) -> list:
    """Per layer (window_left, rope args): sliding layers of the pattern
    take cfg's window and the local rotary, global layers full causal
    attention (mfa_tpu's _scan_layers, unrolled)."""
    pattern = cfg.sliding_pattern
    if pattern is None:
        return [(cfg.window_left, _sub_rope(cfg, False))] * cfg.n_layers
    plan = []
    for li in range(cfg.n_layers):
        sliding = bool(pattern[li % len(pattern)])
        plan.append((cfg.window_left if sliding else -1, _sub_rope(cfg, sliding)))
    return plan


def _layer_ropes(cfg: LlamaConfig, positions):
    """Per layer (window_left, (cos, sin)) for positions [..., seq]: one
    table per distinct rotary."""
    tables = {}
    out = []
    for wl, rope in _layer_plan(cfg):
        if rope not in tables:
            tables[rope] = _rope_tables(positions, cfg.head_dim, *rope)
        out.append((wl, tables[rope]))
    return out


# ---------------- training path ----------------


def param_tensors(params: Params) -> list:
    """Every weight tensor of the params, in a fixed order (what an
    optimizer is built over)."""
    return ([lp[k] for lp in params["layers"] for k in _LAYER_KEYS + _GEMMA_KEYS
             if k in lp]
            + [params[k] for k in ("embed", "final_norm", "lm_head")])


def _attention_blockmask(q, k, v, cfg: LlamaConfig, window_left: int,
                         block_ids):
    """Attention on [b, s, h, d] under the Gemma3 multimodal mask, (causal
    AND window) OR same-image-run, through the image-block kernel
    (kernels/blockmask.py). block_ids [b, s] int32: contiguous image-run
    id per token, -1 = text. The config has no attention softcap (it
    raises on one), which the image-block mask does not take either."""
    return image_block_prefill(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), block_ids,
        softmax_scale=cfg.attn_scale, window_left=window_left).transpose(1, 2)


def _attention_dense_masked(q, k, v, cfg: LlamaConfig, window_left: int,
                            extra_mask):
    """Dense fp32 attention on [b, s, h, d] with mask = (causal AND window)
    OR extra_mask [b, s, s]: the reference of the multimodal mask algebra
    that the image-block kernel tiles (mfa_tpu's
    _attention_dense_masked)."""
    s = q.shape[1]
    row = torch.arange(s, device=q.device)[:, None]
    col = torch.arange(s, device=q.device)[None, :]
    band = col <= row
    if window_left >= 0:
        band &= col >= row - window_left
    return dense_masked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        band[None] | extra_mask.to(q.device), cfg.attn_scale).transpose(1, 2)


def _train_layer(x, lp, wl, rope, cfg: LlamaConfig, image_block_ids=None):
    """One decoder layer on the full sequence x [b, s, dim]: causal flash
    attention with this layer's window through the differentiable kernels
    (_attention_sharded of the JAX package without a mesh), or the
    image-block kernel under image_block_ids (no gradient), then the MLP."""
    b, s, _ = x.shape
    h = _rms_norm(x, lp["attn_norm"], cfg)
    q, k, v = _qkv(h, lp, cfg, b, s)
    q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
    if image_block_ids is not None:
        attn = _attention_blockmask(q, k, v, cfg, wl, image_block_ids)
    else:
        attn = flash_attention_grad(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
            softmax_scale=cfg.attn_scale, window_size=(wl, -1)).transpose(1, 2)
    x = _attn_residual(x, attn.reshape(b, s, cfg.n_heads * cfg.head_dim), lp,
                       cfg)
    return _mlp(x, lp, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False, input_embeds=None,
            image_block_ids=None) -> torch.Tensor:
    """Full-sequence causal forward: tokens [b, s] -> logits [b, s, vocab]
    fp32. remat=True checkpoints each layer (torch.utils.checkpoint,
    non-reentrant): the backward recomputes the layer, so its attention
    forward runs twice.

    input_embeds: optional [b, s, dim] embeddings (multimodal: image
    features already merged, models/vision.py). image_block_ids: optional
    [b, s] int32 image-run id per token (-1 = text); it ORs same-run
    visibility into the causal/window mask and routes attention through
    the image-block kernel, which has no backward: inference only, as in
    JAX (on the card the kernel refuses inputs that require grad)."""
    s = tokens.shape[1]
    x = input_embeds if input_embeds is not None else _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)[None]
    for lp, (wl, rope) in zip(params["layers"], _layer_ropes(cfg, positions)):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _train_layer, x, lp, wl, rope, cfg, image_block_ids,
                use_reentrant=False)
        else:
            x = _train_layer(x, lp, wl, rope, cfg, image_block_ids)
    x = _rms_norm(x, params["final_norm"], cfg)
    return _unembed(params, x, cfg)


def _refuse_qweights(params: Params, what: str) -> None:
    """int8 weights have no gradient (mfa_tpu/models/wquant.py): training
    keeps bf16 params."""
    leaves = [v for lp in params["layers"] for v in lp.values()] + [
        params["embed"], params["lm_head"]]
    if any(isinstance(w, QWeight) for w in leaves):
        raise NotImplementedError(f"{what}: int8 (QWeight) params serve only; "
                                  f"no gradient is defined through them")


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy of tokens [b, s] (tokens[:, :-1]
    predict tokens[:, 1:]). Raises on int8 (QWeight) params."""
    _refuse_qweights(params, "loss_fn")
    logits = forward(params, tokens[:, :-1], cfg, remat=remat)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))


def train_step(params: Params, tokens, cfg: LlamaConfig, lr: float = 1e-3,
               remat: bool = False, optimizer=None):
    """One training step -> (params, loss).

    Unlike the pure JAX version this updates the weight tensors IN PLACE
    (under torch.no_grad()) and returns the same dict: without an optimizer
    by plain SGD, p - lr * g in p's dtype (the JAX default); with a
    torch.optim.Optimizer built over param_tensors(params) (the counterpart
    of an optax transformation, its state held by the optimizer object) by
    optimizer.step(). The weights become leaf tensors that require grad;
    on return each holds this step's gradient in .grad (cleared at the
    start of the next step). Raises on int8 (QWeight) params."""
    _refuse_qweights(params, "train_step")
    leaves = param_tensors(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    tokens = torch.as_tensor(tokens, device=leaves[0].device).long()
    loss = loss_fn(params, tokens, cfg, remat=remat)
    loss.backward()
    with torch.no_grad():
        if optimizer is None:
            for p in leaves:
                p.sub_(lr * p.grad.to(p.dtype))
        else:
            optimizer.step()
    return params, loss.detach()


# ---------------- serving path (paged cache) ----------------


def build_kv_caches(cfg: LlamaConfig, num_pages: int, page_size: int,
                    max_seqs: int, pages_per_seq: int,
                    quant_dtype: Optional[str] = None,
                    device="cuda") -> StackedKVCache:
    """One StackedKVCache covering every layer (shared block table and
    lengths; merged page pool)."""
    return create_stacked_cache(
        n_layers=cfg.n_layers, num_pages=num_pages, page_size=page_size,
        num_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        max_seqs=max_seqs, pages_per_seq=pages_per_seq, dtype=cfg.dtype,
        quant_dtype=quant_dtype, device=resolve_device(device),
    )


def _store_rows(quant_dtype: Optional[str], store_dtype, x):
    """-> (payload in cache storage dtype, per-row scales or None)."""
    if quant_dtype is None:
        return x.to(store_dtype), None
    return quantize_rows(x, quant_dtype)


def _merge_deferred(o_c, lse_c, q, kq, ks_new, vq, vs_new, cfg: LlamaConfig):
    """Exact LSE merge of the query's OWN K/V row into the paged-cache
    attention result (the row is appended after the layer loop).

    Numerics mirror the kernel's treatment had the row been stored: the
    payload contracts in bf16 when quantized, the per-row scale applies
    AFTER the contraction, fp32 softmax algebra.

    o_c: [n, 1, heads, d] normalized cache output; lse_c: [n, 1, heads]
    natural-log LSE (-inf for an empty cache row); q: [n, 1, heads, d];
    kq/vq: [hkv, n, d] payload rows; ks/vs: [hkv, n] fp32 or None.
    Returns [n, 1, heads, d] in o_c's dtype.
    """
    n, span, heads, d = q.shape
    hkv = cfg.n_kv_heads
    group = heads // hkv
    kr = kq.reshape(hkv, n, span, d).permute(1, 2, 0, 3)  # [n, span, hkv, d]
    vr = vq.reshape(hkv, n, span, d).permute(1, 2, 0, 3)
    quantized = ks_new is not None
    qg = q.reshape(n, span, hkv, group, d)
    if quantized:  # int8 -> bf16 is exact; q rounds to bf16 as in the kernel
        qg, kr_c = qg.to(torch.bfloat16), kr.to(torch.bfloat16)
    else:
        kr_c = kr
    s = torch.einsum("nihgd,njhd->nhgij", qg.float(), kr_c.float())
    if quantized:
        s = s * ks_new.reshape(hkv, n, span).permute(1, 0, 2)[:, :, None, None, :]
        vd = vr.float() * vs_new.reshape(hkv, n, span).permute(1, 2, 0)[..., None]
    else:
        vd = vr.float()
    s = s * cfg.attn_scale
    m_loc = s.amax(dim=-1)  # [n, hkv, group, span]
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("nhgij,njhd->nhgid", p, vd)
    lse = lse_c.reshape(n, span, hkv, group).permute(0, 2, 3, 1)
    m = torch.maximum(lse, m_loc)
    a = torch.where(torch.isneginf(lse), torch.zeros_like(lse),
                    torch.exp(lse - m))
    b = torch.exp(m_loc - m) * l_loc
    oc = o_c.reshape(n, span, hkv, group, d).permute(0, 2, 3, 1, 4).float()
    o = (oc * a[..., None] + o_loc * torch.exp(m_loc - m)[..., None]) / (
        a + b)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(n, span, heads, d).to(o_c.dtype)


def _append_all_layers(cache: StackedKVCache, kq_all, ks_all, vq_all, vs_all,
                       page_ids, offs) -> None:
    """IN PLACE: ONE scatter appending every layer's deferred K/V rows.
    kq_all/vq_all: [L, hkv, R, d]; ks/vs: [L, hkv, R] or None;
    page_ids/offs: [R] LOGICAL page + row offset (layer l adds
    l * num_pages)."""
    L, hkv, R, d = kq_all.shape
    dev = kq_all.device
    lids = (page_ids.long()[None, :]
            + torch.arange(L, device=dev)[:, None] * cache.num_pages
            ).reshape(-1)
    loffs = offs.long().repeat(L)
    scatter_span_rows(cache.k_pages, lids, loffs,
                      kq_all.transpose(0, 1).reshape(hkv, L * R, d))
    scatter_span_rows(cache.v_pages, lids, loffs,
                      vq_all.transpose(0, 1).reshape(hkv, L * R, d))
    if ks_all is not None:
        cache.k_scales[:, lids, loffs] = ks_all.transpose(0, 1).reshape(hkv, L * R)
        cache.v_scales[:, lids, loffs] = vs_all.transpose(0, 1).reshape(hkv, L * R)


def prefill_batch(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                  pages_list, token_lists, vision=None, pixel_lists=None):
    """Prefill n prompts in one batched pass; writes their K/V pages and
    table rows IN PLACE. Prompts are padded to a shared power-of-two page
    count (as in the JAX package); padded rows write into the null page 0
    and are never attended (causal mask + true-length logits gather).

    seq_slots: [n] slot ids; pages_list: per-request page id lists;
    token_lists: per-request token lists. Returns (cache, logits [n, vocab]
    fp32) at each prompt's last position.

    vision: optional (vparams, vcfg, image_token_id) for Gemma3 image
    prompts; pixel_lists: per-request [k_i, 3, H, W] pixels (or None) in
    request order. Their projected features replace the <image>
    placeholder rows (models/vision.py) and every layer attends through
    the image-block kernel; padded rows carry run id -1.
    Decode afterwards is plain causal.
    """
    page = cache.page_size
    pps = cache.pages_per_seq
    token_lists = [np.asarray(t, np.int64) for t in token_lists]
    lens = [int(t.shape[0]) for t in token_lists]
    n_need = max(-(-l // page) for l in lens)
    if n_need > pps:
        raise ValueError("prompt longer than the block table width")
    n_bucket = min(max(1 << max(n_need - 1, 0).bit_length(), 1), pps)
    s_pad = n_bucket * page
    n = len(token_lists)
    toks = np.zeros((n, s_pad), np.int64)
    page_ids = np.zeros((n, n_bucket), np.int64)
    table_rows = np.zeros((n, pps), np.int32)
    for i, (t, pgs) in enumerate(zip(token_lists, pages_list)):
        toks[i, : lens[i]] = t
        need_i = -(-lens[i] // page)
        page_ids[i, :need_i] = np.asarray(list(pgs[:need_i]), np.int64)
        table_rows[i, : len(pgs)] = np.asarray(list(pgs), np.int32)
    dev = cache.lengths.device

    def dev_t(a):
        return torch.as_tensor(a, device=dev)

    tokens = dev_t(toks)
    embeds = block_ids = None
    if vision is not None and pixel_lists is not None and any(
            p is not None for p in pixel_lists):
        from mfa_tpu_torch.models import vision as vis

        vparams, vcfg, image_tok = vision
        pixels = torch.cat([torch.as_tensor(p, device=dev)
                            for p in pixel_lists if p is not None])
        feats = vis.gemma3_image_features(vparams, pixels, vcfg)
        embeds = vis.merge_image_embeds(_embed(params, tokens, cfg), tokens,
                                        feats, image_tok)
        block_ids = vis.image_block_ids_from_tokens(tokens, image_tok)
    return _prefill(params, cfg, cache, dev_t(np.asarray(seq_slots, np.int64)),
                    dev_t(table_rows), dev_t(page_ids), tokens,
                    dev_t(np.asarray(lens, np.int32)), embeds, block_ids)


def _prefill(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
             table_rows, page_ids, tokens, true_lens, input_embeds=None,
             image_block_ids=None):
    n, s = tokens.shape
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    page = cache.page_size
    npg = page_ids.shape[1]
    x = (input_embeds if input_embeds is not None
         else _embed(params, tokens, cfg))  # [n, s, d]
    positions = torch.arange(s, device=x.device)[None]
    store = cache.k_pages.dtype
    ys = []
    for lp, (wl, rope) in zip(params["layers"], _layer_ropes(cfg, positions)):
        h = _rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(h, lp, cfg, n, s)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        # page payload [n, s, hkv, d] -> [hkv, n*npg, page, d]; appended
        # for all layers by one scatter after the loop, as in JAX
        kq, ks_new = _store_rows(cache.quant_dtype, store, k.permute(2, 0, 1, 3))
        vq, vs_new = _store_rows(cache.quant_dtype, store, v.permute(2, 0, 1, 3))
        kq = pack_pages_payload(kq, n * npg, page)
        vq = pack_pages_payload(vq, n * npg, page)
        if image_block_ids is not None:
            attn = _attention_blockmask(q, k, v, cfg, wl, image_block_ids)
        else:
            attn = prefill_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, softmax_scale=cfg.attn_scale,
                window_size=(wl, -1)).transpose(1, 2)
        x = _attn_residual(x, attn.reshape(n, s, cfg.n_heads * hd), lp, cfg)
        x = _mlp(x, lp, cfg)
        if ks_new is not None:
            ks_new = ks_new.reshape(hkv, n * npg, page)
            vs_new = vs_new.reshape(hkv, n * npg, page)
        ys.append((kq, ks_new, vq, vs_new))
    # ONE page-level scatter for every layer's pages
    L = cfg.n_layers
    lids = (page_ids.reshape(-1)[None, :]
            + torch.arange(L, device=x.device)[:, None] * cache.num_pages
            ).reshape(-1)

    def flat(i):  # L x [hkv, n*npg, ...] -> [hkv, L*n*npg, ...]
        a = torch.stack([y[i] for y in ys], dim=1)
        return a.reshape(a.shape[0], -1, *a.shape[3:])

    cache.k_pages[:, lids] = flat(0)
    cache.v_pages[:, lids] = flat(2)
    if cache.k_scales is not None:
        cache.k_scales[:, lids] = flat(1)
        cache.v_scales[:, lids] = flat(3)
    x = _rms_norm(x, params["final_norm"], cfg)
    last = x[torch.arange(n, device=x.device), (true_lens.long() - 1).clamp(min=0)]
    logits = _unembed(params, last, cfg)
    cache.block_tables[seq_slots] = table_rows
    cache.lengths[seq_slots] = true_lens
    return cache, logits


def prefill_chunk_batch(params, cfg: LlamaConfig, cache: StackedKVCache,
                        reqs_slots, reqs_pages, chunk_tokens, offsets, totals,
                        chunk: int):
    """Advance n prompts by one chunk each, in one batched pass (chunked
    prefill and prefix-cache suffixes). chunk_tokens[i]: THIS chunk's
    tokens (len <= chunk); offsets[i]: absolute, page-aligned position of
    its first token; totals[i]: the full prompt length. Writes the chunk's
    K/V pages, and for rows that finish their prompt the lengths, IN
    PLACE. Returns (cache, logits [n, vocab] fp32): row i is meaningful iff
    the row finished (offsets[i] + len(chunk_tokens[i]) >= totals[i])."""
    page = cache.page_size
    if chunk % page:
        raise ValueError(f"chunk {chunk} is not a multiple of the page size "
                         f"{page}")
    n = len(reqs_slots)
    toks = np.zeros((n, chunk), np.int64)
    offs = np.zeros((n,), np.int64)
    table_rows = np.zeros((n, cache.pages_per_seq), np.int32)
    finals = np.zeros((n,), bool)
    final_lens = np.zeros((n,), np.int64)
    for i in range(n):
        ct = np.asarray(chunk_tokens[i], np.int64)
        if int(offsets[i]) % page or ct.shape[0] > chunk:
            raise ValueError(f"row {i}: offset {offsets[i]} must be page "
                             f"aligned and the chunk at most {chunk} tokens")
        toks[i, : ct.shape[0]] = ct
        offs[i] = int(offsets[i])
        finals[i] = int(offsets[i]) + ct.shape[0] >= int(totals[i])
        final_lens[i] = int(totals[i])
        table_rows[i, : len(reqs_pages[i])] = np.asarray(
            list(reqs_pages[i]), np.int32)
    dev = cache.lengths.device

    def dev_t(a):
        return torch.as_tensor(a, device=dev)

    return _prefill_chunk(params, cfg, cache,
                          dev_t(np.asarray(reqs_slots, np.int64)),
                          dev_t(table_rows), dev_t(toks), dev_t(offs),
                          dev_t(finals), dev_t(final_lens))


def _prefill_chunk(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                   table_rows, tokens, offsets, final_mask, final_lens):
    """One chunk for each of n prompts (mfa_tpu's _prefill_chunk_jit).

    WRITE-THEN-ATTEND, as in the JAX package: each layer first writes the
    chunk's (quantized) K/V rows into its pages, then the paged prefill
    kernel reads the prefix and the chunk back through the block table
    with kv_len = min(final_lens, offsets + chunk) and q_start = offsets,
    so the chunk attends to its own rows after quantization. Padded chunk
    rows past the table width write into the null page 0."""
    n, chunk = tokens.shape
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    page = cache.page_size
    pps = cache.pages_per_seq
    chunk_pages = chunk // page
    P = cache.num_pages  # merged-pool per-layer stride
    dev = tokens.device
    x = _embed(params, tokens, cfg)  # [n, chunk, d]
    positions = offsets[:, None] + torch.arange(chunk, device=dev)[None]
    pidx = offsets[:, None] // page + torch.arange(chunk_pages, device=dev)[None]
    page_ids = torch.where(
        pidx < pps, table_rows.long().gather(1, pidx.clamp(max=pps - 1)),
        torch.zeros((), dtype=torch.long, device=dev)).reshape(-1)
    kv_len = torch.minimum(final_lens, offsets + chunk)
    store = cache.k_pages.dtype
    plan = _layer_ropes(cfg, positions)
    for li, lp in enumerate(params["layers"]):
        wl, rope = plan[li]
        h = _rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(h, lp, cfg, n, chunk)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        ids_l = page_ids + li * P
        kq, ks_new = _store_rows(cache.quant_dtype, store,
                                 k.permute(2, 0, 1, 3).reshape(hkv, -1, hd))
        vq, vs_new = _store_rows(cache.quant_dtype, store,
                                 v.permute(2, 0, 1, 3).reshape(hkv, -1, hd))
        cache.k_pages[:, ids_l] = pack_pages_payload(kq, n * chunk_pages, page)
        cache.v_pages[:, ids_l] = pack_pages_payload(vq, n * chunk_pages, page)
        if ks_new is not None:
            cache.k_scales[:, ids_l] = ks_new.reshape(hkv, n * chunk_pages, page)
            cache.v_scales[:, ids_l] = vs_new.reshape(hkv, n * chunk_pages, page)
        attn = paged_prefill_attention(
            q.to(cfg.dtype), cache.k_pages, cache.v_pages, kv_len, offsets,
            table_rows + li * P, k_scales=cache.k_scales,
            v_scales=cache.v_scales, softmax_scale=cfg.attn_scale,
            causal=True, window_left=wl, quant_dtype=cache.quant_dtype)
        x = _attn_residual(x, attn.reshape(n, chunk, cfg.n_heads * hd), lp, cfg)
        x = _mlp(x, lp, cfg)
    x = _rms_norm(x, params["final_norm"], cfg)
    last_idx = torch.clamp(final_lens - 1 - offsets, 0, chunk - 1)
    logits = _unembed(params, x[torch.arange(n, device=dev), last_idx], cfg)
    cache.lengths[seq_slots] = torch.where(
        final_mask, final_lens, cache.lengths[seq_slots].long()
    ).to(cache.lengths.dtype)
    cache.block_tables[seq_slots] = table_rows
    return cache, logits


def prefill_chunk(params, cfg: LlamaConfig, cache: StackedKVCache,
                  seq_slot: int, pages, tokens_1d, offset: int,
                  total_len: int):
    """Single-request convenience over prefill_chunk_batch: prefill this
    chunk (tokens_1d, starting at absolute page-aligned `offset`) into slot
    seq_slot. Returns (cache, logits [vocab] on the final chunk, else
    None)."""
    tokens_1d = np.asarray(tokens_1d, np.int64)
    n_tok = int(tokens_1d.shape[0])
    chunk = -(-n_tok // cache.page_size) * cache.page_size
    cache, logits = prefill_chunk_batch(
        params, cfg, cache, [seq_slot], [list(pages)], [tokens_1d], [offset],
        [total_len], chunk)
    return cache, (logits[0] if offset + n_tok >= total_len else None)


def decode_step(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                tokens):
    """One decode step for the active batch (DEFERRED-APPEND design).

    seq_slots: [n] cache rows; tokens: [n] current tokens. Returns (cache,
    logits [n, vocab] fp32); the cache is updated IN PLACE. On return the
    consumed token's K/V is in the cache and lengths include it (engine
    invariant lengths == prompt + generated[:-1]).

    With seq_slots and tokens already on the cache's device the step makes
    no host-to-device copy and reads nothing back, so it can be captured
    into a CUDA graph (serve/graphs.py) once an eager step has loaded the
    kernels and the RoPE tables.
    """
    dev = cache.lengths.device
    slots, tokens = _device_ids(seq_slots, dev), _device_ids(tokens, dev)
    n = tokens.shape[0]
    hd = cfg.head_dim
    page = cache.page_size
    lens = cache.lengths[slots]  # [n] int32
    # a row decoding past its table (a finished request's spare burst
    # positions) writes into its own last page, whose slot is released next
    write_pages = cache.block_tables[
        slots, (lens // page).long().clamp(max=cache.pages_per_seq - 1)]
    offs = lens % page
    tables = cache.block_tables[slots]
    x = _embed(params, tokens, cfg)[:, None]  # [n, 1, d]
    positions = lens[:, None]
    store = cache.k_pages.dtype
    plan = _layer_ropes(cfg, positions)
    ys = []
    for li, lp in enumerate(params["layers"]):
        wl, rope = plan[li]
        h = _rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(h, lp, cfg, n, 1)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        kq, ks_new = _store_rows(cache.quant_dtype, store, k[:, 0].transpose(0, 1))
        vq, vs_new = _store_rows(cache.quant_dtype, store, v[:, 0].transpose(0, 1))
        o_c, lse_c = paged_attention(
            q[:, 0].to(cfg.dtype), cache.k_pages, cache.v_pages, lens,
            tables + li * cache.num_pages, k_scales=cache.k_scales,
            v_scales=cache.v_scales, softmax_scale=cfg.attn_scale,
            window_left=wl, quant_dtype=cache.quant_dtype,
            pos_offset=1, return_lse=True,
        )  # [n, heads, hd], [n, heads]
        attn = _merge_deferred(o_c[:, None], lse_c[:, None], q, kq, ks_new,
                               vq, vs_new, cfg)[:, 0]
        x = _attn_residual(x, attn.reshape(n, 1, cfg.n_heads * hd), lp, cfg)
        x = _mlp(x, lp, cfg)
        ys.append((kq, ks_new, vq, vs_new))
    kq_all, vq_all = (torch.stack([y[i] for y in ys]) for i in (0, 2))
    ks_all = vs_all = None
    if cache.k_scales is not None:
        ks_all, vs_all = (torch.stack([y[i] for y in ys]) for i in (1, 3))
    _append_all_layers(cache, kq_all, ks_all, vq_all, vs_all, write_pages, offs)
    x = _rms_norm(x, params["final_norm"], cfg)
    logits = _unembed(params, x[:, 0], cfg)
    cache.lengths[slots] = lens + 1
    return cache, logits


def _device_ids(ids, dev) -> torch.Tensor:
    """Token or slot ids as int64 on `dev`: a tensor already there is used
    as it is, host values are copied without a stream wait."""
    if isinstance(ids, torch.Tensor) and ids.device == dev:
        return ids.long()
    return host_to_device(np.asarray(ids), torch.long, dev)


def greedy_step(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                tokens):
    """decode_step, its argmax and the argmax's logprob: one step of
    decode_burst, and what a decode graph of the serving engine holds
    (serve/graphs.py). Returns (logits [n, vocab] fp32, ids [n] int64,
    logprobs [n] fp32); the cache is updated IN PLACE."""
    _, logits = decode_step(params, cfg, cache, seq_slots, tokens)
    ids = sample(logits)
    return logits, ids, token_logprobs(logits, ids)


def decode_burst(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                 tokens, n_steps: int):
    """n_steps greedy decode steps, each step's argmax fed to the next on
    the device (mfa_tpu's decode_burst, greedy only). Pages for all n_steps
    positions must already be mapped. Returns (cache, tokens [n_steps, n]
    int64, logprobs [n_steps, n] fp32) on the cache's device; the cache is
    updated IN PLACE. A plain loop of greedy_step: the serving engine
    replays the same step from CUDA graphs on the card."""
    dev = cache.lengths.device
    slots, toks = _device_ids(seq_slots, dev), _device_ids(tokens, dev)
    out, lps = [], []
    for _ in range(n_steps):
        _, toks, lp = greedy_step(params, cfg, cache, slots, toks)
        out.append(toks)
        lps.append(lp)
    return cache, torch.stack(out), torch.stack(lps)
