"""Llama-style transformer: serving and training (counterpart of mfa_tpu/models/llama.py).

Params are a plain dict of tensors: `layers` is a list of per-layer dicts
(wq, wk, wv, wo, attn_norm, mlp_norm, w_gate, w_up, w_down; Gemma3 adds
q_norm, k_norm, post_attn_norm, post_mlp_norm; Qwen2 bq, bk, bv), plus
embed, final_norm and lm_head. Projections go through models/wquant.qmm:
plain `@` for bf16 weights (as the JAX package leaves them to XLA), the
int8 matmul kernel (kernels/wmatmul.py) for QWeight weights
(init_params(quantize="int8") or wquant.quantize_params); the embedding
through qtake. Attention runs
through the port's kernels: prefill_batch -> kernels/prefill.py (the
default engine: the zero-shift kernel with its poison flag, then the
repair kernel), or kernels/blockmask.py (the image-block kernel) for image
prompts, prefill_chunk_batch -> kernels/paged_prefill.py, decode_step and verify_step ->
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
reference numerics. verify_step is the same step over a span of tokens
(speculative verification: kernel 6 on [n, span] queries with
pos_offset=span, the span's own rows merged under an intra-span causal
mask); rollback resets lengths; decode_burst samples (serve/sampling.py)
with noise from an explicit generator; speculative_burst runs greedy
draft / verify / accept iterations on the device.

The dense families of mfa_tpu's presets (LlamaConfig.mistral_7b,
qwen2_7b, gemma_7b, qwen3_8b, gemma2_9b): q/k/v bias (Qwen2: bq, bk, bv
added before the head reshape, kept in full precision by
wquant.quantize_params), the Gemma2 attention softcap (tanh(s * scale /
cap) * cap on the scaled scores, passed to every attention kernel as
logit_softcap; prefill then runs kernel 1, the classic engine), the final
logit softcap (_unembed, fp32) and alternating sliding / global layers
(alt_window). Checkpoints load through models/convert.py.

Mixture of experts (LlamaConfig.mixtral_8x7b; Qwen3-MoE's moe_ffn_dim
and full-softmax weights; Qwen2-MoE's gated shared expert; dense layers
mixed in by moe_layer_pattern): a MoE layer holds w_router [d, E] fp32 and
the banks we_gate / we_up [E, d, f] and we_down [E, f, d] in place of
w_gate / w_up / w_down. _moe routes in true fp32 (_moe_route), then runs
the dense form (every expert over every row, wquant.bank_dense: decode,
burst and verify steps, which replay from CUDA graphs, and any call of at
most _MOE_DENSE_MAX_T rows) or the grouped form (rows sorted by expert,
wquant.bank_grouped), and sums each token's experts in slot order without
atomics. int8 banks run kernel 10's expert launch in both forms.

Attention sinks (`attn_sinks`, StreamingLLM) reach every attention call
with a left window: prefill waves, chunks, decode and verify steps and the
train attention; the image-block kernel takes none and raises on them.

Meshes (shard/mesh.py: a DeviceMesh with mfa_tpu's axis names; SPMD, so
every rank calls these functions on its own shard with the same global
cfg). shard_params / init_params(mesh=) / params_from_numpy(mesh=) give a
rank its block of the weights (param_shardings: the columns of wq, wk, wv,
w_gate, w_up, ws_gate, ws_up and the q/k/v biases, the rows of wo, w_down
and ws_down on "model", the banks' E on "expert" and their ffn dim on
"model"; the rest replicated; under a "pipe" axis only its stage's layers,
stage_layers), build_kv_caches(mesh=) its kv heads. Every
function below that takes mesh= in mfa_tpu takes it here; the head counts
come from the weights' shapes, so attention runs on the rank's whole kv
heads (with their q-head groups) with no communication, and the one
all-reduce a projection pair that GSPMD inserts for mfa_tpu is explicit:
after wo, after w_down (and after the MoE combine), in the model dtype.
With an "expert" axis the routed experts run expert-parallel
(shard/expert.py). forward / loss_fn / train_step also take a "data" axis:
loss_fn gives each rank its rows of the global batch, sums the loss over
the axis and, like train_step, every rank gets the full gradients.

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
                                             pack_pages_payload, payload_rows,
                                             scatter_span_rows, write_pages)
from mfa_tpu_torch.dispatch.config import host_to_device, resolve_device
from mfa_tpu_torch.kernels.autodiff import flash_attention_grad
from mfa_tpu_torch.kernels.blockmask import (dense_masked_attention,
                                             image_block_prefill)
from mfa_tpu_torch.kernels.paged import paged_attention
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.kernels.quant import as_bytes
from mfa_tpu_torch.models.wquant import (QWeight, adapt_shardings, bank_dense,
                                         bank_grouped, qmm, qtake,
                                         quantize_params, quantize_weight,
                                         stack_bank)
from mfa_tpu_torch.serve.sampling import (SamplingParams, gumbel_from_uniform,
                                          sample, sample_dynamic,
                                          token_logprobs, uniform_noise)
from mfa_tpu_torch.shard.mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS,
                                      PIPE_AXIS, axis_index, axis_size,
                                      copy_to, local_slice, reduce_from,
                                      shard_tensor, sharding)


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
    # the dense families' knobs (mfa_tpu's LlamaConfig)
    qkv_bias: bool = False                   # Qwen2: bias on q/k/v proj
    attn_softcap: Optional[float] = None     # Gemma2: tanh cap on attention logits
    logit_softcap: Optional[float] = None    # Gemma2: tanh cap on final logits
    alt_window: bool = False                 # even layers sliding, odd global
    # attention sinks (the kernels' sink_tokens): with a sliding window the
    # first attn_sinks tokens stay visible to every query (StreamingLLM)
    attn_sinks: int = 0
    # mixture of experts (mfa_tpu's LlamaConfig): n_experts > 0 replaces
    # the MLP by top-k routed experts; moe_ffn_dim: expert width when it is
    # not ffn_dim (Qwen3-MoE); norm_topk: weights a softmax over the chosen
    # experts (Mixtral) or the full softmax's (Qwen3-MoE); a shared expert
    # of shared_expert_dim on every token, sigmoid-gated with
    # shared_expert_gate (Qwen2-MoE); moe_layer_pattern: per-layer flags,
    # True = expert layer, False = dense MLP (Qwen-MoE's interleave)
    n_experts: int = 0
    n_active_experts: int = 2
    moe_ffn_dim: Optional[int] = None
    norm_topk: bool = True
    shared_expert_dim: Optional[int] = None
    shared_expert_gate: bool = False
    moe_layer_pattern: Optional[tuple] = None

    def __post_init__(self):
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
    def moe_hetero(self) -> bool:
        """True when MoE and dense MLP layers interleave."""
        p = self.moe_layer_pattern
        return p is not None and (True in p) and (False in p)

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer i holds routed experts."""
        if self.moe_layer_pattern is None:
            return bool(self.n_experts)
        return bool(self.moe_layer_pattern[i])

    @property
    def sliding_pattern(self) -> Optional[tuple]:
        """Repeating per-layer sliding flags, or None (uniform layers)."""
        if self.layer_pattern is not None:
            return tuple(self.layer_pattern)
        if self.alt_window:
            return (True, False)
        return None

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """meta-llama/Meta-Llama-3-8B config.json: 32 layers, dim 4096,
        32 q / 8 kv heads, ffn 14336, vocab 128256, rope_theta 5e5."""
        return LlamaConfig(vocab_size=128256)

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        """Mistral-7B (mistralai/Mistral-7B-v0.1 config.json): 32 layers,
        dim 4096, 32 q / 8 kv heads, ffn 14336, vocab 32000, rope_theta
        1e4, a 4096-token sliding window on every layer."""
        return LlamaConfig(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            ffn_dim=14336, rope_theta=10000.0, sliding_window=4096)

    @staticmethod
    def h2o_danube_1_8b() -> "LlamaConfig":
        """H2O-Danube-1.8B (h2oai/h2o-danube-1.8b-base config.json, a
        Mistral-architecture model; arXiv 2401.16818, Table 1): 24 layers,
        dim 2560, 32 q / 8 kv heads of 80, ffn 6912, vocab 32000,
        rope_theta 1e4, rms_norm_eps 1e-5, a 4096-token sliding window,
        untied lm_head."""
        return LlamaConfig(
            vocab_size=32000, dim=2560, n_layers=24, n_heads=32, n_kv_heads=8,
            ffn_dim=6912, rope_theta=10000.0, norm_eps=1e-5,
            sliding_window=4096)

    @staticmethod
    def qwen2_7b() -> "LlamaConfig":
        """Qwen2-7B (Qwen/Qwen2-7B config.json): 28 layers, dim 3584, 28 q
        / 4 kv heads (a group of 7), ffn 18944, vocab 152064, rope_theta
        1e6, rms_norm_eps 1e-6, bias on the q/k/v projections."""
        return LlamaConfig(
            vocab_size=152064, dim=3584, n_layers=28, n_heads=28, n_kv_heads=4,
            ffn_dim=18944, rope_theta=1000000.0, norm_eps=1e-6, qkv_bias=True)

    @staticmethod
    def gemma_7b() -> "LlamaConfig":
        """Gemma-7B (google/gemma-7b config.json): 28 layers, dim 3072, 16
        q / 16 kv heads of head_dim 256, ffn 24576, vocab 256000, gelu-tanh,
        (1 + w) RMSNorms, sqrt(dim)-scaled embeddings, tied lm_head."""
        return LlamaConfig(
            vocab_size=256000, dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
            ffn_dim=24576, rope_theta=10000.0, norm_eps=1e-6,
            head_dim_override=256, hidden_act="gelu_tanh", norm_offset=True,
            embed_scale=True)

    @staticmethod
    def mixtral_8x7b() -> "LlamaConfig":
        """Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 config.json): 32
        layers, dim 4096, 32 q / 8 kv heads, ffn 14336 in each of 8
        experts, top 2, vocab 32000, rope_theta 1e6, no sliding window."""
        return LlamaConfig(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            ffn_dim=14336, rope_theta=1000000.0, n_experts=8, n_active_experts=2)

    @staticmethod
    def qwen3_8b() -> "LlamaConfig":
        """Qwen3-8B (Qwen/Qwen3-8B config.json): 36 layers, dim 4096, 32 q
        / 8 kv heads of head_dim 128, ffn 12288, vocab 151936, rope_theta
        1e6, per-head q/k RMSNorms, no qkv bias."""
        return LlamaConfig(
            vocab_size=151936, dim=4096, n_layers=36, n_heads=32, n_kv_heads=8,
            ffn_dim=12288, rope_theta=1000000.0, norm_eps=1e-6,
            head_dim_override=128, qk_norm=True)

    @staticmethod
    def gemma2_9b() -> "LlamaConfig":
        """Gemma2-9B (google/gemma-2-9b config.json): 42 layers, dim 3584,
        16 q / 8 kv heads of head_dim 256, ffn 14336, vocab 256000, a
        4096-token window on the even layers and full attention on the odd
        ones, attention softcap 50, final logit softcap 30,
        query_pre_attn_scalar 256, post norms, gelu-tanh."""
        return LlamaConfig(
            vocab_size=256000, dim=3584, n_layers=42, n_heads=16, n_kv_heads=8,
            ffn_dim=14336, rope_theta=10000.0, norm_eps=1e-6,
            head_dim_override=256, hidden_act="gelu_tanh", norm_offset=True,
            embed_scale=True, sliding_window=4096, attn_softcap=50.0,
            logit_softcap=30.0, query_scale=256.0 ** -0.5, post_norms=True,
            alt_window=True)

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
_BIAS_KEYS = ("bq", "bk", "bv")
_MOE_KEYS = ("w_router", "we_gate", "we_up", "we_down")
_SHARED_KEYS = ("ws_gate", "ws_up", "ws_down", "w_shared_gate")


def _layer_keys(cfg: LlamaConfig, moe: bool = False) -> tuple:
    """The per-layer weight names of this config, in a fixed order; moe: of
    a layer with routed experts (its banks replace w_gate, w_up, w_down)."""
    extra = (("q_norm", "k_norm") if cfg.qk_norm else ()) + (
        ("post_attn_norm", "post_mlp_norm") if cfg.post_norms else ()) + (
        _BIAS_KEYS if cfg.qkv_bias else ())
    if not moe:
        return _LAYER_KEYS + extra
    shared = ()
    if cfg.shared_expert_dim:
        shared = _SHARED_KEYS if cfg.shared_expert_gate else _SHARED_KEYS[:3]
    return _LAYER_KEYS[:6] + _MOE_KEYS + shared + extra


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda",
                quantize: Optional[str] = None, mesh=None) -> Params:
    """Random weights in cfg.dtype from a seeded torch.Generator on the
    device (normal * fan_in^-0.5, embed * 0.02; fp32 norms at their
    identity: one, or zero under norm_offset, which applies 1 + w).

    quantize="int8": every matmul weight, expert bank and the embedding
    become QWeight (models/wquant.py), each layer and table quantized as
    soon as it is built and each expert bank one expert slice at a time, so
    the bf16 model never exists whole (peak: the int8 tree and one bf16
    table). The same seed gives the weights quantize_params(...,
    include_experts=True) would give for the bf16 init.

    MoE layers (cfg.is_moe_layer) hold w_router [d, E] fp32 * d^-0.5 and
    banks [E, d, f] / [E, f, d] in place of the dense MLP, plus the shared
    expert (and its [d, 1] gate) where the config has one, as mfa_tpu's
    init_params builds them.

    mesh: the rank's shard (shard_params) of the same weights, each layer
    cut as soon as it is drawn (and another stage's layer dropped), so a
    rank holds one whole layer at most."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported weight quantization {quantize!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hd = cfg.dim, cfg.head_dim

    def dense(shape, scale=None):
        w = torch.randn(shape, generator=gen, device=dev, dtype=cfg.dtype)
        return w.mul_(scale if scale is not None else shape[-2] ** -0.5)

    def bank(shape):  # drawn (and quantized) one expert slice at a time
        return stack_bank((dense(shape) for _ in range(cfg.n_experts)),
                          cfg.n_experts, bool(quantize))

    def norm(width=d):
        fill = torch.zeros if cfg.norm_offset else torch.ones
        return fill((width,), dtype=torch.float32, device=dev)

    keep = stage_layers(cfg, mesh)
    layers = []
    for li in range(cfg.n_layers):
        lp = dict(
            wq=dense((d, cfg.n_heads * hd)),
            wk=dense((d, cfg.n_kv_heads * hd)),
            wv=dense((d, cfg.n_kv_heads * hd)),
            wo=dense((cfg.n_heads * hd, d)),
            attn_norm=norm(),
            mlp_norm=norm(),
        )
        if cfg.is_moe_layer(li):
            fe = cfg.moe_ffn_dim or cfg.ffn_dim
            lp.update(
                w_router=torch.randn((d, cfg.n_experts), generator=gen, device=dev,
                                     dtype=torch.float32).mul_(d ** -0.5),
                we_gate=bank((d, fe)), we_up=bank((d, fe)), we_down=bank((fe, d)))
            if cfg.shared_expert_dim:
                fs = cfg.shared_expert_dim
                lp.update(ws_gate=dense((d, fs)), ws_up=dense((d, fs)),
                          ws_down=dense((fs, d)))
                if cfg.shared_expert_gate:
                    lp.update(w_shared_gate=dense((d, 1)))
        else:
            lp.update(w_gate=dense((d, cfg.ffn_dim)), w_up=dense((d, cfg.ffn_dim)),
                      w_down=dense((cfg.ffn_dim, d)))
        if cfg.qk_norm:
            lp.update(q_norm=norm(hd), k_norm=norm(hd))
        if cfg.post_norms:
            lp.update(post_attn_norm=norm(), post_mlp_norm=norm())
        if cfg.qkv_bias:  # zeros, as mfa_tpu's init_params
            lp.update({k: torch.zeros((w,), dtype=cfg.dtype, device=dev)
                       for k, w in zip(_BIAS_KEYS, (cfg.n_heads * hd,
                                                    cfg.n_kv_heads * hd,
                                                    cfg.n_kv_heads * hd))})
        if li not in keep:  # drawn all the same, so the seed gives one model
            continue
        lp = quantize_params(lp) if quantize else lp
        layers.append(_shard_layer(lp, cfg, li, mesh) if mesh is not None else lp)
    embed = dense((cfg.vocab_size, d), 0.02)
    if quantize:
        embed = quantize_weight(embed, axis=-1)
    lm_head = dense((d, cfg.vocab_size))
    if quantize:
        lm_head = quantize_weight(lm_head, axis=-2)
    return dict(layers=layers, embed=embed, final_norm=norm(), lm_head=lm_head)


def params_from_numpy(tree, cfg: LlamaConfig, device, mesh=None) -> Params:
    """The JAX package's params pytree (numpy arrays; layers stacked
    [L, ...] as mfa_tpu's init_params builds them, or with MoE and dense
    layers interleaved its {"moe": ..., "dense": ...} stacks, each in layer
    order) -> this port's params, so both packages compute the same
    function in the tests. A quantized leaf (mfa_tpu's QWeight, read by its
    qw, scale and axis attributes) becomes this port's QWeight. mesh: the
    rank's shard (shard_params)."""
    dev = torch.device(device)
    keep = stage_layers(cfg, mesh)

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
        dtype = torch.float32 if name in _NORMS + ("w_router",) else cfg.dtype
        return torch.tensor(a, dtype=dtype, device=dev)

    stacks = tree["layers"]
    layers, seen = [], {True: 0, False: 0}
    for li in range(cfg.n_layers):
        moe = cfg.is_moe_layer(li)
        # the hetero layout's stacks map back to layer order by the pattern
        stacked = (stacks["moe" if moe else "dense"] if cfg.moe_hetero
                   else stacks)
        pos = seen[moe] if cfg.moe_hetero else li
        seen[moe] += 1
        if li not in keep:
            continue
        keys = _layer_keys(cfg, moe)
        extra = set(stacked) - set(keys)
        if extra:
            raise NotImplementedError(f"layer params {sorted(extra)} are not "
                                      f"ported yet")
        lp = {k: t(stacked[k], k, pos) for k in keys}
        layers.append(_shard_layer(lp, cfg, li, mesh) if mesh is not None else lp)
    return dict(layers=layers, embed=t(tree["embed"], "embed"),
                final_norm=t(tree["final_norm"], "final_norm"),
                lm_head=t(tree["lm_head"], "lm_head"))


# Placement of a layer's weights on a mesh (mfa_tpu's param_shardings,
# without the stacked layer dim): columns or rows on "model", banks on
# "expert" and their ffn dim on "model".
_COLUMNS = ("wq", "wk", "wv", "w_gate", "w_up", "ws_gate", "ws_up")
_ROWS = ("wo", "w_down", "ws_down")


def _check_heads(cfg: LlamaConfig, mesh) -> None:
    tp = axis_size(mesh, MODEL_AXIS)
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(f"the model axis ({tp} ranks) must divide n_heads "
                         f"{cfg.n_heads} and n_kv_heads {cfg.n_kv_heads}: a "
                         "rank holds whole kv heads and their q-head groups")


def param_shardings(cfg: LlamaConfig, mesh) -> dict:
    """The Sharding (shard/mesh.py) of every param: {"layers": [per-layer
    {name: Sharding}], "embed", "final_norm", "lm_head"} (mfa_tpu's
    param_shardings). Under an "expert" axis the banks [E, d, f] / [E, f,
    d] shard on E, and with "model" on f too; embed, lm_head, norms, the
    router and w_shared_gate are replicated."""
    tp = MODEL_AXIS if axis_size(mesh, MODEL_AXIS) > 1 else None
    ep = EXPERT_AXIS if axis_size(mesh, EXPERT_AXIS) > 1 else None
    rep_ = sharding(mesh)
    named = {**{k: sharding(mesh, None, tp) for k in _COLUMNS},
             **{k: sharding(mesh, tp, None) for k in _ROWS},
             **{k: sharding(mesh, tp) for k in _BIAS_KEYS},
             "we_gate": sharding(mesh, ep, None, tp),
             "we_up": sharding(mesh, ep, None, tp),
             "we_down": sharding(mesh, ep, tp, None)}
    layers = [{k: named.get(k, rep_) for k in _layer_keys(cfg, cfg.is_moe_layer(i))}
              for i in range(cfg.n_layers)]
    return dict(layers=layers, embed=rep_, final_norm=rep_, lm_head=rep_)


def stage_layers(cfg: LlamaConfig, mesh) -> range:
    """The layers a rank holds: under a "pipe" axis of S ranks, rank p's
    contiguous block [p L / S, (p + 1) L / S) (shard/pipeline.py runs
    it); else all of them."""
    n_stages = axis_size(mesh, PIPE_AXIS)
    if n_stages == 1:
        return range(cfg.n_layers)
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} must divide into "
                         f"{n_stages} stages")
    if cfg.layer_pattern is not None or cfg.moe_hetero:
        raise ValueError("pipeline stages need a uniform layer stack")
    per = cfg.n_layers // n_stages
    lo = axis_index(mesh, PIPE_AXIS) * per
    return range(lo, lo + per)


def _shard_leaf(w, sh, name):
    """w's block under sh, a Sharding adapted to w (wquant.adapt: a
    QWeight's scale drops the reduced axis)."""
    if isinstance(w, QWeight):
        return QWeight(qw=shard_tensor(w.qw, sh.qw, name),
                       scale=shard_tensor(w.scale, sh.scale, name), axis=w.axis)
    return shard_tensor(w, sh, name)


def _shard_layer(lp: dict, cfg: LlamaConfig, li: int, mesh) -> dict:
    _check_heads(cfg, mesh)
    specs = adapt_shardings(param_shardings(cfg, mesh)["layers"][li], lp)
    return {k: _shard_leaf(w, specs[k], k) for k, w in lp.items()}


def shard_params(params: Params, cfg: LlamaConfig, mesh) -> Params:
    """This rank's block of a full params tree (bf16 or QWeight leaves) under
    param_shardings(cfg, mesh), and only its stage's layers under "pipe"
    (stage_layers): what every mesh path of this module, the Engine and
    shard/pipeline.py take. The model axis must divide n_heads and
    n_kv_heads."""
    return dict(params, layers=[_shard_layer(params["layers"][li], cfg, li, mesh)
                                for li in stage_layers(cfg, mesh)])


def _check_stack(params: Params, cfg: LlamaConfig) -> None:
    """The functions below run the whole stack: a pipeline stage's tree
    (stage_layers) runs only in shard/pipeline.py."""
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"params hold {len(params['layers'])} of "
                         f"{cfg.n_layers} layers (a pipeline stage's): run "
                         "them through shard/pipeline.py")



def _rms_norm(x, w, cfg: LlamaConfig):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    if cfg.norm_offset:  # Gemma: the weight is stored as w, applied 1 + w
        w = 1.0 + w
    return (xf * torch.rsqrt(var + cfg.norm_eps) * w).to(x.dtype)


def _qkv(h, lp, cfg: LlamaConfig, *lead, mesh=None):
    """q [*lead, heads, hd], k, v [*lead, kv heads, hd]: the heads of the
    weights given (a rank's heads under a "model" axis)."""
    hd = cfg.head_dim
    h = copy_to(h, mesh, MODEL_AXIS)
    q, k, v = qmm(h, lp["wq"]), qmm(h, lp["wk"]), qmm(h, lp["wv"])
    if cfg.qkv_bias:  # Qwen2: bias before the head reshape
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(*lead, -1, hd)
    k = k.reshape(*lead, -1, hd)
    v = v.reshape(*lead, -1, hd)
    if cfg.qk_norm:  # each head normalized before RoPE (a rank's heads only)
        q = _rms_norm(q, copy_to(lp["q_norm"], mesh, MODEL_AXIS), cfg)
        k = _rms_norm(k, copy_to(lp["k_norm"], mesh, MODEL_AXIS), cfg)
    return q, k, v


def _act(x, hidden_act: str):
    """The family activation on the gate projection (gelu_tanh: Gemma)."""
    if hidden_act == "gelu_tanh":
        return torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu(x)


def _moe_route(t, w_router, k: int, norm_topk: bool):
    """fp32 router and top-k (mfa_tpu's _moe_route) -> (w_top [T, k] fp32,
    idx [T, k] expert ids). norm_topk: a softmax over the chosen experts'
    logits (Mixtral); else their full-softmax weights (Qwen3-MoE). The
    product runs in true fp32: with TF32 a near-tie flips and sends a token
    to another expert, so a CUDA call refuses it."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("MoE routing needs true fp32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    logits = t.float() @ w_router.float()  # [T, E]
    w_top, idx = torch.topk(logits, k, dim=-1)
    if norm_topk:
        w_top = torch.softmax(w_top, dim=-1)
    else:
        w_top = torch.softmax(logits, dim=-1).gather(1, idx)
    return w_top, idx


# Below this many rows the dense form (every expert over every row) costs
# less than streaming the bank for the grouped form (mfa_tpu's cut-over).
_MOE_DENSE_MAX_T = 64


def _moe_dense(t, lp, w_top, idx, cfg: LlamaConfig):
    """Every expert over all T rows, then a router-weighted combine
    (mfa_tpu's _moe_dense_int8): three bank launches, no host read, no
    data-dependent shape, so a graphed step can hold it."""
    g = _act(bank_dense(t, lp["we_gate"]), cfg.hidden_act)
    o = bank_dense(g * bank_dense(t, lp["we_up"]), lp["we_down"])  # [E, T, d]
    # router weights as a [T, E] scatter (the top-k ids of a row are distinct)
    mw = torch.zeros((t.shape[0], cfg.n_experts), dtype=torch.float32,
                     device=t.device).scatter(1, idx, w_top)
    return torch.einsum("etd,te->td", o, mw.to(o.dtype))


def _moe_grouped(t, lp, w_top, idx, cfg: LlamaConfig):
    """The token-expert pairs sorted by expert (stable: ties keep token
    order) through one grouped bank launch a projection (mfa_tpu's ragged
    _moe), then each token's k outputs summed in slot order through the
    inverse permutation: a gather, no atomics, the same bits every run."""
    T, k = idx.shape
    flat_e = idx.reshape(-1)  # [T * k]
    sorted_e, order = torch.sort(flat_e, stable=True)
    gathered = t[order // k]  # [T * k, d] expert-sorted
    offs = torch.searchsorted(sorted_e, torch.arange(
        cfg.n_experts + 1, device=t.device, dtype=sorted_e.dtype)).to(torch.int32)
    gate = _act(bank_grouped(gathered, lp["we_gate"], offs, T), cfg.hidden_act)
    down = bank_grouped(gate * bank_grouped(gathered, lp["we_up"], offs, T),
                        lp["we_down"], offs, T)  # [T * k, d]
    return _slot_sum(down, w_top, order)


def _slot_sum(per_assignment, w_top, order):
    """Each token's k expert outputs, weighted, summed in slot order.
    per_assignment: [T * k, d] in `order` (a permutation of the flat
    token-major assignments); the inverse permutation is a gather, so no
    atomics and the same bits every run."""
    T, k = w_top.shape
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    per = per_assignment.index_select(0, inv).reshape(T, k, -1)
    w = w_top.to(per.dtype)
    out = per[:, 0] * w[:, :1]
    for j in range(1, k):
        out = out + per[:, j] * w[:, j:j + 1]
    return out


def _moe(x, lp, cfg: LlamaConfig, dense: bool = False, mesh=None):
    """Top-k routed expert MLP, token-dropless (mfa_tpu's _moe): the dense
    form when `dense` (graphed steps) or at most _MOE_DENSE_MAX_T rows,
    else the grouped form; then the shared expert (sigmoid-gated on the
    normed rows with w_shared_gate) and the post norm, and the residual.
    With an "expert" axis the routed part runs expert-parallel
    (shard/expert.py, reduced over "expert" and "model" there); under
    "model" alone the banks' ffn dim is the rank's, and the routed and
    shared partial sums take one all-reduce."""
    from mfa_tpu_torch.shard.expert import (expert_parallel_moe,
                                            use_expert_parallel)

    h = _rms_norm(x, lp["mlp_norm"], cfg)
    lead = h.shape[:-1]
    t = copy_to(h.reshape(-1, h.shape[-1]), mesh, MODEL_AXIS)  # [T, d]
    ep = use_expert_parallel(mesh)
    if ep:
        out = expert_parallel_moe(mesh, cfg, dense)(
            t, lp["w_router"], lp["we_gate"], lp["we_up"], lp["we_down"])
    else:
        w_top, idx = _moe_route(t, lp["w_router"], cfg.n_active_experts,
                                cfg.norm_topk)
        form = (_moe_dense if dense or t.shape[0] <= _MOE_DENSE_MAX_T
                else _moe_grouped)
        out = form(t, lp, w_top, idx, cfg)
    if "ws_gate" in lp:
        sg = _act(qmm(t, lp["ws_gate"]), cfg.hidden_act)
        sh = qmm(sg * qmm(t, lp["ws_up"]), lp["ws_down"])
        if "w_shared_gate" in lp:
            sh = sh * torch.sigmoid(
                t.float() @ lp["w_shared_gate"].float()).to(sh.dtype)
        if ep:  # the routed part is reduced already
            sh = reduce_from(sh, mesh, MODEL_AXIS)
        out = out + sh.to(out.dtype)
    if not ep:
        out = reduce_from(out, mesh, MODEL_AXIS)
    out = out.reshape(*lead, -1)
    if cfg.post_norms:
        out = _rms_norm(out, lp["post_mlp_norm"], cfg)
    return x + out.to(x.dtype)


def _mlp(x, lp, cfg: LlamaConfig, dense_moe: bool = False, mesh=None):
    """The layer's MLP: routed experts where the layer holds a bank (the
    dense form under dense_moe), else the gated dense MLP (its w_down
    partial sums all-reduced over "model")."""
    if "we_gate" in lp:
        return _moe(x, lp, cfg, dense=dense_moe, mesh=mesh)
    h = copy_to(_rms_norm(x, lp["mlp_norm"], cfg), mesh, MODEL_AXIS)
    gate = _act(qmm(h, lp["w_gate"]), cfg.hidden_act)
    out = reduce_from(qmm(gate * qmm(h, lp["w_up"]), lp["w_down"]), mesh,
                      MODEL_AXIS)
    if cfg.post_norms:
        out = _rms_norm(out, lp["post_mlp_norm"], cfg)
    return x + out


def _attn_residual(x, attn_flat, lp, cfg: LlamaConfig, mesh=None):
    """o-projection (its partial sums all-reduced over "model") + post-
    attention norm + residual. attn_flat: [..., heads * head_dim]."""
    out = reduce_from(qmm(attn_flat.to(x.dtype), lp["wo"]), mesh, MODEL_AXIS)
    if cfg.post_norms:
        out = _rms_norm(out, lp["post_attn_norm"], cfg)
    return x + out


def _embed(params, tokens, cfg: LlamaConfig):
    x = qtake(params["embed"], tokens)
    if cfg.embed_scale:  # Gemma: sqrt(dim) rounded to the activation dtype
        x = x * float(torch.tensor(cfg.dim ** 0.5, dtype=x.dtype))
    return x


def _unembed(params, x, cfg: LlamaConfig):
    logits = qmm(x, params["lm_head"]).float()
    if cfg.logit_softcap:  # Gemma2: tanh cap on the fp32 logits
        cap = float(cfg.logit_softcap)
        logits = torch.tanh(logits / cap) * cap
    return logits


def _softcap(cfg: LlamaConfig) -> float:
    """The attention softcap every attention kernel takes (0 = none)."""
    return float(cfg.attn_softcap or 0.0)


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
    return ([lp[k] for lp in params["layers"]
             for k in _LAYER_KEYS + _GEMMA_KEYS + _BIAS_KEYS + _MOE_KEYS
             + _SHARED_KEYS if k in lp]
            + [params[k] for k in ("embed", "final_norm", "lm_head")])


def _attention_blockmask(q, k, v, cfg: LlamaConfig, window_left: int,
                         block_ids):
    """Attention on [b, s, h, d] under the Gemma3 multimodal mask, (causal
    AND window) OR same-image-run, through the image-block kernel
    (kernels/blockmask.py). block_ids [b, s] int32: contiguous image-run
    id per token, -1 = text. The image-block kernel takes no softcap (as
    in JAX) and no sinks."""
    if cfg.attn_softcap or cfg.attn_sinks:
        raise NotImplementedError("softcap or sinks with the image-block mask")
    return image_block_prefill(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), block_ids,
        softmax_scale=cfg.attn_scale, window_left=window_left).transpose(1, 2)


def _attention_dense_masked(q, k, v, cfg: LlamaConfig, window_left: int,
                            extra_mask):
    """Dense fp32 attention on [b, s, h, d] with mask = (causal AND (window
    OR sinks)) OR extra_mask [b, s, s]: the reference of the multimodal
    mask algebra that the image-block kernel tiles (mfa_tpu's
    _attention_dense_masked, with the model's sinks)."""
    s = q.shape[1]
    row = torch.arange(s, device=q.device)[:, None]
    col = torch.arange(s, device=q.device)[None, :]
    band = col <= row
    if window_left >= 0:
        band &= (col >= row - window_left) | (col < cfg.attn_sinks)
    return dense_masked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        band[None] | extra_mask.to(q.device), cfg.attn_scale,
        softcap=_softcap(cfg)).transpose(1, 2)


def _train_layer(x, lp, wl, rope, cfg: LlamaConfig, image_block_ids=None,
                 mesh=None):
    """One decoder layer on the full sequence x [b, s, dim]: causal flash
    attention with this layer's window through the differentiable kernels
    on the rank's heads (_attention_sharded of the JAX package), or the
    image-block kernel under image_block_ids (no gradient), then the MLP."""
    b, s, _ = x.shape
    h = _rms_norm(x, lp["attn_norm"], cfg)
    q, k, v = _qkv(h, lp, cfg, b, s, mesh=mesh)
    q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
    if image_block_ids is not None:
        attn = _attention_blockmask(q, k, v, cfg, wl, image_block_ids)
    else:
        attn = flash_attention_grad(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
            softmax_scale=cfg.attn_scale, window_size=(wl, -1),
            logit_softcap=_softcap(cfg),
            sink_tokens=cfg.attn_sinks).transpose(1, 2)
    x = _attn_residual(x, attn.reshape(b, s, -1), lp, cfg, mesh)
    return _mlp(x, lp, cfg, mesh=mesh)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False, input_embeds=None,
            image_block_ids=None, mesh=None) -> torch.Tensor:
    """Full-sequence causal forward: tokens [b, s] -> logits [b, s, vocab]
    fp32. remat=True checkpoints each layer (torch.utils.checkpoint,
    non-reentrant): the backward recomputes the layer, so its attention
    forward runs twice.

    input_embeds: optional [b, s, dim] embeddings (multimodal: image
    features already merged, models/vision.py). image_block_ids: optional
    [b, s] int32 image-run id per token (-1 = text); it ORs same-run
    visibility into the causal/window mask and routes attention through
    the image-block kernel, which has no backward: inference only, as in
    JAX (on the card the kernel refuses inputs that require grad).

    mesh: the rank's params shard (module docstring); logits of the rows
    given, the same on every rank of "model"."""
    _check_stack(params, cfg)
    s = tokens.shape[1]
    x = input_embeds if input_embeds is not None else _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)[None]
    for lp, (wl, rope) in zip(params["layers"], _layer_ropes(cfg, positions)):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _train_layer, x, lp, wl, rope, cfg, image_block_ids, mesh,
                use_reentrant=False)
        else:
            x = _train_layer(x, lp, wl, rope, cfg, image_block_ids, mesh)
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


def _tree_copy_to(tree, mesh, axis):
    """Every tensor of the params tree through copy_to: the same values,
    whose gradients autograd sums over the axis."""
    if isinstance(tree, dict):
        return {k: _tree_copy_to(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy_to(v, mesh, axis) for v in tree]
    return copy_to(tree, mesh, axis) if isinstance(tree, torch.Tensor) else tree


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False, mesh=None) -> torch.Tensor:
    """Mean next-token cross entropy of tokens [b, s] (tokens[:, :-1]
    predict tokens[:, 1:]). Raises on int8 (QWeight) params.

    mesh: the rank's params shard; tokens are the global batch on every
    rank, and a "data" axis gives each rank its rows (b must divide). The
    loss is the global mean on every rank, and its backward gives every
    rank the full gradients of its shard."""
    _refuse_qweights(params, "loss_fn")
    n_all = tokens.shape[0] * (tokens.shape[1] - 1)
    if axis_size(mesh, DATA_AXIS) > 1:
        start, rows = local_slice(tokens.shape[0], mesh, DATA_AXIS, "batch")
        tokens = tokens[start:start + rows]
        params = _tree_copy_to(params, mesh, DATA_AXIS)
    logits = forward(params, tokens[:, :-1], cfg, remat=remat, mesh=mesh)
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1),
        reduction="sum")
    return reduce_from(nll, mesh, DATA_AXIS) / n_all


def train_step(params: Params, tokens, cfg: LlamaConfig, lr: float = 1e-3,
               remat: bool = False, optimizer=None, mesh=None):
    """One training step -> (params, loss).

    Unlike the pure JAX version this updates the weight tensors IN PLACE
    (under torch.no_grad()) and returns the same dict: without an optimizer
    by plain SGD, p - lr * g in p's dtype (the JAX default); with a
    torch.optim.Optimizer built over param_tensors(params) (the counterpart
    of an optax transformation, its state held by the optimizer object) by
    optimizer.step(). The weights become leaf tensors that require grad;
    on return each holds this step's gradient in .grad (cleared at the
    start of the next step). Raises on int8 (QWeight) params. mesh: as
    loss_fn; each rank updates its own shard."""
    _refuse_qweights(params, "train_step")
    leaves = param_tensors(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    tokens = torch.as_tensor(tokens, device=leaves[0].device).long()
    loss = loss_fn(params, tokens, cfg, remat=remat, mesh=mesh)
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
                    device="cuda", mesh=None) -> StackedKVCache:
    """One StackedKVCache covering every layer (shared block table and
    lengths; merged page pool); with a "model" axis, the rank's kv heads
    (the axis must divide n_kv_heads)."""
    _check_heads(cfg, mesh)
    return create_stacked_cache(
        n_layers=cfg.n_layers, num_pages=num_pages, page_size=page_size,
        num_kv_heads=cfg.n_kv_heads // axis_size(mesh, MODEL_AXIS),
        head_dim=cfg.head_dim,
        max_seqs=max_seqs, pages_per_seq=pages_per_seq, dtype=cfg.dtype,
        quant_dtype=quant_dtype, device=resolve_device(device),
    )


def _merge_deferred(o_c, lse_c, q, kq, ks_new, vq, vs_new, cfg: LlamaConfig):
    """Exact LSE merge of the query's OWN K/V row into the paged-cache
    attention result (the row is appended after the layer loop).

    Numerics mirror the kernel's treatment had the row been stored: the
    payload contracts in bf16 when quantized, the per-row scale applies
    AFTER the contraction, the softcap on the scaled logit, fp32 softmax
    algebra.

    o_c: [n, span, heads, d] normalized cache output; lse_c: [n, span,
    heads] natural-log LSE (-inf for an empty cache row); q: [n, span,
    heads, d]; kq/vq: [hkv, n * span, d] payload rows (row n_i * span +
    si); ks/vs: [hkv, n * span] fp32 or None. Span row i sees the span's
    rows j <= i (intra-span causal mask). Returns [n, span, heads, d] in
    o_c's dtype.
    """
    n, span, heads, d = q.shape
    hkv = kq.shape[0]
    group = heads // hkv
    kr = kq.reshape(hkv, n, span, d).permute(1, 2, 0, 3)  # [n, span, hkv, d]
    vr = vq.reshape(hkv, n, span, d).permute(1, 2, 0, 3)
    quantized = ks_new is not None
    qg = q.reshape(n, span, hkv, group, d)
    if quantized:  # int8/int4/fp8 -> bf16 is exact; q rounds to bf16 as in the kernel
        qg, kr_c = qg.to(torch.bfloat16), kr.to(torch.bfloat16)
    else:
        kr_c = kr
    s = torch.einsum("nihgd,njhd->nhgij", qg.float(), kr_c.float())
    if quantized:
        s = s * ks_new.reshape(hkv, n, span).permute(1, 0, 2)[:, :, None, None, :]
        vd = vr.float() * vs_new.reshape(hkv, n, span).permute(1, 2, 0)[..., None]
    else:
        vd = vr.float()
    cap = _softcap(cfg)
    if cap:
        s = torch.tanh(s * (cfg.attn_scale / cap)) * cap
    else:
        s = s * cfg.attn_scale
    if span > 1:
        tri = torch.ones(span, span, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~tri, float("-inf"))
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
    kq_all/vq_all: [L, hkv, R, d] payload rows (fp8 as uint8 bits, int4
    unpacked); ks/vs: [L, hkv, R] or None;
    page_ids/offs: [R] LOGICAL page + row offset (layer l adds
    l * num_pages)."""
    L, hkv, R, d = kq_all.shape
    dev = kq_all.device
    lids = (page_ids.long()[None, :]
            + torch.arange(L, device=dev)[:, None] * cache.num_pages
            ).reshape(-1)
    loffs = offs.long().repeat(L)
    scatter_span_rows(cache.k_pages, lids, loffs,
                      kq_all.transpose(0, 1).reshape(hkv, L * R, d),
                      cache.quant_dtype)
    scatter_span_rows(cache.v_pages, lids, loffs,
                      vq_all.transpose(0, 1).reshape(hkv, L * R, d),
                      cache.quant_dtype)
    if ks_all is not None:
        cache.k_scales[:, lids, loffs] = ks_all.transpose(0, 1).reshape(hkv, L * R)
        cache.v_scales[:, lids, loffs] = vs_all.transpose(0, 1).reshape(hkv, L * R)


def prefill_batch(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                  pages_list, token_lists, vision=None, pixel_lists=None,
                  mesh=None):
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
    Decode afterwards is plain causal. mesh: the rank's params and cache
    shards (every rank passes the same prompts).
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
                    dev_t(np.asarray(lens, np.int32)), embeds, block_ids, mesh)


def _prefill(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
             table_rows, page_ids, tokens, true_lens, input_embeds=None,
             image_block_ids=None, mesh=None):
    n, s = tokens.shape
    hd, hkv = cfg.head_dim, cache.k_pages.shape[0]
    page = cache.page_size
    npg = page_ids.shape[1]
    x = (input_embeds if input_embeds is not None
         else _embed(params, tokens, cfg))  # [n, s, d]
    positions = torch.arange(s, device=x.device)[None]
    store = cache.k_pages.dtype
    ys = []
    for lp, (wl, rope) in zip(params["layers"], _layer_ropes(cfg, positions)):
        h = _rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(h, lp, cfg, n, s, mesh=mesh)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        # page payload [n, s, hkv, d] -> [hkv, n*npg, page, d]; appended
        # for all layers by one scatter after the loop, as in JAX
        kq, ks_new = payload_rows(cache.quant_dtype, store,
                                  k.permute(2, 0, 1, 3))
        vq, vs_new = payload_rows(cache.quant_dtype, store,
                                  v.permute(2, 0, 1, 3))
        kq = pack_pages_payload(cache.quant_dtype, kq, n * npg, page)
        vq = pack_pages_payload(cache.quant_dtype, vq, n * npg, page)
        if image_block_ids is not None:
            attn = _attention_blockmask(q, k, v, cfg, wl, image_block_ids)
        else:
            attn = prefill_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, softmax_scale=cfg.attn_scale,
                window_size=(wl, -1), logit_softcap=_softcap(cfg),
                sink_tokens=cfg.attn_sinks).transpose(1, 2)
        x = _attn_residual(x, attn.reshape(n, s, -1), lp, cfg, mesh)
        x = _mlp(x, lp, cfg, mesh=mesh)
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

    write_pages(cache.k_pages, lids, flat(0))
    write_pages(cache.v_pages, lids, flat(2))
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
                        chunk: int, mesh=None):
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
                          dev_t(finals), dev_t(final_lens), mesh)


def _prefill_chunk(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                   table_rows, tokens, offsets, final_mask, final_lens,
                   mesh=None):
    """One chunk for each of n prompts (mfa_tpu's _prefill_chunk_jit).

    WRITE-THEN-ATTEND, as in the JAX package: each layer first writes the
    chunk's (quantized) K/V rows into its pages, then the paged prefill
    kernel reads the prefix and the chunk back through the block table
    with kv_len = min(final_lens, offsets + chunk) and q_start = offsets,
    so the chunk attends to its own rows after quantization. Padded chunk
    rows past the table width write into the null page 0."""
    n, chunk = tokens.shape
    hd, hkv = cfg.head_dim, cache.k_pages.shape[0]
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
        q, k, v = _qkv(h, lp, cfg, n, chunk, mesh=mesh)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        ids_l = page_ids + li * P
        kq, ks_new = payload_rows(cache.quant_dtype, store,
                                  k.permute(2, 0, 1, 3).reshape(hkv, -1, hd))
        vq, vs_new = payload_rows(cache.quant_dtype, store,
                                  v.permute(2, 0, 1, 3).reshape(hkv, -1, hd))
        write_pages(cache.k_pages, ids_l, pack_pages_payload(
            cache.quant_dtype, kq, n * chunk_pages, page))
        write_pages(cache.v_pages, ids_l, pack_pages_payload(
            cache.quant_dtype, vq, n * chunk_pages, page))
        if ks_new is not None:
            cache.k_scales[:, ids_l] = ks_new.reshape(hkv, n * chunk_pages, page)
            cache.v_scales[:, ids_l] = vs_new.reshape(hkv, n * chunk_pages, page)
        attn = paged_prefill_attention(
            q.to(cfg.dtype), cache.k_pages, cache.v_pages, kv_len, offsets,
            table_rows + li * P, k_scales=cache.k_scales,
            v_scales=cache.v_scales, softmax_scale=cfg.attn_scale,
            causal=True, window_left=wl, logit_softcap=_softcap(cfg),
            quant_dtype=cache.quant_dtype, sink_tokens=cfg.attn_sinks)
        x = _attn_residual(x, attn.reshape(n, chunk, -1), lp, cfg, mesh)
        x = _mlp(x, lp, cfg, mesh=mesh)
    x = _rms_norm(x, params["final_norm"], cfg)
    last_idx = torch.clamp(final_lens - 1 - offsets, 0, chunk - 1)
    logits = _unembed(params, x[torch.arange(n, device=dev), last_idx], cfg)
    cache.lengths[seq_slots] = torch.where(
        final_mask, final_lens, cache.lengths[seq_slots].long()
    ).to(cache.lengths.dtype)
    cache.block_tables[seq_slots] = table_rows
    return cache, logits


def prefill_step(params, cfg: LlamaConfig, cache: StackedKVCache,
                 seq_slot: int, pages, tokens_1d, mesh=None):
    """One prompt through the model into slot seq_slot (mfa_tpu's
    prefill_step): prefill_batch of one request. Returns (cache, logits
    [vocab] at its last position)."""
    cache, logits = prefill_batch(params, cfg, cache, [seq_slot], [list(pages)],
                                  [tokens_1d], mesh=mesh)
    return cache, logits[0]


def prefill_chunk(params, cfg: LlamaConfig, cache: StackedKVCache,
                  seq_slot: int, pages, tokens_1d, offset: int,
                  total_len: int, mesh=None):
    """Single-request convenience over prefill_chunk_batch: prefill this
    chunk (tokens_1d, starting at absolute page-aligned `offset`) into slot
    seq_slot. Returns (cache, logits [vocab] on the final chunk, else
    None)."""
    tokens_1d = np.asarray(tokens_1d, np.int64)
    n_tok = int(tokens_1d.shape[0])
    chunk = -(-n_tok // cache.page_size) * cache.page_size
    cache, logits = prefill_chunk_batch(
        params, cfg, cache, [seq_slot], [list(pages)], [tokens_1d], [offset],
        [total_len], chunk, mesh)
    return cache, (logits[0] if offset + n_tok >= total_len else None)


def decode_step(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                tokens, mesh=None):
    """One decode step for the active batch (DEFERRED-APPEND design): the
    verify_step of a span of one token.

    seq_slots: [n] cache rows; tokens: [n] current tokens. Returns (cache,
    logits [n, vocab] fp32); the cache is updated IN PLACE. On return the
    consumed token's K/V is in the cache and lengths include it (engine
    invariant lengths == prompt + generated[:-1]).

    With seq_slots and tokens already on the cache's device the step makes
    no host-to-device copy and reads nothing back, so it can be captured
    into a CUDA graph (serve/graphs.py) once an eager step has loaded the
    kernels and the RoPE tables.
    """
    tokens = _device_ids(tokens, cache.lengths.device)
    cache, logits = verify_step(params, cfg, cache, seq_slots, tokens[:, None],
                                mesh)
    return cache, logits[:, 0]


def verify_step(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                tokens, mesh=None):
    """Score `span` tokens per sequence in ONE forward (speculative
    verification), DEFERRED-APPEND as decode_step.

    tokens: [n, span], appended to each sequence in order. Returns (cache,
    logits [n, span, vocab] fp32): logits[:, i] is the next-token
    distribution after tokens[:, :i + 1]. Kernel 6 reads the STORED cache
    once with q [n, span, hq, d] and pos_offset=span; the span's own rows
    merge by exact LSE under the intra-span causal mask, and one scatter
    after the layer loop appends every layer's span rows; lengths += span.
    Pages for the span's positions must be mapped; a row past its table (a
    finished request's spare burst positions) writes into its own last
    page, whose slot is released next. Every index stays on the device, so
    the step can be captured (serve/graphs.py). Rolling rejected tokens
    back is a lengths reset (rollback). mesh: the rank's params and cache
    shards; kernel 6 reads the rank's kv heads, and the projections'
    all-reduces (NCCL, or none on a one-rank gloo axis) are capturable."""
    dev = cache.lengths.device
    slots, tokens = _device_ids(seq_slots, dev), _device_ids(tokens, dev)
    n, span = tokens.shape
    hd, hkv = cfg.head_dim, cache.k_pages.shape[0]
    page = cache.page_size
    lens = cache.lengths[slots]  # [n] int32
    pos = lens.long()[:, None] + torch.arange(span, device=dev)[None]  # [n, span]
    write_pages = cache.block_tables[
        slots[:, None], (pos // page).clamp(max=cache.pages_per_seq - 1)
    ].reshape(-1)  # [n * span]
    offs = (pos % page).reshape(-1)
    tables = cache.block_tables[slots]
    x = _embed(params, tokens, cfg)  # [n, span, d]
    store = cache.k_pages.dtype
    plan = _layer_ropes(cfg, pos)
    ys = []
    for li, lp in enumerate(params["layers"]):
        wl, rope = plan[li]
        h = _rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(h, lp, cfg, n, span, mesh=mesh)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        kq, ks_new = payload_rows(cache.quant_dtype, store,
                                  k.permute(2, 0, 1, 3).reshape(hkv, n * span, hd))
        vq, vs_new = payload_rows(cache.quant_dtype, store,
                                  v.permute(2, 0, 1, 3).reshape(hkv, n * span, hd))
        o_c, lse_c = paged_attention(
            q.to(cfg.dtype), cache.k_pages, cache.v_pages, lens,
            tables + li * cache.num_pages, k_scales=cache.k_scales,
            v_scales=cache.v_scales, softmax_scale=cfg.attn_scale,
            window_left=wl, logit_softcap=_softcap(cfg),
            quant_dtype=cache.quant_dtype, sink_tokens=cfg.attn_sinks,
            pos_offset=span, return_lse=True,
        )  # [n, span, heads, hd], [n, span, heads]
        attn = _merge_deferred(o_c, lse_c, q, kq, ks_new, vq, vs_new, cfg)
        x = _attn_residual(x, attn.reshape(n, span, -1), lp, cfg, mesh)
        # graphed steps: the dense MoE form, whatever n * span (no host read)
        x = _mlp(x, lp, cfg, dense_moe=True, mesh=mesh)
        ys.append((as_bytes(kq), ks_new, as_bytes(vq), vs_new))
    kq_all, vq_all = (torch.stack([y[i] for y in ys]) for i in (0, 2))
    ks_all = vs_all = None
    if cache.k_scales is not None:
        ks_all, vs_all = (torch.stack([y[i] for y in ys]) for i in (1, 3))
    _append_all_layers(cache, kq_all, ks_all, vq_all, vs_all, write_pages, offs)
    x = _rms_norm(x, params["final_norm"], cfg)
    logits = _unembed(params, x, cfg)  # [n, span, vocab]
    cache.lengths[slots] = lens + span
    return cache, logits


def rollback(cache: StackedKVCache, seq_slots, new_lengths) -> StackedKVCache:
    """Reset sequence lengths IN PLACE after a speculative rejection (page
    rows past a length are dead; later appends overwrite them)."""
    dev = cache.lengths.device
    slots = _device_ids(seq_slots, dev)
    cache.lengths[slots] = _device_ids(new_lengths, dev).to(cache.lengths.dtype)
    return cache


def _device_ids(ids, dev) -> torch.Tensor:
    """Token or slot ids as int64 on `dev`: a tensor already there is used
    as it is, host values are copied without a stream wait."""
    if isinstance(ids, torch.Tensor) and ids.device == dev:
        return ids.long()
    return host_to_device(np.asarray(ids), torch.long, dev)


def greedy_step(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                tokens, sampling: Optional[SamplingParams] = None, noise=None,
                presence=None, sampling_vecs=None, mesh=None):
    """decode_step, its draw and the draw's logprob: one step of
    decode_burst, and what a decode graph of the serving engine holds
    (serve/graphs.py). Returns (logits [n, vocab] fp32, ids [n] int64,
    logprobs [n] fp32 under the unfiltered model); the cache is updated IN
    PLACE.

    With no sampling arguments the draw is the argmax. sampling: the
    engine's SamplingParams (static); sampling_vecs: [4, n] fp32 per-row
    (temperature, top_p, min_p, repetition_penalty), run through
    sample_dynamic with sampling.top_k; presence: [n, vocab] bool context
    rows for the repetition penalty, marked IN PLACE with the draw; noise:
    [n, vocab] fp32 uniforms (serve/sampling.py:uniform_noise), which
    stochastic params and sampling_vecs need."""
    _, logits = decode_step(params, cfg, cache, seq_slots, tokens, mesh)
    gumbel = None if noise is None else gumbel_from_uniform(noise)
    if sampling_vecs is not None:
        top_k = sampling.top_k if sampling is not None else 0
        ids = sample_dynamic(logits, gumbel, *sampling_vecs, top_k=top_k,
                             presence=presence)
    else:
        ids = sample(logits, sampling, presence, gumbel)
    if presence is not None:  # a scalar scatter: legal inside a capture
        presence.scatter_(1, ids[:, None], True)
    return logits, ids, token_logprobs(logits, ids)


def needs_noise(sampling: Optional[SamplingParams], sampling_vecs) -> bool:
    """Whether a decode step with these arguments draws random noise."""
    return sampling_vecs is not None or (sampling is not None
                                         and not sampling.greedy)


def decode_burst(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                 tokens, n_steps: int, sampling: Optional[SamplingParams] = None,
                 generator: Optional[torch.Generator] = None, presence=None,
                 sampling_vecs=None, return_logits: bool = False, mesh=None):
    """n_steps decode steps, each step's draw fed to the next on the device
    (mfa_tpu's decode_burst). Pages for all n_steps positions must already
    be mapped. Returns (cache, tokens [n_steps, n] int64, logprobs [n_steps,
    n] fp32), and with return_logits the logits [n_steps, n, vocab] too, on
    the cache's device; the cache is updated IN PLACE.

    sampling / sampling_vecs / presence as greedy_step (presence is marked
    in place, so after the burst it holds the burst-final rows, which a
    pipelined caller chains into the next burst). Stochastic sampling draws
    one uniform_noise((n, vocab)) from `generator` before each step. A
    plain loop of greedy_step: the serving engine replays the same step
    from CUDA graphs on the card."""
    dev = cache.lengths.device
    slots, toks = _device_ids(seq_slots, dev), _device_ids(tokens, dev)
    noisy = needs_noise(sampling, sampling_vecs)
    if sampling_vecs is not None and not isinstance(sampling_vecs, torch.Tensor):
        sampling_vecs = host_to_device(np.asarray(sampling_vecs, np.float32),
                                       torch.float32, dev)
    out, lps, logits_all = [], [], []
    for _ in range(n_steps):
        noise = (uniform_noise((toks.shape[0], cfg.vocab_size), generator, dev)
                 if noisy else None)
        logits, toks, lp = greedy_step(params, cfg, cache, slots, toks,
                                       sampling, noise, presence, sampling_vecs,
                                       mesh)
        out.append(toks)
        lps.append(lp)
        if return_logits:
            logits_all.append(logits)
    res = (cache, torch.stack(out), torch.stack(lps))
    return res + (torch.stack(logits_all),) if return_logits else res


def speculative_iteration(params, draft_params, cfg: LlamaConfig,
                          draft_cfg: LlamaConfig, cache: StackedKVCache,
                          draft_cache: StackedKVCache, slots, tokens, k: int,
                          mesh=None):
    """One GREEDY speculative iteration on the device: the draft proposes k
    tokens (k greedy decode steps on its cache), the target scores [t, d_1
    .. d_{k-1}] in one verify_step, the longest prefix where the draft
    equals the target's argmax is accepted, and both caches' lengths are
    set to base + n_emit. slots, tokens: [n] int64 on the device (tokens:
    the last emitted token, its KV not stored). Returns (t_out [n, k]
    emitted tokens, lps [n, k] their target logprobs, n_emit [n] valid
    counts (entries past it are junk), m [n] accepted draft tokens,
    next [n] the last emitted token). Both caches need k positions mapped
    past each row's length. Capturable: serve/graphs.py replays it."""
    base = cache.lengths[slots]  # == total_len - 1
    d_toks, toks = [], tokens
    for _ in range(k):
        _, toks, _ = greedy_step(draft_params, draft_cfg, draft_cache, slots,
                                 toks, mesh=mesh)
        d_toks.append(toks)
    d = torch.stack(d_toks, 1)  # [n, k] proposals d_1..d_k
    feed = torch.cat([tokens[:, None], d[:, :-1]], dim=1)
    _, logits = verify_step(params, cfg, cache, slots, feed, mesh)  # [n, k, vocab]
    a = torch.argmax(logits, dim=-1)  # [n, k]
    m = torch.cumprod((d == a).long(), dim=1).sum(dim=1)
    n_emit = torch.where(m < k, m + 1, torch.full_like(m, k))
    pos = torch.arange(k, device=m.device)[None]
    # the accepted draft prefix, then the target's token at index m
    t_out = torch.where(pos < m[:, None], d, a)
    lps = token_logprobs(logits, t_out)
    new_lens = (base.long() + n_emit).to(cache.lengths.dtype)
    cache.lengths[slots] = new_lens
    draft_cache.lengths[slots] = new_lens
    nxt = torch.gather(t_out, 1, (n_emit - 1)[:, None])[:, 0]
    return t_out, lps, n_emit, m, nxt


def speculative_burst(params, draft_params, cfg: LlamaConfig,
                      draft_cfg: LlamaConfig, cache: StackedKVCache,
                      draft_cache: StackedKVCache, seq_slots, tokens, k: int,
                      n_iters: int, mesh=None):
    """n_iters greedy speculative iterations (speculative_iteration), each
    fed the last emitted token of the one before, with no host work in
    between (mfa_tpu's speculative_burst). Both caches need n_iters * k
    positions mapped past each row's length. Returns (t_out [n_iters, n, k],
    lps [n_iters, n, k], n_emit [n_iters, n], m [n_iters, n]) on the
    device; output is the target's greedy decode, token for token."""
    dev = cache.lengths.device
    slots, toks = _device_ids(seq_slots, dev), _device_ids(tokens, dev)
    outs = []
    for _ in range(n_iters):
        *res, toks = speculative_iteration(params, draft_params, cfg, draft_cfg,
                                           cache, draft_cache, slots, toks, k,
                                           mesh)
        outs.append(res)
    return tuple(torch.stack(x) for x in zip(*outs))
