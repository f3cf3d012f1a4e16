"""HuggingFace checkpoint -> this port's params (counterpart of mfa_tpu/models/convert.py).

`from_hf` maps a transformers causal LM of the Llama family (Llama,
Mistral, Qwen2, Qwen3, Gemma, Gemma2, Gemma3's text stack, and the MoE
families Mixtral, Qwen3-MoE, Qwen2-MoE and Qwen-MoE with dense layers mixed
in), its state dict, or a `LazyStateDict` (models/safetensors_io.py) onto
the port's params and LlamaConfig, so real checkpoints serve through the
engine; `from_safetensors` loads an on-disk HF snapshot tensor by tensor,
and `gemma3_multimodal_from_hf` adds the SigLIP tower and the projector
(models/vision.py). transformers is never imported: a model is read
through its `state_dict()` and `config`, and configs are duck-typed
(`types.SimpleNamespace` of a config.json works).

Weight layout notes (as in the JAX package):
- HF Linear weights are [out, in]; the port uses [in, out] -> transpose
  (one contiguous copy on the target device).
- HF attention projections are per-model-dim; head ordering matches the
  kv-head-major GQA fold, so no permutation is needed.
- RoPE: both use the rotate-half (NeoX) convention with theta from config.
- Tied embeddings: lm_head is the transposed view of the embedding table
  (no copy: the two share storage).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import types
from typing import Tuple

import numpy as np
import torch

from mfa_tpu_torch.dispatch.config import resolve_device
from mfa_tpu_torch.models.llama import LlamaConfig, Params
from mfa_tpu_torch.models.safetensors_io import read_safetensors
from mfa_tpu_torch.models.vision import SiglipVisionConfig
from mfa_tpu_torch.models.wquant import quantize_weight, stack_bank


def _tensor(x) -> torch.Tensor:
    """A state-dict entry (torch tensor, numpy array) as a CPU-or-device
    torch tensor in its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # a numpy extension dtype torch cannot wrap
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _min_period(flags: tuple) -> tuple:
    """Smallest repeating period of a boolean per-layer pattern."""
    n = len(flags)
    for p in range(1, n + 1):
        if n % p == 0 and flags == flags[:p] * (n // p):
            return flags[:p]
    return flags


def _rope_scaling(hf_config) -> tuple:
    """-> (rope_scale, rope_scaling) of the config's rope_scaling: linear
    position interpolation (Gemma3's global layers ship factor 8), the
    Llama-3.1+ "llama3" band interpolation and YaRN (Qwen long context);
    any other type is refused rather than silently dropped."""
    rs = getattr(hf_config, "rope_scaling", None)
    if not rs:
        return 1.0, None
    rs = dict(rs)
    rtype = rs.get("rope_type", rs.get("type", "default"))
    if rtype == "linear":
        return float(rs.get("factor", 1.0)), None
    if rtype == "llama3":
        return 1.0, ("llama3", float(rs["factor"]), float(rs["low_freq_factor"]),
                     float(rs["high_freq_factor"]),
                     int(rs["original_max_position_embeddings"]))
    if rtype == "yarn":
        if not rs.get("truncate", True):
            raise NotImplementedError("yarn rope_scaling with truncate=False")
        factor = float(rs["factor"])
        attn_factor = rs.get("attention_factor")
        if attn_factor is None:
            # transformers' default yarn mscale: 0.1 * ln(f) + 1
            mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")

            def get_mscale(scale, m=1.0):
                return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0

            if mscale and mscale_all:
                attn_factor = (get_mscale(factor, float(mscale))
                               / get_mscale(factor, float(mscale_all)))
            else:
                attn_factor = get_mscale(factor)
        orig = (rs.get("original_max_position_embeddings")
                or getattr(hf_config, "max_position_embeddings", 4096))
        return 1.0, ("yarn", factor, float(attn_factor),
                     float(rs.get("beta_fast", 32) or 32),
                     float(rs.get("beta_slow", 1) or 1), int(orig))
    if rtype not in ("default", None):
        raise NotImplementedError(f"rope_scaling type {rtype!r} is not supported")
    return 1.0, None


def _moe_fields(hf_config) -> dict:
    """The MoE fields of the config (Mixtral: num_local_experts; Qwen-MoE:
    num_experts, with decoder_sparse_step / mlp_only_layers giving the
    dense/sparse interleave, layer i sparse iff it is not in
    mlp_only_layers and (i + 1) % step == 0, as transformers builds
    Qwen2MoeDecoderLayer)."""
    n_experts = (getattr(hf_config, "num_local_experts", 0)
                 or getattr(hf_config, "num_experts", 0) or 0)
    pattern = None
    if n_experts:
        step = getattr(hf_config, "decoder_sparse_step", 1) or 1
        only = set(getattr(hf_config, "mlp_only_layers", None) or ())
        pat = tuple((i not in only) and ((i + 1) % step == 0)
                    for i in range(hf_config.num_hidden_layers))
        if not any(pat):
            raise NotImplementedError(
                "MoE config whose every layer is dense "
                "(decoder_sparse_step/mlp_only_layers disable all experts)")
        if not all(pat):
            pattern = pat
    return dict(
        n_experts=n_experts,
        n_active_experts=getattr(hf_config, "num_experts_per_tok", 2) or 2,
        moe_ffn_dim=getattr(hf_config, "moe_intermediate_size", None),
        norm_topk=bool(getattr(hf_config, "norm_topk_prob", True)),
        shared_expert_dim=getattr(hf_config, "shared_expert_intermediate_size",
                                  None),
        shared_expert_gate=getattr(hf_config, "model_type", "") == "qwen2_moe",
        moe_layer_pattern=pattern)


def config_from_hf(hf_config) -> LlamaConfig:
    """The LlamaConfig of a transformers config (or a namespace with its
    config.json fields), as mfa_tpu's config_from_hf derives it."""
    model_type = getattr(hf_config, "model_type", "llama")
    heads = hf_config.num_attention_heads
    hd = getattr(hf_config, "head_dim", None)
    act = (getattr(hf_config, "hidden_activation", None)
           or getattr(hf_config, "hidden_act", "silu"))
    is_gemma = str(model_type).startswith("gemma")
    is_gemma3 = model_type in ("gemma3", "gemma3_text")
    # Qwen2 configs carry sliding_window but gate it behind
    # use_sliding_window (default off).
    sliding_window = getattr(hf_config, "sliding_window", None)
    if not getattr(hf_config, "use_sliding_window", True):
        sliding_window = None
    # Per-layer attention types (Gemma2 pairs, Gemma3 5-local + 1-global):
    # the smallest repeating sliding/global period.
    layer_types = getattr(hf_config, "layer_types", None)
    layer_pattern = None
    if layer_types and sliding_window:
        flags = tuple(t == "sliding_attention" for t in layer_types)
        if any(flags) and not all(flags):
            layer_pattern = _min_period(flags)
        elif not any(flags):
            sliding_window = None  # no sliding layers at all
    elif sliding_window and getattr(hf_config, "sliding_window_pattern", None):
        # older Gemma3 configs: every p-th layer is global
        per = int(hf_config.sliding_window_pattern)
        if per > 1:
            layer_pattern = (True,) * (per - 1) + (False,)
    rope_scale, rope_scaling = _rope_scaling(hf_config)
    qpas = getattr(hf_config, "query_pre_attn_scalar", None)
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", heads) or heads,
        ffn_dim=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=hf_config.rms_norm_eps,
        dtype=torch.bfloat16,
        sliding_window=sliding_window,
        head_dim_override=(hd if hd and hd != hf_config.hidden_size // heads
                           else None),
        # Qwen2 hardcodes q/k/v bias in its attention module; Qwen2-MoE
        # exposes it as `qkv_bias`, other families as `attention_bias`.
        qkv_bias=(model_type == "qwen2"
                  or bool(getattr(hf_config, "qkv_bias", False))
                  or bool(getattr(hf_config, "attention_bias", False))),
        hidden_act="gelu_tanh" if "gelu" in str(act) else "silu",
        norm_offset=is_gemma,
        embed_scale=is_gemma,
        logit_softcap=getattr(hf_config, "final_logit_softcapping", None),
        attn_softcap=getattr(hf_config, "attn_logit_softcapping", None),
        query_scale=float(qpas) ** -0.5 if qpas else None,
        post_norms=(model_type == "gemma2" or is_gemma3),
        qk_norm=(model_type in ("qwen3", "qwen3_moe") or is_gemma3),
        alt_window=(model_type == "gemma2"
                    and getattr(hf_config, "sliding_window", None) is not None),
        layer_pattern=layer_pattern,
        rope_theta_local=getattr(hf_config, "rope_local_base_freq", None),
        rope_scale=rope_scale,
        rope_scaling=rope_scaling,
        **_moe_fields(hf_config),
    )


def _source(model_or_state_dict, hf_config):
    """-> (state dict, hf config) of a transformers model or a state dict."""
    if hasattr(model_or_state_dict, "state_dict"):
        return (model_or_state_dict.state_dict(),
                hf_config or model_or_state_dict.config)
    if hf_config is None:
        raise ValueError("state_dict input requires hf_config")
    return model_or_state_dict, hf_config


def from_hf(model_or_state_dict, hf_config=None, dtype=torch.bfloat16,
            quantize: "str | None" = None,
            device="cuda") -> Tuple[Params, LlamaConfig]:
    """Convert a transformers causal LM (or its state dict + config, or a
    LazyStateDict + config) -> (params, cfg) for llama.forward and the
    serving Engine, the tensors on `device` (the card unless the caller
    asks for the CPU).

    quantize="int8": each projection is quantized per output channel
    (wquant.quantize_weight) AS IT IS READ, and each expert bank expert by
    expert, so with a LazyStateDict peak memory is one bf16 tensor plus the
    int8 tree. Norms, biases, the embedding and lm_head stay in full
    precision (as mfa_tpu's from_hf leaves them), and so do the MoE router
    (fp32) and Qwen2-MoE's [d, 1] shared-expert gate: mfa_tpu quantizes the
    latter and then fails on it in _moe (QWeight has no astype)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported weight quantization {quantize!r}")
    sd, hf_config = _source(model_or_state_dict, hf_config)
    cfg = dataclasses.replace(config_from_hf(hf_config), dtype=dtype)
    dev = resolve_device(device)

    def full(name, dt=dtype):
        return _tensor(sd[name]).to(device=dev, dtype=dt)

    def w(name, q=True):  # [out, in] -> [in, out]
        t = full(name).t().contiguous()
        return quantize_weight(t, axis=-2) if quantize and q else t

    def bank(names):  # experts' [out, in] -> [E, in, out], quantized as read
        return stack_bank((w(n, q=False) for n in names), len(names),
                          bool(quantize))

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        lp = dict(
            wq=w(p + "self_attn.q_proj.weight"),
            wk=w(p + "self_attn.k_proj.weight"),
            wv=w(p + "self_attn.v_proj.weight"),
            wo=w(p + "self_attn.o_proj.weight"),
            attn_norm=full(p + "input_layernorm.weight", torch.float32),
        )
        if not cfg.is_moe_layer(i):
            lp.update(w_gate=w(p + "mlp.gate_proj.weight"),
                      w_up=w(p + "mlp.up_proj.weight"),
                      w_down=w(p + "mlp.down_proj.weight"))
        elif p + "block_sparse_moe.gate.weight" in sd:
            # Mixtral: block_sparse_moe.gate + experts.N.{w1, w3, w2}
            ep = p + "block_sparse_moe.experts."
            lp.update(
                w_router=full(p + "block_sparse_moe.gate.weight",
                              torch.float32).t().contiguous(),
                **{key: bank([f"{ep}{e}.{hf}.weight"
                              for e in range(cfg.n_experts)])
                   for key, hf in (("we_gate", "w1"), ("we_up", "w3"),
                                   ("we_down", "w2"))})
        else:
            # Qwen-MoE: mlp.gate + mlp.experts.N.{gate, up, down}_proj
            ep = p + "mlp.experts."
            lp.update(
                w_router=full(p + "mlp.gate.weight", torch.float32).t().contiguous(),
                **{key: bank([f"{ep}{e}.{hf}_proj.weight"
                              for e in range(cfg.n_experts)])
                   for key, hf in (("we_gate", "gate"), ("we_up", "up"),
                                   ("we_down", "down"))})
        if cfg.is_moe_layer(i) and cfg.shared_expert_dim:
            # Qwen2-MoE: the shared expert and its sigmoid gate ([d, 1])
            sp = p + "mlp.shared_expert."
            lp.update(ws_gate=w(sp + "gate_proj.weight"),
                      ws_up=w(sp + "up_proj.weight"),
                      ws_down=w(sp + "down_proj.weight"))
            if cfg.shared_expert_gate:
                lp["w_shared_gate"] = w(p + "mlp.shared_expert_gate.weight",
                                        q=False)
        if cfg.qk_norm:
            lp.update(q_norm=full(p + "self_attn.q_norm.weight", torch.float32),
                      k_norm=full(p + "self_attn.k_norm.weight", torch.float32))
        if cfg.qkv_bias:
            lp.update(bq=full(p + "self_attn.q_proj.bias"),
                      bk=full(p + "self_attn.k_proj.bias"),
                      bv=full(p + "self_attn.v_proj.bias"))
        if cfg.post_norms:
            # Gemma2/3: post_attention_layernorm normalizes the attention
            # OUTPUT; the MLP input norm is pre_feedforward_layernorm
            lp.update(
                post_attn_norm=full(p + "post_attention_layernorm.weight",
                                    torch.float32),
                mlp_norm=full(p + "pre_feedforward_layernorm.weight",
                              torch.float32),
                post_mlp_norm=full(p + "post_feedforward_layernorm.weight",
                                   torch.float32))
        else:
            lp["mlp_norm"] = full(p + "post_attention_layernorm.weight",
                                  torch.float32)
        layers.append(lp)

    embed = full("model.embed_tokens.weight")
    lm_head = (full("lm_head.weight").t().contiguous() if "lm_head.weight" in sd
               else embed.t())  # tied: a view, not a copy
    params: Params = dict(layers=layers, embed=embed,
                          final_norm=full("model.norm.weight", torch.float32),
                          lm_head=lm_head)
    return params, cfg


def dict_like_sd(sd):
    """HF safetensors checkpoints come in two name layouts ('model.layers...'
    and 'layers...'); a view with the state-dict names from_hf expects."""
    if any(k.startswith("model.") for k in sd):
        return sd

    class _View:
        def __init__(self, base):
            self._base = base

        def __getitem__(self, name):
            if name.startswith("model.") and name not in self._base:
                return self._base[name[len("model."):]]
            return self._base[name]

        def __contains__(self, name):
            return (name in self._base
                    or (name.startswith("model.")
                        and name[len("model."):] in self._base))

    return _View(sd)


def from_safetensors(path: str, hf_config=None, dtype=torch.bfloat16,
                     quantize: "str | None" = None,
                     device="cuda") -> Tuple[Params, LlamaConfig]:
    """Load an on-disk HF checkpoint: a snapshot directory (config.json +
    model*.safetensors [+ the shard index]) or one .safetensors file (then
    hf_config is required), tensor by tensor, with no transformers model in
    memory. hf_config defaults to the config.json beside the shards
    (multimodal wrappers: its text_config). quantize as from_hf. Text
    stacks only (Gemma3 multimodal: gemma3_multimodal_from_hf)."""
    sd = read_safetensors(path)
    if hf_config is None:
        cfg_path = os.path.join(path if os.path.isdir(path)
                                else os.path.dirname(path), "config.json")
        with open(cfg_path) as f:
            raw = json.load(f)
        hf_config = types.SimpleNamespace(**raw.get("text_config", raw))
    return from_hf(dict_like_sd(sd), hf_config, dtype=dtype, quantize=quantize,
                   device=device)


def gemma3_multimodal_from_hf(model_or_state_dict, hf_config=None,
                              dtype=torch.bfloat16, device="cuda"):
    """Convert a transformers Gemma3ForConditionalGeneration (text stack +
    SigLIP tower + multimodal projector) -> (params, cfg, vparams, vcfg,
    image_token_id) for models/vision.py and the Engine's vision=. The text
    stack goes through from_hf with the `model.language_model.` prefix
    taken back to the text-only layout; the tower maps onto
    init_vision_params' layout (layer norms and the projector norm in
    fp32, as mfa_tpu converts them)."""
    sd, hf = _source(model_or_state_dict, hf_config)
    # nested configs may arrive as plain dicts (config.to_dict() JSON)
    if isinstance(getattr(hf, "text_config", None), dict):
        hf = types.SimpleNamespace(**{**hf.__dict__})
        hf.text_config = types.SimpleNamespace(**hf.text_config)
        hf.vision_config = types.SimpleNamespace(**hf.vision_config)
    lm_pre = "model.language_model."
    text_sd = {"model." + k[len(lm_pre):]: v
               for k, v in sd.items() if k.startswith(lm_pre)}
    if "lm_head.weight" in sd:
        text_sd["lm_head.weight"] = sd["lm_head.weight"]
    params, cfg = from_hf(text_sd, hf.text_config, dtype=dtype, device=device)
    dev = resolve_device(device)

    vc = hf.vision_config
    vcfg = SiglipVisionConfig(
        hidden=vc.hidden_size, intermediate=vc.intermediate_size,
        n_layers=vc.num_hidden_layers, n_heads=vc.num_attention_heads,
        image_size=vc.image_size, patch_size=vc.patch_size,
        eps=vc.layer_norm_eps, mm_tokens_per_image=hf.mm_tokens_per_image)
    vt = "model.vision_tower.vision_model."

    def vb(name, dt=dtype):
        return _tensor(sd[name]).to(device=dev, dtype=dt)

    def vw(name):  # linear [out, in] -> [in, out]
        return vb(name).t().contiguous()

    layers = []
    for i in range(vcfg.n_layers):
        p = f"{vt}encoder.layers.{i}."
        layers.append(dict(
            ln1_w=vb(p + "layer_norm1.weight", torch.float32),
            ln1_b=vb(p + "layer_norm1.bias", torch.float32),
            wq=vw(p + "self_attn.q_proj.weight"), bq=vb(p + "self_attn.q_proj.bias"),
            wk=vw(p + "self_attn.k_proj.weight"), bk=vb(p + "self_attn.k_proj.bias"),
            wv=vw(p + "self_attn.v_proj.weight"), bv=vb(p + "self_attn.v_proj.bias"),
            wo=vw(p + "self_attn.out_proj.weight"),
            bo=vb(p + "self_attn.out_proj.bias"),
            ln2_w=vb(p + "layer_norm2.weight", torch.float32),
            ln2_b=vb(p + "layer_norm2.bias", torch.float32),
            fc1=vw(p + "mlp.fc1.weight"), fc1_b=vb(p + "mlp.fc1.bias"),
            fc2=vw(p + "mlp.fc2.weight"), fc2_b=vb(p + "mlp.fc2.bias"),
        ))
    # stride == kernel conv [h, 3, p, p] -> patchify matmul [3 * p * p, h]
    # (flatten order (c, ph, pw), as vision.siglip_encode reshapes)
    patch = vb(vt + "embeddings.patch_embedding.weight")
    vparams = dict(
        patch_w=patch.reshape(patch.shape[0], -1).t().contiguous(),
        patch_b=vb(vt + "embeddings.patch_embedding.bias"),
        pos=vb(vt + "embeddings.position_embedding.weight"),
        layers=layers,
        post_ln_w=vb(vt + "post_layernorm.weight", torch.float32),
        post_ln_b=vb(vt + "post_layernorm.bias", torch.float32),
        mm_norm=vb("model.multi_modal_projector.mm_soft_emb_norm.weight",
                   torch.float32),
        mm_proj=vb("model.multi_modal_projector.mm_input_projection_weight"),
    )
    image_token_id = int(getattr(hf, "image_token_id", None)
                         or hf.image_token_index)
    return params, cfg, vparams, vcfg, image_token_id
