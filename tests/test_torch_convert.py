"""The port's HF conversion (models/convert.py) against mfa_tpu's and against
transformers, for every family of tests/test_hf_convert.py: a tiny
randomly initialized transformers causal LM per family (seeded, no
network; biases randomized so that a dropped bias shows), then

- every family, dense and MoE (Mixtral, Qwen3-MoE, Qwen3-MoE with a dense
  layer, Qwen2-MoE): the port's config_from_hf equals mfa_tpu's on every
  field of the port's LlamaConfig; from_hf gives exactly
  params_from_numpy of mfa_tpu's from_hf (fp32); the port's forward
  matches transformers' logits within 2e-3 (test_hf_convert's tolerance);
  the port's Engine gives transformers' greedy generation and mfa_tpu's
  Engine's, token for token;
- an int8 Qwen2-MoE load keeps the router and the [d, 1] shared-expert
  gate in full precision (mfa_tpu quantizes the gate and then fails on it);
- Gemma3 multimodal: gemma3_multimodal_from_hf equals mfa_tpu's, tower
  and projector included.

transformers is used here only (pytest.importorskip); the port never
imports it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import convert as jconvert
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.models import convert, llama, vision
from mfa_tpu_torch.serve.engine import Engine
from mfa_tpu_torch.utils.checkpoint import _flatten
from tests.jax_maps import release_jax_code  # noqa: F401

COMMON = dict(vocab_size=96, hidden_size=64, intermediate_size=112,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=256, rope_theta=10000.0)
DENSE = ("llama", "llama31", "qwen2", "qwen2_yarn", "gemma", "qwen3", "gemma2",
         "gemma3")
MOE = ("mixtral", "qwen3_moe", "qwen3_moe_hetero", "qwen2_moe")
ENGINE_KW = dict(num_pages=32, page_size=8, max_seqs=2, pages_per_seq=8)


def _model(family):
    """The family's tiny transformers model (test_hf_convert's configs)."""
    tr = pytest.importorskip("transformers")
    common = dict(COMMON)
    moe = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
               decoder_sparse_step=1)
    if family == "llama":
        cfg, cls = tr.LlamaConfig(rms_norm_eps=1e-5, attention_bias=False,
                                  tie_word_embeddings=False, **common), tr.LlamaForCausalLM
    elif family == "llama31":
        cfg = tr.LlamaConfig(
            rms_norm_eps=1e-5, attention_bias=False, tie_word_embeddings=False,
            rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                          "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 32}, **common)
        cls = tr.LlamaForCausalLM
    elif family == "qwen2_yarn":
        cfg = tr.Qwen2Config(rms_norm_eps=1e-6, tie_word_embeddings=False,
                             rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                           "original_max_position_embeddings": 32},
                             **common)
        cls = tr.Qwen2ForCausalLM
    elif family == "qwen2":
        cfg, cls = tr.Qwen2Config(rms_norm_eps=1e-6, tie_word_embeddings=False,
                                  **common), tr.Qwen2ForCausalLM
    elif family == "gemma":
        cfg = tr.GemmaConfig(rms_norm_eps=1e-6, head_dim=32,
                             hidden_activation="gelu_pytorch_tanh",
                             tie_word_embeddings=True, **common)
        cls = tr.GemmaForCausalLM
    elif family == "qwen3":
        cfg, cls = tr.Qwen3Config(rms_norm_eps=1e-6, head_dim=32,
                                  tie_word_embeddings=False, **common), tr.Qwen3ForCausalLM
    elif family == "gemma2":
        common["num_hidden_layers"] = 4  # 2 sliding/global pairs
        cfg = tr.Gemma2Config(
            rms_norm_eps=1e-6, head_dim=32, hidden_activation="gelu_pytorch_tanh",
            tie_word_embeddings=True, sliding_window=8, attn_logit_softcapping=50.0,
            final_logit_softcapping=30.0, query_pre_attn_scalar=16, **common)
        cls = tr.Gemma2ForCausalLM
    elif family == "gemma3":
        common["num_hidden_layers"] = 6  # one 5-sliding + 1-global period
        cfg = tr.Gemma3TextConfig(
            rms_norm_eps=1e-6, head_dim=32, sliding_window=8, query_pre_attn_scalar=16,
            rope_local_base_freq=10000.0,
            rope_scaling={"rope_type": "linear", "factor": 8.0},
            hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True, **common)
        cfg.rope_theta = 1000000.0
        cls = tr.Gemma3ForCausalLM
    elif family == "mixtral":
        cfg = tr.MixtralConfig(rms_norm_eps=1e-5, tie_word_embeddings=False,
                               num_local_experts=4, num_experts_per_tok=2,
                               sliding_window=None, **common)
        cls = tr.MixtralForCausalLM
    elif family in ("qwen3_moe", "qwen3_moe_hetero"):
        cfg = tr.Qwen3MoeConfig(
            rms_norm_eps=1e-6, head_dim=32, tie_word_embeddings=False,
            mlp_only_layers=[0] if family.endswith("hetero") else [], **moe, **common)
        cls = tr.Qwen3MoeForCausalLM
    else:
        cfg = tr.Qwen2MoeConfig(
            rms_norm_eps=1e-6, tie_word_embeddings=False,
            shared_expert_intermediate_size=80, norm_topk_prob=False,
            mlp_only_layers=[], **moe, **common)
        cls = tr.Qwen2MoeForCausalLM
    cfg._attn_implementation = "eager"  # sdpa has no softcap path
    torch.manual_seed(0)
    model = cls(cfg).eval()
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


@pytest.fixture(scope="module", params=DENSE + MOE)
def converted(request):
    model = _model(request.param)
    sd = model.state_dict()
    jparams, jcfg = jconvert.from_hf({k: v.float().numpy() for k, v in sd.items()},
                                     model.config, dtype=jnp.float32)
    params, cfg = convert.from_hf(model, dtype=torch.float32, device="cpu")
    return request.param, model, jparams, jcfg, params, cfg


def test_config_and_params_equal_mfa_tpu(converted):
    family, model, jparams, jcfg, params, cfg = converted
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            assert a == torch.float32 and b == jnp.float32
        else:
            assert a == b, (family, f.name, a, b)
    want = llama.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    got, ref = _flatten(params), _flatten(want)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), (family, path)
    if family == "qwen2":
        assert cfg.qkv_bias and cfg.n_heads // cfg.n_kv_heads == 2
        assert params["layers"][0]["bq"].abs().max() > 0
    if family == "gemma2":
        assert cfg.alt_window and cfg.sliding_pattern == (True, False)
        assert (cfg.attn_softcap, cfg.logit_softcap) == (50.0, 30.0)
    if family in ("gemma", "gemma2", "gemma3"):
        # a tied checkpoint on disk has no lm_head.weight: a view of the embedding
        sd = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
        tied, _ = convert.from_hf(sd, model.config, dtype=torch.float32, device="cpu")
        assert tied["lm_head"].data_ptr() == tied["embed"].data_ptr()
        assert torch.equal(tied["lm_head"], params["lm_head"])


def test_forward_matches_transformers(converted):
    family, model, _, _, params, cfg = converted
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 21))
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.float()
        got = llama.forward(params, torch.tensor(tokens), cfg)
    diff = float((got - want).abs().max())
    assert diff < 2e-3, f"{family} logits diverge from transformers: {diff}"


def test_engine_matches_transformers_and_mfa_tpu(converted):
    family, model, jparams, jcfg, params, cfg = converted
    prompt = [1, 2, 3, 4, 5]
    with torch.no_grad():
        hf = model.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False,
                            num_beams=1, pad_token_id=0)[0, 5:].tolist()
    jeng = JaxEngine(jparams, jcfg, **ENGINE_KW)
    jreq = jeng.submit(prompt, 6)
    jeng.run()
    eng = Engine(params, cfg, device="cpu", **ENGINE_KW)
    req = eng.submit(prompt, 6)
    eng.run()
    assert req.generated == hf == jreq.generated, (family, req.generated, hf,
                                                    jreq.generated)


def test_int8_qwen2_moe_keeps_router_and_shared_gate():
    """from_hf(quantize="int8") of a Qwen2-MoE checkpoint: projections and
    banks int8, the router fp32 and the [d, 1] shared-expert gate in the
    model dtype, so the model runs; mfa_tpu quantizes the gate and its _moe
    then calls .astype on a QWeight."""
    from mfa_tpu.models import llama as jl
    from mfa_tpu_torch.models.wquant import QWeight

    model = _model("qwen2_moe")
    params, cfg = convert.from_hf(model, dtype=torch.float32, quantize="int8",
                                  device="cpu")
    lp = params["layers"][0]
    assert isinstance(lp["we_gate"], QWeight) and lp["we_gate"].qw.ndim == 3
    assert isinstance(lp["ws_down"], QWeight)
    assert lp["w_router"].dtype == torch.float32
    assert lp["w_shared_gate"].dtype == torch.float32
    assert lp["w_shared_gate"].shape == (cfg.dim, 1)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 21))
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.float()
        got = llama.forward(params, torch.tensor(tokens), cfg)
    assert torch.isfinite(got).all() and float((got - want).abs().max()) < 0.1
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    jparams, jcfg = jconvert.from_hf(sd, model.config, dtype=jnp.float32, quantize="int8")
    with pytest.raises(AttributeError, match="astype"):
        jl.forward(jparams, jnp.asarray(tokens), jcfg)


def test_gemma3_multimodal_equals_mfa_tpu():
    tr = pytest.importorskip("transformers")
    vc = tr.SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=2, image_size=28, patch_size=7,
                               layer_norm_eps=1e-6)
    tc = tr.Gemma3TextConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=6,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32, rms_norm_eps=1e-6,
        sliding_window=8, query_pre_attn_scalar=16, rope_local_base_freq=10000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        hidden_activation="gelu_pytorch_tanh", max_position_embeddings=256,
        rope_theta=1000000.0, tie_word_embeddings=True)
    cfg = tr.Gemma3Config(text_config=tc, vision_config=vc, mm_tokens_per_image=4,
                          image_token_index=100, boi_token_index=98, eoi_token_index=99)
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = tr.Gemma3ForConditionalGeneration(cfg).eval()
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    jp, jc, jvp, jvc, jimg = jconvert.gemma3_multimodal_from_hf(sd, model.config,
                                                                dtype=jnp.float32)
    tp, tc_, tvp, tvc, timg = convert.gemma3_multimodal_from_hf(
        model, dtype=torch.float32, device="cpu")
    assert timg == jimg == 100
    assert dataclasses.asdict(tvc) == dataclasses.asdict(jvc)
    want = llama.params_from_numpy(jax.tree.map(np.asarray, jp), tc_, "cpu")
    for (path, a), (_, b) in zip(_flatten(tp), _flatten(want)):
        assert torch.equal(a, b), path
    wantv = vision.vision_params_from_numpy(jax.tree.map(np.asarray, jvp), tvc, "cpu")
    got, ref = _flatten(tvp), _flatten(wantv)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert torch.equal(a, b), path
