"""The dense family knobs of the port's LlamaConfig against mfa_tpu:

- every preset (mistral_7b, qwen2_7b, gemma_7b, qwen3_8b, gemma2_9b,
  mixtral_8x7b) equals mfa_tpu's field by field (llama3_8b too, but for its
  vocab, a difference kept on purpose), and Qwen2-7B and
  Gemma2-9B are what config_from_hf derives from their published
  config.json numbers;
- a tiny Qwen2 (q/k/v bias, 7 q heads a kv head) and a tiny Gemma2
  (attention and final-logit softcaps small enough to bite, alternating
  16-token windows, post norms, (1 + w) norms, gelu-tanh), from mfa_tpu's
  init perturbed with numpy noise: forward, prefill, decode and a verify
  span within 1e-3 of mfa_tpu's on fp32 KV pages, and within 1e-2 on
  int8 pages (one bf16 rounding: both round p to bf16 before P.V, mfa_tpu
  against each 8-row block's running max, the plain version against the
  row's final max), and the Engine with chunked prefill and
  the prefix cache (a chunked prompt, a whole-prompt one, then two
  prefix hits) token-identical to mfa_tpu's Engine;
- each softcap alone (the knobs the port used to refuse) as mfa_tpu
  computes it;
- two Gemma2 SGD train steps: loss and every weight within 1e-4 of
  mfa_tpu's train_step;
- kernel 8's plain version at q-per-kv groups 3, 5, 6 and 7 (groups that
  do not divide the kernel's 64 rows) against the Pallas kernel in
  interpret mode, fp32 and int8 pages, with a softcap and a window."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.paged_prefill import \
    paged_prefill_attention as jax_paged_prefill
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-3, rtol=1e-3)
KW = dict(num_pages=40, page_size=8, max_seqs=4, pages_per_seq=8)
FAMILIES = {
    # Qwen2: 7 q heads a kv head of 32 (dim 224 = 7 x 32), q/k/v bias
    "qwen2": dict(vocab_size=128, dim=224, n_layers=2, n_heads=7, n_kv_heads=1,
                  ffn_dim=128, rope_theta=1e6, norm_eps=1e-6, qkv_bias=True),
    # Gemma2: alternating windows of 16, caps small enough to change the output
    "gemma2": dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   ffn_dim=128, rope_theta=1e4, norm_eps=1e-6, head_dim_override=32,
                   hidden_act="gelu_tanh", norm_offset=True, embed_scale=True,
                   sliding_window=16, attn_softcap=2.0, logit_softcap=1.5,
                   query_scale=16.0 ** -0.5, post_norms=True, alt_window=True),
}
PRESETS = ("mistral_7b", "qwen2_7b", "gemma_7b", "qwen3_8b", "gemma2_9b", "llama3_8b",
           "mixtral_8x7b")


def _same_fields(got, want, skip=()):
    for f in dataclasses.fields(got):
        if f.name in skip:
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert a == torch.bfloat16 and b == jnp.bfloat16
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_mfa_tpu(name):
    got, want = getattr(tl.LlamaConfig, name)(), getattr(jl.LlamaConfig, name)()
    # llama3_8b: the published vocab 128256, where mfa_tpu keeps 32000
    _same_fields(got, want, skip=("vocab_size",) if name == "llama3_8b" else ())
    if name == "llama3_8b":
        assert (got.vocab_size, want.vocab_size) == (128256, 32000)
    assert got.moe_hetero == want.moe_hetero


def test_qwen2_and_gemma2_presets_are_the_published_configs():
    tr = pytest.importorskip("transformers")
    from mfa_tpu_torch.models.convert import config_from_hf

    qwen = tr.Qwen2Config(  # Qwen/Qwen2-7B config.json
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        rms_norm_eps=1e-6, rope_theta=1000000.0, max_position_embeddings=131072,
        sliding_window=131072, use_sliding_window=False, tie_word_embeddings=False)
    gemma = tr.Gemma2Config(  # google/gemma-2-9b config.json
        vocab_size=256000, hidden_size=3584, intermediate_size=14336,
        num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8,
        head_dim=256, rms_norm_eps=1e-6, rope_theta=10000.0, sliding_window=4096,
        query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
        max_position_embeddings=8192)
    for hf, preset in ((qwen, tl.LlamaConfig.qwen2_7b()), (gemma, tl.LlamaConfig.gemma2_9b())):
        derived = config_from_hf(hf)
        # layer_types give the same alternation as alt_window
        skip = ("layer_pattern",) if preset.alt_window else ()
        for f in dataclasses.fields(preset):
            if f.name not in skip:
                assert getattr(preset, f.name) == getattr(derived, f.name), f.name
        assert preset.sliding_pattern == derived.sliding_pattern
    assert tl.LlamaConfig.qwen2_7b().n_heads // 4 == 7
    assert [tl._layer_plan(tl.LlamaConfig.gemma2_9b())[i][0] for i in range(4)] == [
        4095, -1, 4095, -1]


def _noisy(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module", params=list(FAMILIES))
def model(request):
    kw = FAMILIES[request.param]
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **kw)
    tree = _noisy(jl.init_params(jax.random.key(0), jcfg), 1)
    return (request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            tl.params_from_numpy(tree, tcfg, "cpu"))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_forward_prefill_decode_verify_match_jax(model, quant):
    """A 27-token prompt (past the 16-token window) and a 6-token one:
    forward, prefill and three decode steps, then a 3-token verify span."""
    name, jcfg, tcfg, jp, tp = model
    tol = TOL if quant is None else dict(atol=1e-2, rtol=1e-2)
    toks = np.random.RandomState(4).randint(0, 128, (2, 29)).astype(np.int32)
    got = tl.forward(tp, torch.from_numpy(toks).long(), tcfg)
    if quant is None:
        want = jl.forward(jp, jnp.asarray(toks), jcfg)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    jc = jl.build_kv_caches(jcfg, 16, 8, 2, 6, quant)
    tc = tl.build_kv_caches(tcfg, 16, 8, 2, 6, quant, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(0, 128, 27)), list(rng.randint(0, 128, 6))]
    pages = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    jc, jlog = jl.prefill_batch(jp, jcfg, jc, [0, 1], pages, prompts)
    tc, tlog = tl.prefill_batch(tp, tcfg, tc, [0, 1], pages, prompts)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    nxt = np.argmax(np.asarray(jlog), -1)
    for _ in range(3):
        jc, jlog = jl.decode_step(jp, jcfg, jc, jnp.asarray([0, 1], jnp.int32),
                                  jnp.asarray(nxt, jnp.int32))
        tc, tlog = tl.decode_step(tp, tcfg, tc, [0, 1], nxt)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
        nxt = np.argmax(np.asarray(jlog), -1)
    span = [[int(nxt[0]), 3, 4], [int(nxt[1]), 5, 6]]
    jc, jlog = jl.verify_step(jp, jcfg, jc, jnp.asarray([0, 1], jnp.int32),
                              jnp.asarray(span, jnp.int32))
    tc, tlog = tl.verify_step(tp, tcfg, tc, [0, 1], span)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    if name == "gemma2" and quant is None:  # the caps bite: without them the logits differ
        free = dataclasses.replace(tcfg, attn_softcap=None, logit_softcap=None)
        assert not torch.allclose(tl.forward(tp, torch.from_numpy(toks).long(), free),
                                  got, atol=1e-2)


def test_chunked_prefix_engine_matches_jax(model):
    """Chunks of 8 and the prefix cache: a 30-token prompt (4 chunks) and a
    short one in the first wave, then two prompts that share the first's
    16-token prefix and hit its 2 cached pages, prefilling their suffix."""
    name, jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(11)
    first = [int(t) for t in rng.randint(0, 120, 30)]
    waves = [[(first, 3), ([int(t) for t in rng.randint(0, 120, 5)], 2)],
             [(first[:16] + [5] * 9, 3), (first[:16] + [6], 2)]]
    kw = dict(KW, prefill_chunk=8, prefix_cache=True)
    jeng = JaxEngine(jp, jcfg, **kw)
    eng = Engine(tp, tcfg, device="cpu", **kw)
    free0 = eng.sched.allocator.free_pages
    jr, tr = [], []
    for wave in waves:
        jr += [jeng.submit(p, n) for p, n in wave]
        jeng.run()
        tr += [eng.submit(p, n) for p, n in wave]
        eng.run()
    for t, j in zip(tr, jr):
        assert len(t.generated) == t.max_new_tokens
        assert t.generated == j.generated, (name, t.uid, t.generated, j.generated)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-3)
    prompt_tokens = sum(len(p) for wave in waves for p, _ in wave)
    assert eng.stats.prefill_tokens == prompt_tokens - 32  # two hits of 16
    assert eng.stats.chunk_batches >= 4
    assert eng.sched.allocator.free_pages + len(eng.sched.prefix.pages) == free0


@pytest.mark.parametrize("knob", ["attn_softcap", "logit_softcap"])
def test_each_softcap_matches_jax(knob):
    """The knobs the port refused before: each alone on a plain tiny model."""
    kw = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96,
              **{knob: 1.5})
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **kw)
    tree = _noisy(jl.init_params(jax.random.key(3), jcfg), 2)
    toks = np.random.RandomState(6).randint(0, 96, (2, 19)).astype(np.int32)
    want = jl.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), jcfg)
    got = tl.forward(tl.params_from_numpy(tree, tcfg, "cpu"),
                     torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_gemma2_sgd_train_steps_match_jax():
    kw = FAMILIES["gemma2"]
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **kw)
    tcfg = tl.LlamaConfig(dtype=torch.float32, **kw)
    tree = _noisy(jl.init_params(jax.random.key(0), jcfg), 1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tl.params_from_numpy(tree, tcfg, "cpu")
    toks = np.random.RandomState(10).randint(0, 128, (2, 31)).astype(np.int32)
    for _ in range(2):
        jp, jloss = jl.train_step(jp, jnp.asarray(toks), jcfg, lr=0.1)
        tp, tloss = tl.train_step(tp, toks, tcfg, lr=0.1)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-4, rtol=1e-4)
    for i, lp in enumerate(tp["layers"]):
        for key, t in lp.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp["layers"][key][i]),
                                       err_msg=f"layer {i} {key}", atol=1e-4, rtol=1e-4)
    for key in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(tp[key].detach().numpy(), np.asarray(jp[key]),
                                   err_msg=key, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("group,hkv,pages,softcap,window", [
    (3, 2, "fp32", 0.0, -1), (5, 1, "int8", 0.0, 20), (6, 1, "fp32", 20.0, -1),
    (7, 2, "int8", 20.0, 12),
])
def test_paged_prefill_groups_not_dividing_64_match_jax(group, hkv, pages, softcap,
                                                        window):
    """Kernel 8's plain version (the function the card's kernel is held to)
    at groups that leave dead tail rows in the kernel's 64-row warpgroups:
    one chunk mid sequence and one at offset 0 with q_lens short of it,
    head_dim 128, pages of 16 through a shuffled table."""
    b, sq, d, page, pps = 2, 24, 128, 16, 5
    rng = np.random.RandomState(group)
    num_pages = b * pps + 3
    q = rng.standard_normal((b, sq, group * hkv, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    table = (rng.permutation(num_pages - 1)[: b * pps] + 1).reshape(b, pps).astype(np.int32)
    q_start, lens, q_lens = [40, 0], [64, 30], np.asarray([24, 17], np.int32)
    jkw, tkw = {}, {}
    if pages == "int8":
        kq, ks = (np.array(a) for a in jax_quantize(jnp.asarray(kp), "int8"))
        vq, vs = (np.array(a) for a in jax_quantize(jnp.asarray(vp), "int8"))
        kp, vp = kq, vq
        jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), quant_dtype="int8")
        tkw = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs),
                   quant_dtype="int8")
    common = dict(causal=True, window_left=window, logit_softcap=softcap,
                  return_lse=True, softmax_scale=0.1)
    jo, jlse = jax_paged_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens, jnp.int32),
        jnp.asarray(q_start, jnp.int32), jnp.asarray(table), q_lens=jnp.asarray(q_lens),
        **common, **jkw)
    to, tlse = paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.tensor(lens), torch.tensor(q_start), torch.from_numpy(table),
        q_lens=torch.from_numpy(q_lens), **common, **tkw)
    jo, jlse = np.asarray(jo), np.asarray(jlse)
    for i in range(b):
        r = int(q_lens[i])
        np.testing.assert_allclose(to[i, :r].numpy(), jo[i, :r], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tlse[i, :, :r].numpy(), jlse[i, :, :r], atol=1e-4,
                                   rtol=1e-4)
        assert torch.all(to[i, r:] == 0) and torch.isneginf(tlse[i, :, r:]).all()


def test_paged_prefill_card_route_takes_groups_up_to_64(monkeypatch):
    """The card's route takes any q-per-kv-head group, past the kernel's 64
    rows a warpgroup too (head chunks), and groups that do not divide 64:
    each records its launch (meta tensors: nothing is built or run; the C
    launch replaced by a stub that reports success)."""
    from mfa_tpu_torch.kernels import _build, paged_prefill

    monkeypatch.setattr(_build, "function", lambda lib, name, argtypes: lambda *a: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    pages = torch.empty(1, 3, 16, 128, dtype=torch.bfloat16, device="meta")
    ints = torch.empty(1, dtype=torch.int32, device="meta")
    table = torch.empty(1, 1, dtype=torch.int32, device="meta")
    for group in (7, 64, 65, 71, 128):
        q = torch.empty(1, 8, group, 128, dtype=torch.bfloat16, device="meta")
        _build.reset_launches()
        out, lse = paged_prefill._paged_prefill_cuda(q, pages, pages, None, None, ints,
                                                     ints, ints, table, 0.1, -1, 0, 0.0)
        assert out.shape == q.shape and lse.shape == (1, group, 8)
        assert dict(_build.launches) == {"paged_prefill": 1}
    _build.reset_launches()
