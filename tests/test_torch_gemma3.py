"""The port's Gemma3 text stack and multimodal serving against mfa_tpu on a
tiny fp32 Gemma3 (q/k norms, post norms, (1 + w) norms, scaled
embeddings, gelu-tanh, head_dim 32 != dim / heads, query_pre_attn_scalar
16, pattern sliding, sliding, global over 3 layers with window 16 and a
dual rotary), the JAX weights perturbed with numpy noise and carried over:
forward, prefill and decode logits within 1e-3 and greedy tokens
identical; the Engine with vision= gives the JAX Engine's greedy tokens
for a mix of image and text requests; image requests never take or give
prefix-cache pages; two SGD train steps update every weight as mfa_tpu's
train_step does (atol = rtol = 1e-4); a text-only Engine with chunked
prefill and the prefix cache gives the JAX Engine's greedy tokens, its
second wave hitting the first's cached pages; LlamaConfig.gemma3_4b() is
what mfa_tpu's config_from_hf derives from the published
google/gemma-3-4b-it text config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu.models import vision as jv
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.models import vision as tv
from mfa_tpu_torch.serve.engine import Engine
from tests.jax_maps import release_jax_code  # noqa: F401

IMG = 100
GEMMA = dict(vocab_size=128, dim=64, n_layers=3, n_heads=4, n_kv_heads=2,
             ffn_dim=128, rope_theta=1e6, norm_eps=1e-6, sliding_window=16,
             head_dim_override=32, hidden_act="gelu_tanh", norm_offset=True,
             embed_scale=True, query_scale=16.0 ** -0.5, post_norms=True,
             qk_norm=True, layer_pattern=(True, True, False),
             rope_theta_local=1e4, rope_scale=8.0)
JCFG = jl.LlamaConfig(dtype=jnp.float32, **GEMMA)
TCFG = tl.LlamaConfig(dtype=torch.float32, **GEMMA)
VKW = dict(hidden=64, intermediate=128, n_layers=2, n_heads=4, image_size=28,
           patch_size=7, mm_tokens_per_image=4)
JV, TV = jv.SiglipVisionConfig(**VKW), tv.SiglipVisionConfig(**VKW)
TOL = dict(atol=1e-3, rtol=1e-3)
KW = dict(num_pages=32, page_size=8, max_seqs=4, pages_per_seq=8)


def _noisy(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32),
                        tree)


@pytest.fixture(scope="module")
def weights():
    ttree = _noisy(jl.init_params(jax.random.key(0), JCFG), 1)
    vtree = _noisy(jv.init_vision_params(jax.random.key(2), JV, JCFG.dim), 3)
    return (jax.tree.map(jnp.asarray, ttree), tl.params_from_numpy(ttree, TCFG, "cpu"),
            jax.tree.map(jnp.asarray, vtree), tv.vision_params_from_numpy(vtree, TV, "cpu"))


def _prompt(rng, *parts):
    """Text runs of the given lengths with 4-token image runs between."""
    out = []
    for i, n in enumerate(parts):
        if i:
            out += [IMG] * 4
        out += [int(t) for t in rng.randint(0, 90, n)]
    return out


def test_forward_matches_jax(weights):
    jp, tp, _, _ = weights
    toks = np.random.RandomState(4).randint(0, 128, (2, 29)).astype(np.int32)
    want = jl.forward(jp, jnp.asarray(toks), JCFG)
    got = tl.forward(tp, torch.from_numpy(toks).long(), TCFG)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefill_and_decode_match_jax(weights, quant):
    """One prompt longer than the 16-token window, so the sliding layers
    cut it in prefill and in every decode step."""
    jp, tp = weights[:2]
    jc = jl.build_kv_caches(JCFG, 16, 8, 2, 6, quant)
    tc = tl.build_kv_caches(TCFG, 16, 8, 2, 6, quant, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(0, 128, 27)), list(rng.randint(0, 128, 6))]
    pages = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    jc, jlog = jl.prefill_batch(jp, JCFG, jc, [0, 1], pages, prompts)
    tc, tlog = tl.prefill_batch(tp, TCFG, tc, [0, 1], pages, prompts)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    toks = np.argmax(np.asarray(jlog), -1)
    for _ in range(4):
        jc, jlog = jl.decode_step(jp, JCFG, jc, jnp.asarray([0, 1], jnp.int32),
                                  jnp.asarray(toks, jnp.int32))
        tc, tlog = tl.decode_step(tp, TCFG, tc, [0, 1], toks)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_array_equal(tlog.numpy().argmax(-1),
                                      np.asarray(jlog).argmax(-1))
        toks = np.argmax(np.asarray(jlog), -1)


def test_vision_engine_matches_jax(weights):
    """2 image requests (one with two images, its second run past the
    window) and 2 text requests (one longer than the window), one wave."""
    jp, tp, jvp, tvp = weights
    rng = np.random.RandomState(6)
    px = np.random.RandomState(7).standard_normal((3, 3, 28, 28)).astype(np.float32)
    reqs = [(_prompt(rng, 5, 6), px[:1], 5), (_prompt(rng, 3, 14, 3), px[1:], 4),
            (_prompt(rng, 25), None, 5), (_prompt(rng, 7), None, 3)]
    jeng = JaxEngine(jp, JCFG, vision=(jvp, JV, IMG), **KW)
    jr = [jeng.submit(p, n, images=im) for p, im, n in reqs]
    jeng.run()
    eng = Engine(tp, TCFG, vision=(tvp, TV, IMG), device="cpu", **KW)
    free0 = eng.sched.allocator.free_pages
    tr = [eng.submit(p, n, images=im) for p, im, n in reqs]
    stats = eng.run()
    for t, j in zip(tr, jr):
        assert len(t.generated) == t.max_new_tokens
        assert t.generated == j.generated, (t.uid, t.generated, j.generated)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-3)
    assert stats.prefill_batches == 2 and stats.image_batches == 1
    assert stats.image_prefill_tokens == len(reqs[0][0]) + len(reqs[1][0])
    assert eng.sched.allocator.free_pages == free0
    with pytest.raises(ValueError):  # 2 images need 8 placeholders
        eng.submit(reqs[0][0], 2, images=px[:2])
    with pytest.raises(ValueError):  # no vision= tuple
        Engine(tp, TCFG, device="cpu", **KW).submit(reqs[0][0], 2, images=px[:1])


def test_image_requests_skip_the_prefix_cache(weights):
    """An image request neither registers its pages nor matches cached
    text pages with the same token ids (their KV depends on the pixels),
    and never takes the chunked route."""
    _, tp, _, tvp = weights
    rng = np.random.RandomState(8)
    prompt = _prompt(rng, 9, 6)  # 19 tokens: two full prompt pages
    px = np.random.RandomState(9).standard_normal((1, 3, 28, 28)).astype(np.float32)
    base = Engine(tp, TCFG, device="cpu", **KW)
    text_only = base.submit(prompt, 4)
    base.run()
    eng = Engine(tp, TCFG, vision=(tvp, TV, IMG), prefix_cache=True,
                 prefill_chunk=8, device="cpu", **KW)
    img1 = eng.submit(prompt, 4, images=px)
    eng.run()
    assert not eng.sched.prefix.pages  # nothing registered
    txt = eng.submit(prompt, 4)
    eng.run()
    assert txt.generated == text_only.generated
    assert len(eng.sched.prefix.pages) == 2  # the text request's pages
    before = eng.stats.prefill_tokens
    img2 = eng.submit(prompt, 4, images=px)
    eng.step()
    assert img2.cached_len == 0 and eng.stats.prefill_tokens - before == len(prompt)
    eng.run()
    assert img2.generated == img1.generated != text_only.generated
    assert eng.stats.image_batches == 2


def test_sgd_train_steps_match_jax(weights):
    """Two SGD steps on 30-token rows (past the 16-token window, so the
    sliding layers' backward cuts the band): the loss and every updated
    weight as mfa_tpu's train_step gives them."""
    jp = weights[0]
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    toks = np.random.RandomState(10).randint(0, 128, (2, 31)).astype(np.int32)
    for _ in range(2):
        jp, jloss = jl.train_step(jp, jnp.asarray(toks), JCFG, lr=0.1)
        tp, tloss = tl.train_step(tp, toks, TCFG, lr=0.1, remat=True)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-4, rtol=1e-4)
    for i, lp in enumerate(tp["layers"]):
        for name, t in lp.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp["layers"][name][i]),
                                       err_msg=f"layer {i} {name}", atol=1e-4, rtol=1e-4)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(tp[name].detach().numpy(), np.asarray(jp[name]),
                                   err_msg=name, atol=1e-4, rtol=1e-4)


def test_chunked_prefix_engine_matches_jax(weights):
    """Text only, chunks of 8 and the prefix cache: a first wave of a
    25-token prompt (4 chunks) and one sharing its first 16 tokens, then a
    second wave of two more that share them and hit its 2 cached pages,
    prefilling only their suffix."""
    jp, tp = weights[:2]
    rng = np.random.RandomState(11)
    shared = [int(t) for t in rng.randint(0, 90, 16)]
    waves = [[([int(t) for t in rng.randint(0, 90, 25)], 4), (shared + [3, 4], 3)],
             [(shared + [5] * 9, 4), (shared + [6], 5)]]
    kw = dict(KW, prefill_chunk=8, prefix_cache=True)
    jeng = JaxEngine(jp, JCFG, **kw)
    eng = Engine(tp, TCFG, device="cpu", **kw)
    free0 = eng.sched.allocator.free_pages
    jr, tr = [], []
    for wave in waves:
        jr += [jeng.submit(p, n) for p, n in wave]
        jeng.run()
        tr += [eng.submit(p, n) for p, n in wave]
        eng.run()
    for t, j in zip(tr, jr):
        assert len(t.generated) == t.max_new_tokens
        assert t.generated == j.generated, (t.uid, t.generated, j.generated)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-3)
    # the second wave's two hits skip the 2 cached pages (16 tokens) each
    prompt_tokens = sum(len(p) for wave in waves for p, _ in wave)
    assert eng.stats.prefill_tokens == prompt_tokens - 32
    assert eng.stats.chunk_batches >= 4
    assert eng.sched.allocator.free_pages + len(eng.sched.prefix.pages) == free0


def test_gemma3_4b_is_the_published_config():
    transformers = pytest.importorskip("transformers")
    from mfa_tpu.models.convert import config_from_hf

    hf = transformers.Gemma3TextConfig(
        vocab_size=262208, hidden_size=2560, intermediate_size=10240,
        num_hidden_layers=34, num_attention_heads=8, num_key_value_heads=4,
        head_dim=256, rms_norm_eps=1e-6, sliding_window=1024,
        query_pre_attn_scalar=256, rope_theta=1000000.0,
        rope_local_base_freq=10000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        hidden_activation="gelu_pytorch_tanh", max_position_embeddings=131072,
        final_logit_softcapping=None, attn_logit_softcapping=None)
    want = config_from_hf(hf)
    got = tl.LlamaConfig.gemma3_4b()
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert a == torch.bfloat16 and b == jnp.bfloat16
        else:
            assert a == b, (f.name, a, b)
    assert got.head_dim == 256 and got.window_left == 1023
    assert [i for i, s in enumerate(got.layer_pattern) if not s] == [5, 11, 17, 23, 29]
