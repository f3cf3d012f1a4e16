"""The port's Llama serving path (plain kernels on CPU) against mfa_tpu's
model: LlamaConfig.tiny with 2 layers and head_dim 64 in fp32, the JAX
params carried over by params_from_numpy. Prefill and decode logits agree
to atol = rtol = 1e-3 and greedy tokens are identical, with and without
int8 KV (the payloads are byte-equal, so only fp32 summation order
differs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu_torch.models import llama as tl

JCFG = jl.LlamaConfig.tiny(vocab=64, dim=256, layers=2, heads=4, kv_heads=2,
                           ffn=256, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=256, layers=2, heads=4, kv_heads=2,
                           ffn=256, dtype=torch.float32)
TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.key(0), JCFG)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefill_and_decode_logits_match_jax(params, quant):
    jp, tp = params
    assert TCFG.head_dim == 64
    jc = jl.build_kv_caches(JCFG, 16, 8, 2, 8, quant)
    tc = tl.build_kv_caches(TCFG, 16, 8, 2, 8, quant, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(0, 64, 13)), list(rng.randint(0, 64, 5))]
    pages = [[1, 2, 3, 4], [5, 6, 7, 8]]
    jc, jlog = jl.prefill_batch(jp, JCFG, jc, [0, 1], pages, prompts)
    tc, tlog = tl.prefill_batch(tp, TCFG, tc, [0, 1], pages, prompts)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    if quant:  # pages are head_dim wide here, 128-lane padded in JAX
        np.testing.assert_array_equal(
            tc.k_pages.numpy(), np.asarray(jc.k_pages)[..., :TCFG.head_dim])
    toks = np.argmax(np.asarray(jlog), -1)
    for _ in range(3):
        jc, jlog = jl.decode_step(jp, JCFG, jc, jnp.asarray([0, 1], jnp.int32),
                                  jnp.asarray(toks, jnp.int32))
        tc, tlog = tl.decode_step(tp, TCFG, tc, [0, 1], toks)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_array_equal(tlog.numpy().argmax(-1),
                                      np.asarray(jlog).argmax(-1))
        toks = np.argmax(np.asarray(jlog), -1)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_rope_and_norm_match_jax():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None] + np.array([[0], [300]], np.int32)
    for scaling in (None, ("llama3", 8.0, 1.0, 4.0, 8192)):
        j = jl._rope(jnp.asarray(x), jnp.asarray(pos), 5e5, 1.0, scaling)
        t = tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5, 1.0, scaling)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
    w = rng.standard_normal(64).astype(np.float32)
    j = jl._rms_norm(jnp.asarray(x), jnp.asarray(w), JCFG)
    t = tl._rms_norm(torch.from_numpy(x), torch.from_numpy(w), TCFG)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_llama3_8b_is_the_published_shape():
    cfg = tl.LlamaConfig.llama3_8b()
    assert (cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.ffn_dim, cfg.vocab_size, cfg.rope_theta) == (
        32, 4096, 32, 8, 128, 14336, 128256, 500000.0)
    assert cfg.dtype == torch.bfloat16


def test_unported_family_knobs_raise():
    for kw in (dict(n_experts=8), dict(qk_norm=True),
               dict(layer_pattern=(True, False))):
        with pytest.raises(NotImplementedError):
            dataclasses.replace(TCFG, **kw)


def test_init_params_is_seeded():
    a = tl.init_params(TCFG, seed=3, device="cpu")
    b = tl.init_params(TCFG, seed=3, device="cpu")
    c = tl.init_params(TCFG, seed=4, device="cpu")
    assert torch.equal(a["layers"][1]["wq"], b["layers"][1]["wq"])
    assert not torch.equal(a["layers"][1]["wq"], c["layers"][1]["wq"])
    assert a["embed"].shape == (TCFG.vocab_size, TCFG.dim)
    assert a["layers"][0]["attn_norm"].dtype == torch.float32
