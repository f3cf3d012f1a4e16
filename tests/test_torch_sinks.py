"""StreamingLLM attention sinks in the port (the mirror of
tests/test_sinks.py): with a sliding window the first `sinks` tokens stay
visible to every query. The port's plain versions of the prefill engines
(classic, and the zero-shift pair flagged + repair), contiguous and paged
decode (whole and split), the kvcache entry point, the engine and the
fused backward are held against mfa_tpu's kernels in interpret mode on
the same numpy inputs (fp32, atol = rtol = 1e-4; the tiny model's tokens
identical, logits within 2e-4, gradients within 2e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfa_tpu
import mfa_tpu_torch
from mfa_tpu.kernels.autodiff import flash_attention_grad as jax_grad
from mfa_tpu.kernels.decode import decode_attention as jax_decode
from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.prefill import prefill_attention as jax_prefill
from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu.serve.sampling import SamplingParams as JaxSampling
from mfa_tpu_torch.kernels import paged
from mfa_tpu_torch.kernels.autodiff import flash_attention_grad
from mfa_tpu_torch.kernels.decode import decode_attention
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine
from mfa_tpu_torch.serve.sampling import SamplingParams
from tests.jax_maps import release_jax_code  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _rn(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _port_engines(q, k, v, **kw):
    """The port's plain engines on one input: classic and the default
    (flagged + repair at d 128, the bound prepass at d 64)."""
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return [prefill_attention(*t, bound_softmax=m, **kw).numpy()
            for m in (False, None)]


def test_prefill_sinks_noncausal_gap_filled():
    """Non-causal window 0 with 128 sinks: the sink tiles exactly fill the
    gap the window leaves (mfa_tpu's regression case)."""
    q, k, v = (_rn(i, 1, 2, 256, 64) for i in (3, 4, 5))
    kw = dict(causal=False, window_size=(0, -1), sink_tokens=128)
    want = np.asarray(jax_prefill(*(jnp.asarray(a) for a in (q, k, v)), **kw))
    for got in _port_engines(q, k, v, **kw):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("wl,sinks,s", [(63, 10, 400), (31, 4, 130),
                                        (100, 140, 260)])
def test_prefill_sinks_match_oracle(wl, sinks, s):
    """Causal window + sinks, GQA 2:1 at d 128 (the flagged + repair pair
    by default), against mfa_tpu's default engine; the sinks change the
    rows past the window."""
    q, k, v = _rn(0, 1, 2, s, 128), _rn(1, 1, 1, s, 128), _rn(2, 1, 1, s, 128)
    kw = dict(causal=True, window_size=(wl, -1), sink_tokens=sinks)
    want = np.asarray(jax_prefill(*(jnp.asarray(a) for a in (q, k, v)), **kw))
    for got in _port_engines(q, k, v, **kw):
        np.testing.assert_allclose(got, want, **TOL)
    plain = _port_engines(q, k, v, causal=True, window_size=(wl, -1))[0]
    assert np.abs(plain - want)[:, :, wl + sinks + 1:].max() > 1e-3


def _pages(b=3, h=4, kvh=2, d=64, page=16, pps=16):
    n = b * pps + 1
    kp, vp = _rn(1, kvh, n, page, d), _rn(2, kvh, n, page, d)
    table = np.arange(1, b * pps + 1, dtype=np.int32).reshape(b, pps)
    return _rn(0, b, h, d), kp, vp, table


def test_paged_decode_sinks_match_oracle():
    q, kp, vp, table = _pages()
    lens = np.array([250, 97, 16], np.int32)
    kw = dict(window_left=40, sink_tokens=12)
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, lens, table)),
                                pages_per_compute_block=2, **kw))
    t = [torch.from_numpy(a) for a in (q, kp, vp, lens, table)]
    got = paged.paged_attention(*t, **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the kernel's split route: each sink column in exactly one split
    for n in (2, 3):
        split, _ = paged._paged_split_plain(t[0], t[1], t[2], None, None, t[3],
                                            t[4], 64 ** -0.5, 40, 0.0, 0,
                                            num_splits=n, sinks=12)
        np.testing.assert_allclose(split.numpy(), want, **TOL)
    no_sinks = paged.paged_attention(*t, window_left=40).numpy()
    assert np.abs(no_sinks - want).max() > 1e-4


def test_contiguous_decode_sinks_match_oracle():
    q, k, v = _rn(0, 2, 4, 64), _rn(1, 2, 2, 300, 64), _rn(2, 2, 2, 300, 64)
    lens = np.array([288, 100], np.int32)
    kw = dict(window_left=50, sink_tokens=7)
    want = np.asarray(jax_decode(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                 block_k=128, **kw))
    for n in (1, 3):
        got = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)),
                               num_splits=n, **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _cfgs(**kw):
    base = dict(vocab=64, dim=64, layers=2, heads=4, kv_heads=2, ffn=96)
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(**base, dtype=jnp.float32),
                               sliding_window=24, attn_sinks=4, **kw)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(**base, dtype=torch.float32),
                               sliding_window=24, attn_sinks=4, **kw)
    return jcfg, tcfg


JCFG, TCFG = _cfgs()
EKW = dict(num_pages=48, page_size=8, max_seqs=4, pages_per_seq=12)


def _params(seed, jcfg=JCFG, tcfg=TCFG):
    jp = jl.init_params(jax.random.key(seed), jcfg)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _serve(make, prompts, n, burst, **kw):
    eng = make(**{**EKW, **kw})
    reqs = [eng.submit(p, n) for p in prompts]
    eng.run(burst=burst)
    assert eng.sched.allocator.free_pages == EKW["num_pages"] - 1
    return reqs


def test_engine_sinks_burst_matches_stepwise():
    jp, tp = _params(0)
    prompts = [[1, 2, 3] * 12, [5] * 9]  # the first prompt exceeds the window
    port = lambda cfg: lambda **kw: Engine(tp, cfg, device="cpu", **kw)  # noqa: E731
    gen = [r.generated for r in _serve(port(TCFG), prompts, 6, 4)]
    assert gen == [r.generated for r in _serve(port(TCFG), prompts, 6, 1)]
    ref = _serve(lambda **kw: JaxEngine(jp, JCFG, **kw), prompts, 6, 4)
    assert gen == [r.generated for r in ref]
    # sinks change the output against the plain sliding window
    nosink = dataclasses.replace(TCFG, attn_sinks=0)
    assert gen[0] != _serve(port(nosink), prompts, 6, 4)[0].generated


def test_engine_sinks_chunked_matches_whole():
    jp, tp = _params(1)
    prompt = [int(t) for t in np.random.RandomState(0).randint(0, 64, 45)]
    pages = list(range(1, 9))
    jc = jl.build_kv_caches(JCFG, 16, 8, 2, 8)
    _, want = jl.prefill_step(jp, JCFG, jc, 0, pages, jnp.asarray(prompt, jnp.int32))
    whole = tl.build_kv_caches(TCFG, 16, 8, 2, 8, device="cpu")
    _, ref = tl.prefill_batch(tp, TCFG, whole, [0], [pages], [prompt])
    cc = tl.build_kv_caches(TCFG, 16, 8, 2, 8, device="cpu")
    for pos in range(0, len(prompt), 16):
        cc, logits = tl.prefill_chunk(tp, TCFG, cc, 0, pages,
                                      prompt[pos:pos + 16], pos, len(prompt))
    np.testing.assert_allclose(logits.numpy(), ref[0].numpy(), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ref[0].numpy(), np.asarray(want).reshape(-1),
                               atol=2e-4, rtol=1e-4)


def test_public_kvcache_api_sinks():
    q, kc, vc = _rn(0, 2, 1, 4, 64), _rn(1, 2, 200, 2, 64), _rn(2, 2, 200, 2, 64)
    lens = np.array([180, 60], np.int32)
    kw = dict(window_size=(30, -1), sink_tokens=5)
    want = mfa_tpu.flash_attn_with_kvcache(
        *(jnp.asarray(a) for a in (q, kc, vc)), cache_seqlens=jnp.asarray(lens),
        **kw)
    got = mfa_tpu_torch.flash_attn_with_kvcache(
        *(torch.from_numpy(a) for a in (q, kc, vc)),
        cache_seqlens=torch.from_numpy(lens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the paged route of the same entry point on the same rows
    pool_k = kc.reshape(2 * 25, 8, 2, 64)
    pool_v = vc.reshape(2 * 25, 8, 2, 64)
    table = torch.arange(50, dtype=torch.int32).reshape(2, 25)
    got_p = mfa_tpu_torch.flash_attn_with_kvcache(
        torch.from_numpy(q), torch.from_numpy(pool_k), torch.from_numpy(pool_v),
        cache_seqlens=torch.from_numpy(lens), block_table=table, **kw)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want), **TOL)


def test_interaction_int4_window_sinks_penalty():
    """int4 KV + sliding window + sinks + repetition penalty + bursts: the
    same tokens as stepwise and as mfa_tpu, finite logprobs."""
    jp, tp = _params(7)
    prompts = [[1, 2, 3] * 11, [5] * 7]

    def run(make, burst):
        reqs = _serve(make, prompts, 6, burst, quant_dtype="int4")
        for r in reqs:
            assert len(r.generated) == 6 and np.isfinite(r.logprobs).all()
        return [r.generated for r in reqs]

    port = lambda **kw: Engine(  # noqa: E731
        tp, TCFG, device="cpu",
        sampling=SamplingParams(temperature=0.0, repetition_penalty=1.5), **kw)
    gen = run(port, 3)
    assert gen == run(port, 1)
    assert gen == run(lambda **kw: JaxEngine(
        jp, JCFG, sampling=JaxSampling(temperature=0.0, repetition_penalty=1.5),
        **kw), 3)


@pytest.mark.parametrize("wl,sinks,s", [(63, 8, 256), (127, 16, 300)])
def test_sinks_backward_grad_parity(wl, sinks, s):
    """The fused backward with sinks: the port's gradients against
    mfa_tpu's (flash_attention_grad, interpret mode)."""
    q, k, v, do = (_rn(i, 1, 2, s, 64) for i in (1, 2, 3, wl))
    args = (True, None, (wl, -1), 0.0, sinks)

    def jloss(q, k, v):
        return jnp.sum(jax_grad(q, k, v, *args) * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_grad(qt, kt, vt, *args)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (qt, kt, vt))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-4, err_msg=f"d{name}")


def test_train_step_sinks_matches_jax():
    """Two SGD steps of the tiny sinks model on 40-token rows (past the
    window of 24): loss and every updated weight against mfa_tpu's."""
    jp, tp = _params(2)
    toks = np.random.RandomState(3).randint(0, 64, (2, 40)).astype(np.int32)
    for _ in range(2):
        jp, jloss = jl.train_step(jp, jnp.asarray(toks), JCFG, lr=0.1)
        tp, tloss = tl.train_step(tp, toks, TCFG, lr=0.1)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for i, lp in enumerate(tp["layers"]):
        for name, t in lp.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jp["layers"][name][i]),
                                       err_msg=f"layer {i} {name}", **TOL)
