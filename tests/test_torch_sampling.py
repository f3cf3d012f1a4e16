"""The port's sampler (mfa_tpu_torch/serve/sampling.py) and the sampling
Engine against mfa_tpu's, mirroring tests/test_sampling.py:

- jax.random.categorical(key, l) is argmax(l + jax.random.gumbel(key,
  l.shape)), so the port's draws, given JAX's Gumbel noise (and JAX's
  uniforms for the acceptance tests), must give JAX's tokens exactly;
- filtered_logits within 1e-6 (the same -inf entries) for top-k, top-p,
  min-p and their combinations; sample and sample_dynamic token-equal;
  the repetition penalty; speculative_accept greedy and sampled with the
  same tokens and m; the acceptance rule preserving the target
  distribution (statistical, from a fixed torch.Generator seed);
- at test_torch_engine.py's tiny config: a greedy engine with the
  repetition penalty token-identical to mfa_tpu's (logprobs 1e-3),
  stepwise and in bursts; a per-request mixed batch whose greedy rows equal
  mfa_tpu's; the same seed giving the same tokens, another seed other
  tokens, top-k 1 equal to greedy; stochastic logprobs under the
  unfiltered model; no stale presence on a reused slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu.serve import sampling as js
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve import sampling as ts
from mfa_tpu_torch.serve.engine import Engine
from tests.jax_maps import release_jax_code  # noqa: F401

JCFG = jl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=torch.float32)
PARAMS = [dict(temperature=0.7, top_k=5), dict(temperature=1.3, top_p=0.8),
          dict(temperature=0.9, min_p=0.1),
          dict(temperature=0.8, top_k=20, top_p=0.9, min_p=0.05)]


def _logits(seed, shape=(6, 64)):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32) * 2


def test_categorical_is_argmax_plus_gumbel():
    """The identity the noise-fed comparisons below rest on (jax 0.9.0)."""
    key = jax.random.key(3)
    l = jnp.asarray(_logits(0, (32, 64)))
    a = jax.random.categorical(key, l, axis=-1)
    b = jnp.argmax(l + jax.random.gumbel(key, l.shape), axis=-1)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kw", PARAMS)
def test_filtered_logits_and_sample_match_jax(kw):
    l = _logits(1)
    jp, tp = js.SamplingParams(**kw), ts.SamplingParams(**kw)
    jf = np.asarray(js.filtered_logits(jnp.asarray(l), jp))
    tf = ts.filtered_logits(torch.from_numpy(l), tp).numpy()
    np.testing.assert_array_equal(np.isneginf(tf), np.isneginf(jf))
    fin = np.isfinite(jf)
    np.testing.assert_allclose(tf[fin], jf[fin], atol=1e-6, rtol=1e-6)
    for seed in range(4):
        key = jax.random.key(seed)
        want = np.asarray(js.sample(jnp.asarray(l), key, jp))
        g = torch.from_numpy(np.asarray(jax.random.gumbel(key, l.shape)))
        got = ts.sample(torch.from_numpy(l), tp, gumbel=g).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_dynamic_and_penalty_match_jax():
    l = _logits(2, (5, 64))
    pres = np.random.RandomState(4).rand(5, 64) < 0.2
    vecs = np.array([[0.0, 0.7, 1.2, 0.0, 0.9],  # temperature (0: greedy)
                     [1.0, 0.9, 1.0, 1.0, 0.6],  # top_p
                     [0.0, 0.0, 0.1, 0.0, 0.05],  # min_p
                     [1.0, 1.0, 1.0, 1.7, 1.3]], np.float32)  # penalty
    for seed, top_k in ((0, 0), (1, 12)):
        key = jax.random.key(seed)
        want = np.asarray(js.sample_dynamic(
            jnp.asarray(l), key, *(jnp.asarray(v) for v in vecs), top_k=top_k,
            presence=jnp.asarray(pres)))
        g = torch.from_numpy(np.asarray(jax.random.gumbel(key, l.shape)))
        got = ts.sample_dynamic(torch.from_numpy(l), g,
                                *torch.from_numpy(vecs), top_k=top_k,
                                presence=torch.from_numpy(pres)).numpy()
        np.testing.assert_array_equal(got, want)
    # greedy with the penalty: positive logits divided, negative multiplied
    pen = ts.SamplingParams(repetition_penalty=10.0)
    t = torch.tensor([[2.0, 1.9, -3.0, -1.0]])
    assert int(ts.sample(t, pen)[0]) == 0
    assert int(ts.sample(t, pen, torch.tensor([[True, False, False, False]]))[0]) == 1
    t2 = torch.tensor([[-2.0, -1.9, -3.0, -1.0]])
    assert int(ts.sample(t2, pen, torch.tensor([[False, False, False, True]]))[0]) == 1


def test_speculative_accept_matches_jax():
    n, k, V = 6, 3, 64
    rng = np.random.RandomState(1)
    dl = rng.standard_normal((n, k, V)).astype(np.float32)
    tl_ = (rng.standard_normal((n, k, V)) * 1.5).astype(np.float32)
    # greedy: exact match against the target argmax, which is the residual
    tgt = tl_.argmax(-1)
    d = tgt.copy()
    d[1, 1] = (tgt[1, 1] + 1) % V
    d[3, 0] = (tgt[3, 0] + 1) % V
    jt, jm = js.speculative_accept(jax.random.key(0), jnp.asarray(dl),
                                   jnp.asarray(tl_), jnp.asarray(d),
                                   js.SamplingParams())
    tt, tm = ts.speculative_accept(torch.from_numpy(dl), torch.from_numpy(tl_),
                                   torch.from_numpy(d), ts.SamplingParams())
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert list(tm.numpy()) == [k, 1, k, 0, k, k]
    # sampled: JAX's uniforms and residual noise from _accept_jit's keys
    p = dict(temperature=0.8, top_p=0.9)
    jp, tp = js.SamplingParams(**p), ts.SamplingParams(**p)
    for seed in range(3):
        key = jax.random.key(seed)
        d = np.asarray(jax.random.categorical(
            jax.random.key(100 + seed), js.filtered_logits(jnp.asarray(dl), jp)))
        jt, jm = js.speculative_accept(key, jnp.asarray(dl), jnp.asarray(tl_),
                                       jnp.asarray(d), jp)
        ku, kr = jax.random.split(key)
        u = torch.from_numpy(np.asarray(jax.random.uniform(ku, (n, k))))
        g = torch.from_numpy(np.asarray(jax.random.gumbel(kr, (n, V))))
        tt, tm = ts._accept(ts.filtered_logits(torch.from_numpy(dl), tp),
                            ts.filtered_logits(torch.from_numpy(tl_), tp),
                            torch.from_numpy(d), u, g)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_speculative_accept_preserves_target_distribution():
    """The first emitted token's marginal is the filtered target
    distribution whatever the draft: total variation under 0.05 over 4000
    draws from a fixed generator."""
    V, k, N = 16, 3, 4000
    params = ts.SamplingParams(temperature=0.8, top_p=0.9)
    rng = np.random.RandomState(0)
    dl = torch.from_numpy(rng.standard_normal((1, k, V)).astype(np.float32))
    tl_ = torch.from_numpy((rng.standard_normal((1, k, V)) * 1.5).astype(np.float32))
    p_target = torch.softmax(ts.filtered_logits(tl_, params), -1)[0, 0].numpy()
    gen = torch.Generator().manual_seed(1)
    dlN, tlN = dl.expand(N, k, V), tl_.expand(N, k, V)
    g = ts.gumbel_from_uniform(ts.uniform_noise((N, k, V), gen, "cpu"))
    d_toks = ts._categorical(ts.filtered_logits(dlN, params), g)
    toks, _ = ts.speculative_accept(dlN, tlN, d_toks, params, gen)
    emp = np.bincount(toks[:, 0].numpy(), minlength=V) / N
    tv = 0.5 * np.abs(emp - p_target).sum()
    assert tv < 0.05, (tv, emp, p_target)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.key(1), JCFG)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


KW = dict(num_pages=48, page_size=8, max_seqs=4, pages_per_seq=8)
PEN = dict(repetition_penalty=1.7)


PROMPTS = [[1, 2, 3, 1, 2], [9, 8, 9, 8, 9, 8, 7], [5, 5, 5]]


@pytest.fixture(scope="module")
def jax_penalty_reqs(params):
    jeng = JaxEngine(params[0], JCFG, sampling=js.SamplingParams(**PEN), **KW)
    jreqs = [jeng.submit(p, 8) for p in PROMPTS]
    jeng.run()
    return jreqs


@pytest.mark.parametrize("burst", [1, 3])
def test_penalty_engine_matches_jax(params, jax_penalty_reqs, burst):
    """Stepwise and in pipelined bursts of 3 (presence rows chained across
    bursts on the device) against mfa_tpu's stepwise engine."""
    _, tp = params
    prompts, jreqs = PROMPTS, jax_penalty_reqs
    eng = Engine(tp, TCFG, device="cpu", sampling=ts.SamplingParams(**PEN), **KW)
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.run(burst=burst)
    plain = Engine(tp, TCFG, device="cpu", **KW)
    preqs = [plain.submit(p, 8) for p in prompts]
    plain.run()
    for r, jr, pr in zip(reqs, jreqs, preqs):
        assert r.generated == jr.generated, (r.generated, jr.generated)
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=1e-3)
    assert any(r.generated != pr.generated for r, pr in zip(reqs, preqs))
    assert eng.sched.allocator.free_pages == 47


def test_mixed_batch_greedy_rows_match_jax(params):
    """Greedy, penalized greedy and sampled requests in one batch: the
    deterministic rows equal mfa_tpu's, stepwise and pipelined bursts."""
    jp, tp = params
    hot = dict(temperature=0.9, top_p=0.9, min_p=0.05)
    reqs_spec = [([1, 2, 3], None), ([1, 2, 3], PEN), ([9, 8], hot),
                 ([4, 4, 2, 7], None)]
    jeng = JaxEngine(jp, JCFG, sampling=js.SamplingParams(top_k=20), **KW)
    jreqs = [jeng.submit(p, 6, sampling=js.SamplingParams(**s) if s else None)
             for p, s in reqs_spec]
    jeng.run()
    for burst in (1, 4):
        eng = Engine(tp, TCFG, device="cpu", sampling=ts.SamplingParams(top_k=20),
                     **KW)
        reqs = [eng.submit(p, 6, sampling=ts.SamplingParams(**s) if s else None)
                for p, s in reqs_spec]
        eng.run(burst=burst)
        for i in (0, 1, 3):
            assert reqs[i].generated == jreqs[i].generated, (burst, i)
        assert len(reqs[2].generated) == 6
        assert all(np.isfinite(r.logprobs).all() for r in reqs)
        assert eng.sched.allocator.free_pages == 47


def _run(tp, sampling, seed, burst=1, prompts=([1, 2, 3], [9] * 10)):
    eng = Engine(tp, TCFG, device="cpu", sampling=sampling, seed=seed, **KW)
    reqs = [eng.submit(list(p), 6) for p in prompts]
    eng.run(burst=burst)
    return reqs


def test_seed_determinism_top_k_one_and_logprobs(params):
    _, tp = params
    sp = ts.SamplingParams(temperature=0.8, top_k=16)
    gen = lambda reqs: [r.generated for r in reqs]  # noqa: E731
    a = gen(_run(tp, sp, 0))
    assert a == gen(_run(tp, sp, 0))
    assert a != gen(_run(tp, sp, 1))
    assert gen(_run(tp, sp, 0, burst=4)) == gen(_run(tp, sp, 0, burst=4))
    greedy = gen(_run(tp, None, 0))
    assert gen(_run(tp, ts.SamplingParams(temperature=1.0, top_k=1), 5)) == greedy
    # stochastic logprobs are the unfiltered model's: teacher-force the
    # generated tokens through the training forward
    hot = ts.SamplingParams(temperature=1.5, top_p=0.8)
    for r in _run(tp, hot, 3):
        seq = torch.tensor([r.prompt + r.generated[:-1]])
        lp = torch.log_softmax(tl.forward(tp, seq, TCFG).float(), -1)[0]
        pos = len(r.prompt) - 1 + np.arange(len(r.generated))
        want = lp[pos, torch.tensor(r.generated)].numpy()
        np.testing.assert_allclose(r.logprobs, want, atol=1e-3)


def test_penalty_slot_reuse_no_stale_presence(params):
    _, tp = params
    kw = dict(KW, max_seqs=1)
    pen = ts.SamplingParams(**PEN)
    ref = Engine(tp, TCFG, device="cpu", sampling=pen, **kw)
    r_ref = ref.submit([9, 8, 7], 6)
    ref.run(burst=3)
    eng = Engine(tp, TCFG, device="cpu", sampling=pen, **kw)
    a = eng.submit([1, 2, 3], 6)
    eng.run(burst=3)
    assert len(a.generated) == 6
    b = eng.submit([9, 8, 7], 6)
    eng.run(burst=3)
    assert b.generated == r_ref.generated
