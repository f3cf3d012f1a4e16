"""Multi-query spans of the port's paged decode and its speculative decoding
(plain kernels on CPU) against mfa_tpu, mirroring tests/test_speculative.py
and tests/test_multiquery_decode.py:

- kernel 6's plain version on q [b, q_span, hq, d] against mfa_tpu's paged
  kernel in Pallas interpret mode, fp32 q, atol = rtol = 1e-4 (the same
  function on the same values): (span, group) in (4, 1), (4, 2), (3, 4),
  (8, 2), a window, pos_offset = span, int8 / fp8 / int4 pages (the split
  route held at 4e-3, as for int8: p rounds to bf16 after each split's own
  max), span 1 equal to the 3-D call, and row si equal to a q_span = 1
  call at lens - (q_span - 1 - si);
- verify_step logits against sequential decode_steps and mfa_tpu's
  verify_step (1e-4), rollback;
- the speculative Engine token-identical to plain greedy decoding and to
  mfa_tpu's speculative Engine with the same spec_proposed / spec_accepted;
  self-draft acceptance exactly 1.0; at table capacity; prefix cache +
  chunks + int8 KV + draft together; the sampled speculative engine runs,
  and, fed mfa_tpu's key chain as its uniforms, gives mfa_tpu's sampled
  speculative engine's tokens (stepwise and with prefix cache + chunks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.paged import paged_attention as jax_paged
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.kernels import paged
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine
from mfa_tpu_torch.serve.sampling import SamplingParams
from tests.jax_maps import release_jax_code  # noqa: F401
from tests.test_torch_kv_formats import _payloads

TOL = dict(atol=1e-4, rtol=1e-4)
JCFG = jl.LlamaConfig.tiny(vocab=64, dim=64, layers=2, heads=4, kv_heads=2,
                           ffn=96, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=64, layers=2, heads=4, kv_heads=2,
                           ffn=96, dtype=torch.float32)
JDRAFT = jl.LlamaConfig.tiny(vocab=64, dim=32, layers=1, heads=2, kv_heads=1,
                             ffn=64, dtype=jnp.float32)
TDRAFT = tl.LlamaConfig.tiny(vocab=64, dim=32, layers=1, heads=2, kv_heads=1,
                             ffn=64, dtype=torch.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _span_case(seed, span, group, hkv=2, d=64, page=16, pps=6):
    rng = np.random.RandomState(seed)
    b, pages = 2, 2 * pps + 1
    q = rng.standard_normal((b, span, hkv * group, d)).astype(np.float32)
    kf, vf = (rng.standard_normal((hkv, pages, page, d)).astype(np.float32)
              for _ in range(2))
    table = (rng.permutation(pages - 1)[: b * pps] + 1).reshape(b, pps)
    lens = np.array([page * pps - 3, 37], np.int32)
    return q, kf, vf, table.astype(np.int32), lens


def _check(to, tl_, jo, jl_, tol=TOL):
    jo, jl_ = np.asarray(jo, np.float32), np.asarray(jl_)
    np.testing.assert_allclose(to.float().numpy(), jo, **tol)
    np.testing.assert_array_equal(np.isneginf(tl_.numpy()), np.isneginf(jl_))
    fin = np.isfinite(jl_)
    np.testing.assert_allclose(tl_.numpy()[fin], jl_[fin], **TOL)


@pytest.mark.parametrize("span,group,pos_offset,window", [
    (4, 1, 0, -1), (4, 2, 4, 20), (3, 4, 0, -1), (8, 2, 0, 40)])
def test_span_plain_matches_jax(span, group, pos_offset, window):
    q, kf, vf, table, lens = _span_case(span * 10 + group, span, group)
    kw = dict(pos_offset=pos_offset, window_left=window)
    jo, jl_ = jax_paged(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
                        jnp.asarray(lens), jnp.asarray(table),
                        return_lse=True, **kw)
    to, tl_ = paged.paged_attention(_t(q), _t(kf), _t(vf), _t(lens),
                                    _t(table), return_lse=True, **kw)
    assert to.shape == q.shape and tl_.shape == q.shape[:3]
    _check(to, tl_, jo, jl_)
    # row si is a single query at lens - (span - 1 - si) (pos_offset 0)
    if pos_offset == 0:
        for si in range(span):
            eff = lens - (span - 1 - si)
            ro, rl = paged.paged_attention(_t(q[:, si]), _t(kf), _t(vf),
                                           _t(eff), _t(table), window_left=window,
                                           return_lse=True)
            np.testing.assert_allclose(to[:, si].numpy(), ro.numpy(), **TOL)
            np.testing.assert_allclose(tl_[:, si].numpy(), rl.numpy(), **TOL)


@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_span_quantized_pages_match_jax(quant):
    """pos_offset = span (verify_step's call) with a window, one pass and
    the split route (3 splits)."""
    span, group = 4, 2
    q, kf, vf, table, lens = _span_case(7, span, group)
    if quant == "int8":
        (jk, ks), (jv, vs) = (jax_quantize(jnp.asarray(a), "int8") for a in (kf, vf))
        tk, tv, ks, vs = _t(jk), _t(jv), np.asarray(ks), np.asarray(vs)
    else:
        (jk, jv), (tk, tv), ks, vs = _payloads(kf, vf, quant)
    kw = dict(pos_offset=span, window_left=30)
    jo, jl_ = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                        jnp.asarray(table), k_scales=jnp.asarray(ks),
                        v_scales=jnp.asarray(vs), quant_dtype=quant,
                        return_lse=True, **kw)
    to, tl_ = paged.paged_attention(_t(q), tk, tv, _t(lens), _t(table),
                                    k_scales=_t(ks), v_scales=_t(vs),
                                    quant_dtype=quant, return_lse=True, **kw)
    _check(to, tl_, jo, jl_)
    so, sl = paged._paged_split_plain(_t(q), tk, tv, _t(ks), _t(vs), _t(lens),
                                      _t(table), 64 ** -0.5, 30, 0.0, span,
                                      num_splits=3, quant_dtype=quant)
    _check(so, sl, jo, jl_, dict(atol=4e-3, rtol=0))


def test_span_one_equals_the_3d_call():
    q, kf, vf, table, lens = _span_case(3, 1, 2)
    args = (_t(kf), _t(vf), _t(lens), _t(table))
    a, la = paged.paged_attention(_t(q[:, 0]), *args, pos_offset=1,
                                  return_lse=True)
    b, lb = paged.paged_attention(_t(q), *args, pos_offset=1, return_lse=True)
    assert torch.equal(a, b[:, 0]) and torch.equal(la, lb[:, 0])


@pytest.fixture(scope="module")
def models():
    jp = jl.init_params(jax.random.key(0), JCFG)
    jd = jl.init_params(jax.random.key(9), JDRAFT)
    to_t = lambda tree, cfg: tl.params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, tree), cfg, "cpu")
    return (jp, jd), (to_t(jp, TCFG), to_t(jd, TDRAFT))


def _prefilled(mod, cfg, params, prompt, quant=None):
    if mod is jl:
        cache = jl.build_kv_caches(cfg, 16, 8, 2, 8, quant)
        cache, _ = jl.prefill_step(params, cfg, cache, 0, list(range(1, 9)),
                                   jnp.asarray(prompt, jnp.int32))
        return cache
    cache = tl.build_kv_caches(cfg, 16, 8, 2, 8, quant, device="cpu")
    cache, _ = tl.prefill_batch(params, cfg, cache, [0], [list(range(1, 9))],
                                [prompt])
    return cache


@pytest.mark.parametrize("quant", [None, "int8"])
def test_verify_step_matches_decode_and_jax(models, quant):
    """Sequential decode on fp32 pages (on int8 ones decode reads the span's
    earlier rows back through the kernel, p rounded to bf16, while verify
    merges them unrounded, as in mfa_tpu), and mfa_tpu's verify_step on
    both."""
    (jp, _), (tp, _) = models
    prompt, toks = [3, 1, 4, 1, 5, 9, 2, 6], [7, 8, 9, 10]
    cache_b = _prefilled(tl, TCFG, tp, prompt, quant)
    cache_b, logits = tl.verify_step(tp, TCFG, cache_b, [0], [toks])
    assert logits.shape == (1, len(toks), TCFG.vocab_size)
    if quant is None:
        seq = []
        cache_a = _prefilled(tl, TCFG, tp, prompt, quant)
        for t in toks:
            cache_a, lg = tl.decode_step(tp, TCFG, cache_a, [0], [t])
            seq.append(lg[0].numpy())
        np.testing.assert_allclose(logits[0].numpy(), np.stack(seq),
                                   atol=2e-4, rtol=1e-4)
        assert torch.equal(cache_a.lengths, cache_b.lengths)
    jc = _prefilled(jl, JCFG, jp, prompt, quant)
    jc, jlog = jl.verify_step(jp, JCFG, jc, jnp.asarray([0], jnp.int32),
                              jnp.asarray([toks], jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TOL)


def test_rollback_restores_decode_state(models):
    _, (tp, _) = models
    cache = _prefilled(tl, TCFG, tp, [11, 12, 13])
    base = int(cache.lengths[0])
    clean = tl.build_kv_caches(TCFG, 16, 8, 2, 8, device="cpu")
    for f in ("k_pages", "v_pages", "block_tables", "lengths"):
        getattr(clean, f).copy_(getattr(cache, f))
    cache, _ = tl.verify_step(tp, TCFG, cache, [0], [[7, 8, 9]])
    assert int(cache.lengths[0]) == base + 3
    tl.rollback(cache, [0], [base])
    _, lg_rolled = tl.decode_step(tp, TCFG, cache, [0], [20])
    _, lg_clean = tl.decode_step(tp, TCFG, clean, [0], [20])
    np.testing.assert_allclose(lg_rolled.numpy(), lg_clean.numpy(), atol=2e-5,
                               rtol=1e-5)


def _engines(models, jax_side, spec, kw, draft=None, draft_cfg=None):
    (jp, jd), (tp, td) = models
    if jax_side:
        extra = dict(draft_params=draft or jd, draft_cfg=draft_cfg or JDRAFT,
                     spec_tokens=spec) if spec else {}
        return JaxEngine(jp, JCFG, **kw, **extra)
    extra = dict(draft_params=draft or td, draft_cfg=draft_cfg or TDRAFT,
                 spec_tokens=spec) if spec else {}
    return Engine(tp, TCFG, device="cpu", **kw, **extra)


def _run(eng, prompts, new):
    reqs = [eng.submit(p, new) for p in prompts]
    eng.run()
    return [r.generated for r in reqs], [r.logprobs for r in reqs]


def test_speculative_engine_matches_greedy_and_jax(models):
    prompts = [[1, 2, 3], [9] * 11, [7, 8, 5, 3]]
    kw = dict(num_pages=48, page_size=8, max_seqs=4, pages_per_seq=8)
    eng = _engines(models, False, 3, kw)
    gen, lps = _run(eng, prompts, 7)
    assert eng.sched.allocator.free_pages == 47
    plain, plain_lps = _run(_engines(models, False, 0, kw), prompts, 7)
    assert gen == plain
    np.testing.assert_allclose(np.concatenate(lps), np.concatenate(plain_lps),
                               atol=1e-4)
    jeng = _engines(models, True, 3, kw)
    jgen, _ = _run(jeng, prompts, 7)
    assert gen == jgen
    assert eng.stats.spec_proposed == jeng.stats.spec_proposed > 0
    assert eng.stats.spec_accepted == jeng.stats.spec_accepted


def test_self_draft_accepts_everything(models):
    _, (tp, _) = models
    eng = Engine(tp, TCFG, device="cpu", num_pages=48, page_size=8,
                 max_seqs=2, pages_per_seq=8, draft_params=tp, draft_cfg=TCFG,
                 spec_tokens=4)
    req = eng.submit([1, 2, 3], 9)
    eng.run()
    assert len(req.generated) == 9
    assert eng.stats.spec_acceptance == 1.0, eng.stats


def test_speculative_at_table_capacity_matches_greedy(models):
    # capacity 4 pages x 8 = 32 = prompt 20 + 12 new: late steps have less
    # headroom than spec_tokens, and the span must not clamp into the
    # request's own live last page
    prompt = list(np.random.RandomState(11).randint(0, 64, 20))
    kw = dict(num_pages=16, page_size=8, max_seqs=2, pages_per_seq=4)
    gen, _ = _run(_engines(models, False, 4, kw), [prompt], 12)
    plain, _ = _run(_engines(models, False, 0, kw), [prompt], 12)
    assert gen == plain


def test_all_features_combined_match_greedy(models):
    shared = list(np.random.RandomState(5).randint(0, 64, 18))
    prompts = [shared + [3], shared + [7, 1], [2, 4, 6]]
    base = dict(num_pages=64, page_size=8, max_seqs=4, pages_per_seq=8,
                quant_dtype="int8")
    eng = _engines(models, False, 3,
                   dict(base, prefix_cache=True, prefill_chunk=16))
    gen, _ = _run(eng, prompts, 6)
    assert eng.sched.allocator.free_pages + len(eng.sched.prefix.pages) == 63
    plain, _ = _run(_engines(models, False, 0, base), prompts, 6)
    assert gen == plain


class _JaxNoise:
    """mfa_tpu's Engine's key chain (serve/engine.py: the seed key at :135,
    a split for each _sample, one for the draft burst at :903 whose step i
    folds in i, one for the acceptance at :917, which splits it into the
    acceptance uniforms' key and the residual draw's), served to the
    port's draws as the uniforms they take, in the order the port's
    sampled engine draws them: each _sample's, the draft burst's k steps,
    then speculative_accept's u and residual noise. jax.random.gumbel(key)
    is -log(-log(uniform(key, minval=tiny))), and the port's
    gumbel_from_uniform is the same formula, so a draw sees JAX's Gumbel
    noise up to the last ulp of torch's log against XLA's."""

    TINY = float(np.finfo(np.float32).tiny)

    def __init__(self, seed):
        self.key = jax.random.key(seed)
        self.burst_key, self.burst_step, self.residual_key = None, 0, None

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    @staticmethod
    def _u(key, shape, lo):
        return torch.from_numpy(np.array(jax.random.uniform(
            key, tuple(shape), minval=lo, maxval=1.0)))

    def engine_sample(self, shape, generator, device, out=None):
        assert out is None
        return self._u(self._split(), shape, self.TINY)

    def start_burst(self):
        self.burst_key, self.burst_step = self._split(), 0

    def burst(self, shape, generator, device, out=None):
        assert out is None and self.burst_key is not None
        key = jax.random.fold_in(self.burst_key, self.burst_step)
        self.burst_step += 1
        return self._u(key, shape, self.TINY)

    def accept(self, shape, generator, device, out=None):
        assert out is None
        if self.residual_key is None:  # the acceptance tests' uniforms
            ku, self.residual_key = jax.random.split(self._split())
            return self._u(ku, shape, 0.0)
        key, self.residual_key = self.residual_key, None
        return self._u(key, shape, self.TINY)


def _serve_jax_noise(monkeypatch, seed):
    from mfa_tpu_torch.serve import engine as te
    from mfa_tpu_torch.serve import sampling as ts

    noise = _JaxNoise(seed)
    burst = tl.decode_burst

    def decode_burst(*args, **kw):
        noise.start_burst()
        return burst(*args, **kw)

    monkeypatch.setattr(tl, "decode_burst", decode_burst)
    monkeypatch.setattr(tl, "uniform_noise", noise.burst)
    monkeypatch.setattr(te, "uniform_noise", noise.engine_sample)
    monkeypatch.setattr(ts, "uniform_noise", noise.accept)


SAMPLED = dict(temperature=0.8, top_p=0.95)


@pytest.mark.parametrize("features", ["stepwise", "prefix_chunks"])
def test_sampled_speculative_engine_matches_jax(models, monkeypatch, features):
    """The sampled speculative engine under mfa_tpu's noise: the same tokens
    as mfa_tpu's Engine, logprobs within 1e-3 (tests/test_torch_sampling.py
    holds the penalty engine so), the same proposals and acceptances."""
    from mfa_tpu.serve.sampling import SamplingParams as JaxSamplingParams

    kw = dict(num_pages=64, page_size=8, max_seqs=4, pages_per_seq=8)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [4, 4, 2, 7, 1, 3]]
    if features == "prefix_chunks":
        shared = list(np.random.RandomState(5).randint(0, 64, 18))
        prompts = [shared + [3], shared + [7, 1], [2, 4, 6]]
        kw.update(prefix_cache=True, prefill_chunk=16)
    jeng = _engines(models, True, 3, dict(kw, sampling=JaxSamplingParams(**SAMPLED),
                                          seed=7))
    jgen, jlps = _run(jeng, prompts, 10)
    _serve_jax_noise(monkeypatch, 7)
    eng = _engines(models, False, 3, dict(kw, sampling=SamplingParams(**SAMPLED)))
    gen, lps = _run(eng, prompts, 10)
    assert gen == jgen
    np.testing.assert_allclose(np.concatenate(lps), np.concatenate(jlps), atol=1e-3)
    assert eng.stats.spec_proposed == jeng.stats.spec_proposed > 0
    assert eng.stats.spec_accepted == jeng.stats.spec_accepted
    assert 0 < eng.stats.spec_accepted < eng.stats.spec_proposed
    assert eng.sched.allocator.free_pages + (
        len(eng.sched.prefix.pages) if eng.sched.prefix else 0) == 63


def test_sampled_speculative_engine_runs(models):
    (_, _), (tp, td) = models
    eng = Engine(tp, TCFG, device="cpu", num_pages=64, page_size=8,
                 max_seqs=2, pages_per_seq=8, draft_params=td,
                 draft_cfg=TDRAFT, spec_tokens=3,
                 sampling=SamplingParams(temperature=0.8, top_p=0.95))
    reqs = [eng.submit([1, 2, 3, 4, 5], 8), eng.submit([9, 8, 7], 6)]
    eng.run()
    for r, n in zip(reqs, (8, 6)):
        assert len(r.generated) == n == len(r.logprobs)
        assert all(np.isfinite(r.logprobs))
        assert all(0 <= t < TCFG.vocab_size for t in r.generated)
    assert eng.stats.spec_proposed > 0
    assert 0.0 <= eng.stats.spec_acceptance <= 1.0
    assert eng.sched.allocator.free_pages == 63


def test_speculative_recover_rebuilds_both_caches(models):
    """recover() mid-run drops the speculative graphs, rebuilds the target's
    and the draft's caches and requeues; the output is still plain greedy."""
    prompts = [[1, 2, 3], [9] * 11]
    kw = dict(num_pages=48, page_size=8, max_seqs=4, pages_per_seq=8)
    eng = _engines(models, False, 3, kw)
    reqs = [eng.submit(p, 20) for p in prompts]
    eng.step_speculative()
    assert not any(r.done for r in reqs)
    old = (eng.cache, eng.draft_cache)
    assert eng.recover() == 2
    assert eng.cache is not old[0] and eng.draft_cache is not old[1]
    assert not eng.spec_graphs.buckets
    eng.run()
    plain, _ = _run(_engines(models, False, 0, kw), prompts, 20)
    assert [r.generated for r in reqs] == plain
    assert eng.sched.allocator.free_pages == 47
