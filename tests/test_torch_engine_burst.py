"""Decode bursts, the pipelined loop and recovery of the port's engine
(plain kernels on the CPU, where decode runs eagerly: there is no graph to
capture) against mfa_tpu's Engine and decode_burst on the same tiny fp32
model (the mirror of tests/test_serve_pipeline.py and
test_serve_aux.py::test_engine_recovery_preserves_output): greedy tokens
identical, logprobs within 1e-3, pages recycled, nothing left in flight."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine
from tests.jax_maps import release_jax_code  # noqa: F401

JCFG = jl.LlamaConfig.tiny(vocab=64, dim=64, layers=2, heads=4, kv_heads=2,
                           ffn=128, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=64, layers=2, heads=4, kv_heads=2,
                           ffn=128, dtype=torch.float32)
KW = dict(num_pages=64, page_size=8, max_seqs=4, pages_per_seq=8)
PROMPTS = [[1, 2, 3], [5] * 11, [7, 8], [9, 10, 11, 12, 13]]


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.key(0), JCFG)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _serve(make, prompts, budgets, run_kw, eos=None, stop=None, **kw):
    """Run an engine over the prompts; check recycling; -> requests."""
    kw = {**KW, **kw}
    eng = make(**kw)
    reqs = [eng.submit(p, n, eos_token=eos, stop=stop)
            for p, n in zip(prompts, budgets)]
    stats = eng.run(**run_kw)
    assert not eng.sched.active and not eng.sched.waiting
    assert eng.sched.allocator.free_pages == kw["num_pages"] - 1
    assert all(r.inflight == 0 for r in reqs)
    return reqs, stats


@pytest.fixture(scope="module")
def jax_runs(params):
    """mfa_tpu's pipelined run(burst=4) per scenario, run once and shared by
    the port's pipelined and synchronous cases (mfa_tpu's own tests hold
    its two loops token-identical; its interpret-mode runs are the slow
    part of this file)."""
    cache = {}

    def run(key, prompts, budgets, **kw):
        if key not in cache:
            cache[key], _ = _serve(_jax(params[0]), prompts, budgets,
                                   dict(burst=4, pipeline=True), **kw)
        return cache[key]

    return run


def _port(tp):
    return lambda **kw: Engine(tp, TCFG, device="cpu", **kw)


def _jax(jp):
    return lambda **kw: JaxEngine(jp, JCFG, **kw)


def _same(reqs, refs):
    for r, ref in zip(reqs, refs):
        assert r.generated == ref.generated, (r.uid, r.generated,
                                              ref.generated)
        np.testing.assert_allclose(r.logprobs, ref.logprobs, atol=1e-3)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_burst_matches_jax(params, quant):
    jp, tp = params
    prompts = [list(range(1, 6)), list(range(20, 31))]
    pages, slots = [[1, 2, 3], [4, 5, 6]], [0, 1]
    jc = jl.build_kv_caches(JCFG, 16, 8, 4, 4, quant)
    jc, jlog = jl.prefill_batch(jp, JCFG, jc, slots, pages, prompts)
    first = np.argmax(np.asarray(jlog), -1)
    jc, jt, jlp = jl.decode_burst(jp, JCFG, jc, jnp.asarray(slots, jnp.int32),
                                  jnp.asarray(first, jnp.int32), 5)
    tc = tl.build_kv_caches(TCFG, 16, 8, 4, 4, quant, device="cpu")
    tc, tlog = tl.prefill_batch(tp, TCFG, tc, slots, pages, prompts)
    assert np.array_equal(tlog.argmax(-1).numpy(), first)
    tc, tt, tlp = tl.decode_burst(tp, TCFG, tc, slots, first, 5)
    assert tt.shape == (5, 2) and tlp.dtype == torch.float32
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-3)
    assert tc.lengths[:2].tolist() == [5 + 5, 11 + 5]


@pytest.mark.parametrize("pipeline", [False, True])
def test_bursts_match_jax_and_stepwise(params, pipeline):
    jp, tp = params
    budgets = [9] * len(PROMPTS)
    run_kw = dict(burst=4, pipeline=pipeline)
    got, stats = _serve(_port(tp), PROMPTS, budgets, run_kw)
    ref, _ = _serve(_jax(jp), PROMPTS, budgets, run_kw)
    _same(got, ref)
    step, _ = _serve(_port(tp), PROMPTS, budgets, {})
    _same(got, step)
    # 8 decode steps a request: two bursts of 4, one readback each
    assert stats.readbacks == 2 and stats.steps == 8
    assert stats.decode_tokens == 9 * len(PROMPTS)


@pytest.mark.parametrize("pipeline", [False, True])
def test_admission_waves_match_jax(params, jax_runs, pipeline):
    """More requests than slots with staggered budgets: finishes free
    slots mid-run and new admissions join the row set while a burst is in
    flight (the slot-indexed token map of the pipelined loop)."""
    _, tp = params
    rs = np.random.RandomState(3)
    prompts = [list(rs.randint(1, 64, 3 + i)) for i in range(5)]
    budgets = [4 + (i % 3) * 5 for i in range(5)]
    got, _ = _serve(_port(tp), prompts, budgets,
                    dict(burst=4, pipeline=pipeline), max_seqs=2)
    _same(got, jax_runs("waves", prompts, budgets, max_seqs=2))


@pytest.mark.parametrize("pipeline", [False, True])
def test_eos_and_stop_midburst(params, jax_runs, pipeline):
    _, tp = params
    prompt = [3, 1, 4, 1, 5]
    (probe,), _ = _serve(_port(tp), [prompt], [9], {})
    run_kw = dict(burst=4, pipeline=pipeline)
    eos = probe.generated[2]  # the third token: mid-way through a burst
    (got,), _ = _serve(_port(tp), [prompt], [9], run_kw, eos=eos)
    _same([got], jax_runs("eos", [prompt], [9], eos=eos))
    assert got.generated == probe.generated[:probe.generated.index(eos) + 1]
    stop = [probe.generated[3:6]]  # ends inside the second burst
    (got,), _ = _serve(_port(tp), [prompt], [9], run_kw, stop=stop)
    _same([got], jax_runs("stop", [prompt], [9], stop=stop))
    assert got.generated == probe.generated[:6]


@pytest.mark.parametrize("pipeline", [False, True])
def test_chunked_prefix_engine_under_bursts(params, pipeline):
    """Chunked prefill (chunks of 16) and the prefix cache under bursts:
    token-identical to the same engine's stepwise run() (which
    test_torch_chunked_prefill.py holds to mfa_tpu's)."""
    _, tp = params
    rs = np.random.RandomState(5)
    system = list(rs.randint(1, 64, 24))
    prompts = [list(rs.randint(1, 64, 40)), system + [1, 2, 3],
               list(rs.randint(1, 64, 5)), system + [4, 5]]
    budgets = [7, 6, 9, 5]
    kw = dict(prefill_chunk=16, prefix_cache=True)

    def run(run_kw):
        eng = Engine(tp, TCFG, device="cpu", **KW, **kw)
        reqs = [eng.submit(p, n) for p, n in zip(prompts[:3], budgets)]
        while not reqs[1].generated:  # the system prompt's pages cached
            eng.step()
        reqs.append(eng.submit(prompts[3], budgets[3]))
        eng.run(**run_kw)
        retained = len(eng.sched.prefix.pages)
        assert eng.sched.allocator.free_pages + retained == KW["num_pages"] - 1
        assert all(r.inflight == 0 for r in reqs)
        return reqs

    got = run(dict(burst=4, pipeline=pipeline))
    _same(got, run({}))
    assert all(len(r.generated) == n for r, n in zip(got, budgets))


def test_pipeline_page_pressure_preempts(params):
    """Page exhaustion under the pipelined loop drains the pipeline and
    falls back to step_burst, which preempts; the output equals the port's
    stepwise run() on the same pages. (Not mfa_tpu's step_burst: it takes
    its batch before mapping pages, so a request preempted there still
    decodes in that burst — the stale batch the port's step() repaired.)"""
    _, tp = params
    rs = np.random.RandomState(11)
    prompts = [list(rs.randint(1, 64, 8)) for _ in range(2)]
    kw = dict(num_pages=8, max_seqs=2, pages_per_seq=4)
    got, stats = _serve(_port(tp), prompts, [20, 20],
                        dict(burst=4, pipeline=True), **kw)
    assert stats.preemptions >= 1
    step, step_stats = _serve(_port(tp), prompts, [20, 20], {}, **kw)
    assert step_stats.preemptions >= 1
    _same(got, step)


@pytest.mark.parametrize("run_kw", [{}, dict(burst=4, pipeline=True)],
                         ids=["stepwise", "pipelined"])
def test_recovery_preserves_output(params, monkeypatch, run_kw):
    """An injected decode failure raises without a retry budget; with one,
    recover() requeues the requests and the output is unchanged."""
    _, tp = params
    budgets = [6, 9, 4]
    want, _ = _serve(_port(tp), PROMPTS[:3], budgets, run_kw)
    real = tl.decode_step
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected device failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(tl, "decode_step", flaky)
    eng = Engine(tp, TCFG, device="cpu", **KW)
    for p, n in zip(PROMPTS[:3], budgets):
        eng.submit(p, n)
    with pytest.raises(RuntimeError, match="injected"):
        eng.run(max_retries=0, **run_kw)
    calls["n"] = 0
    got, stats = _serve(_port(tp), PROMPTS[:3], budgets,
                        dict(max_retries=1, **run_kw))
    assert stats.recoveries == 1
    _same(got, want)
