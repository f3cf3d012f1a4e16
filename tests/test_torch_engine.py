"""The port's serving engine (plain kernels on CPU) against mfa_tpu's
Engine on the same tiny fp32 model: three mixed-length requests give
token-identical greedy output, and every page returns to the allocator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine
from mfa_tpu_torch.serve.sampling import SamplingParams

JCFG = jl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=torch.float32)
REQUESTS = [(5, 6), (12, 3), (19, 5)]  # (prompt length, new tokens)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.key(1), JCFG)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _submit(eng):
    rng = np.random.RandomState(7)
    return [eng.submit([int(t) for t in rng.randint(0, 64, n)], new)
            for n, new in REQUESTS]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_tokens_match_jax(params, quant):
    jp, tp = params
    kw = dict(num_pages=16, page_size=8, max_seqs=4, pages_per_seq=4,
              quant_dtype=quant)
    jeng = JaxEngine(jp, JCFG, **kw)
    jreqs = _submit(jeng)
    jeng.run()
    eng = Engine(tp, TCFG, device="cpu", **kw)
    free0 = eng.sched.allocator.free_pages
    reqs = _submit(eng)
    stats = eng.run()
    for r, jr in zip(reqs, jreqs):
        assert len(r.generated) == r.max_new_tokens
        assert r.generated == jr.generated, (r.uid, r.generated, jr.generated)
        np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=1e-3)
    assert eng.sched.allocator.free_pages == free0 == 15
    assert not eng.sched.active and not eng.sched.waiting
    assert stats.decode_tokens == sum(n for _, n in REQUESTS)
    assert stats.steps == max(n for _, n in REQUESTS) - 1


def test_engine_streams_and_preempts(params):
    _, tp = params
    # 5 usable pages of 4 rows: two requests fit at admission but not
    # through decode, so the youngest is preempted and re-prefilled
    eng = Engine(tp, TCFG, num_pages=6, page_size=4, max_seqs=2,
                 pages_per_seq=4, device="cpu")
    a = eng.submit(list(range(1, 6)), 8)
    b = eng.submit(list(range(7, 10)), 6)
    seen = {a.uid: [], b.uid: []}
    while eng.sched.has_work:
        eng.step()
        for uid, toks in eng.poll().items():
            seen[uid] += toks
    assert seen[a.uid] == a.generated and len(a.generated) == 8
    assert seen[b.uid] == b.generated and len(b.generated) == 6
    assert eng.stats.preemptions >= 1
    assert eng.sched.allocator.free_pages == 5
    solo = Engine(tp, TCFG, num_pages=16, page_size=4, max_seqs=2,
                  pages_per_seq=4, device="cpu")
    rb = solo.submit(list(range(7, 10)), 6)
    solo.run()
    assert rb.generated == b.generated  # preemption does not change output


def test_preempted_request_leaves_the_decode_batch(params):
    """At max_seqs=3 a request preempted while pages are mapped must not
    decode in that step: its slot is -1 by then, which would index the
    last slot, append a token to it and, on finishing, put -1 into the free
    slots and the release list."""
    _, tp = params
    prompts = [(list(range(1, 6)), 8), (list(range(7, 10)), 6), ([11, 12], 4)]
    eng = Engine(tp, TCFG, num_pages=6, page_size=4, max_seqs=3,
                 pages_per_seq=4, device="cpu")
    released = []
    flush = eng._flush_released

    def record_flush():
        released.extend(eng._to_release)
        flush()

    eng._flush_released = record_flush
    reqs = [eng.submit(p, n) for p, n in prompts]
    eng.run()
    assert eng.stats.preemptions >= 1
    assert sorted(eng.sched._free_slots) == list(range(3))
    assert -1 not in released and -1 not in eng._to_release
    assert eng.sched.allocator.free_pages == 5
    for req, (p, n) in zip(reqs, prompts):
        solo = Engine(tp, TCFG, num_pages=16, page_size=4, max_seqs=3,
                      pages_per_seq=4, device="cpu")
        ref = solo.submit(p, n)
        solo.run()
        assert req.generated == ref.generated, (req.uid, req.generated,
                                                ref.generated)


def test_eos_and_stop_end_generation(params):
    _, tp = params
    kw = dict(num_pages=16, page_size=8, max_seqs=4, pages_per_seq=4,
              device="cpu")
    eng = Engine(tp, TCFG, **kw)
    full = eng.submit(list(range(1, 8)), 6)
    eng.run()
    eng = Engine(tp, TCFG, **kw)
    eos = eng.submit(list(range(1, 8)), 6, eos_token=full.generated[2])
    stop = eng.submit(list(range(1, 8)), 6, stop=[full.generated[1:3]])
    eng.run()
    first = full.generated.index(full.generated[2])
    assert eos.generated == full.generated[:first + 1]
    assert stop.generated == full.generated[:3]
    assert eng.sched.allocator.free_pages == 15


def test_unported_engine_options_raise(params):
    _, tp = params
    with pytest.raises(NotImplementedError):
        Engine(tp, TCFG, device="cpu", draft_params=tp)
    with pytest.raises(NotImplementedError):
        Engine(tp, TCFG, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        SamplingParams(temperature=0.7)
