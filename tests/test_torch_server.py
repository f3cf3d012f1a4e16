"""The port's HTTP front end (mfa_tpu_torch/serve/server.py) on the CPU: the
protocol tests of tests/test_server.py over the port's server, parity with
mfa_tpu's server on the same fp32 weights (token ids equal, logprobs within
1e-4, plain, streamed and with a stop sequence), stop sequences and eos,
bad requests, and the failure path (a step that raises once: a 500 and an
SSE error event, the engine's bookkeeping emptied, the next request again
equal to a direct engine's). Real ThreadingHTTPServers on ephemeral ports,
driven with urllib."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.models import llama as jl
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu.serve.server import make_server as jax_make_server
from mfa_tpu_torch.models import llama as tl
from mfa_tpu_torch.serve.engine import Engine, EngineStats
from mfa_tpu_torch.serve.server import _finish_reason, make_server
from tests.jax_maps import release_jax_code  # noqa: F401

KW = dict(num_pages=64, page_size=8, max_seqs=4, pages_per_seq=8)
JCFG = jl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(vocab=64, dim=128, layers=2, heads=2, kv_heads=1,
                           ffn=128, dtype=torch.float32)


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.loop.close()
    httpd.server_close()


@pytest.fixture(scope="module")
def server():
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, seed=0, device="cpu")
    eng = Engine(params, cfg, device="cpu", **KW)
    httpd = make_server(eng, port=0, burst=4)  # ephemeral port
    yield _start(httpd), cfg, params
    _stop(httpd)


def _post(base, path, obj, timeout=600):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def _stream(base, obj, timeout=600):
    """POST with stream: true -> (token ids, logprobs, events, error events)."""
    req = urllib.request.Request(
        base + "/v1/completions",
        data=json.dumps(dict(obj, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    tokens, lps, events, errors = [], [], 0, []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":  # OpenAI protocol literal
                break
            evt = json.loads(payload)
            if "error" in evt:
                errors.append(evt["error"]["message"])
                continue
            tokens.extend(evt["choices"][0]["token_ids"])
            lps.extend(evt["choices"][0]["logprobs"]["token_logprobs"])
            events += 1
    return tokens, lps, events, errors


def _direct(params, cfg, prompt, n, **kw):
    eng = Engine(params, cfg, device="cpu", **KW)
    req = eng.submit(prompt, n, **kw)
    eng.run(burst=4)
    return req.generated


def test_health_and_models(server):
    base, _, _ = server
    assert _get(base, "/health")["status"] == "ok"
    models = _get(base, "/v1/models")
    assert models["data"][0]["id"] == "mfa-tpu"
    stats = _get(base, "/stats")
    assert set(stats) == {"prefill_tokens", "decode_tokens", "steps",
                          "recoveries", "spec_acceptance"}


def test_completion_matches_direct_engine(server):
    base, cfg, params = server
    prompt = [1, 2, 3, 4, 5]
    resp = _post(base, "/v1/completions", {"prompt": prompt, "max_tokens": 8})
    toks = resp["choices"][0]["token_ids"]
    assert len(toks) == 8
    assert resp["usage"]["completion_tokens"] == 8
    assert resp["choices"][0]["finish_reason"] == "length"
    # a fresh direct engine gives the same greedy continuation
    assert toks == _direct(params, cfg, prompt, 8)


def test_streaming_collects_same_tokens(server):
    base, _, _ = server
    prompt = [7, 8, 9]
    plain = _post(base, "/v1/completions",
                  {"prompt": prompt, "max_tokens": 6})["choices"][0]["token_ids"]
    tokens, lps, events, errors = _stream(base, {"prompt": prompt,
                                                 "max_tokens": 6})
    assert tokens == plain and not errors
    assert events >= 1 and len(lps) == len(tokens)


def test_concurrent_requests_batch(server):
    base, _, _ = server
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 10]]
    results = {}

    def worker(i, p):
        results[i] = _post(base, "/v1/completions",
                           {"prompt": p, "max_tokens": 5})

    threads = [threading.Thread(target=worker, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert set(results) == {0, 1, 2}
    for i, p in enumerate(prompts):
        # every request completes on its own with the right length
        assert len(results[i]["choices"][0]["token_ids"]) == 5
        assert results[i]["usage"]["prompt_tokens"] == len(p)


def test_bad_requests(server):
    base, _, _ = server
    for body, frag in [
        ({"prompt": "hello", "max_tokens": 4}, "tokenizer"),
        ({"prompt": [], "max_tokens": 4}, "non-empty"),
        ({"prompt": [1, 2], "max_tokens": 0}, "max_tokens"),
        ({"prompt": [1, 2], "max_tokens": 10_000}, "longer"),
    ]:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/v1/completions", body)
        assert ei.value.code == 400
        assert frag in json.loads(ei.value.read())["error"]["message"]


def test_logprobs_in_response(server):
    base, _, _ = server
    resp = _post(base, "/v1/completions",
                 {"prompt": [2, 4, 6], "max_tokens": 5, "logprobs": 1})
    ch = resp["choices"][0]
    lps = ch["logprobs"]["token_logprobs"]
    assert len(lps) == len(ch["token_ids"]) == 5
    assert all(isinstance(x, float) and x <= 0.0 for x in lps)


@pytest.mark.parametrize("body, code, frag", [
    ({"prompt": [1, 2], "max_tokens": 2, "temperature": "hot"}, 400,
     "bad sampling parameter"),
    ({"prompt": [1, 2], "max_tokens": 2, "top_p": [0.5]}, 400,
     "bad sampling parameter"),
    ({"prompt": [1, 2], "max_tokens": 2, "stop": "end"}, 400,
     "stop must be a list"),
    ({"prompt": [1, 2], "max_tokens": 2, "stop": [[1, "a"]]}, 400,
     "stop must contain token-id lists"),
    ({"prompt": [1, 2.5], "max_tokens": 2}, 400, "non-empty list"),
])
def test_bad_request_bodies(server, body, code, frag):
    base, _, _ = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base, "/v1/completions", body)
    assert ei.value.code == code
    assert frag in json.loads(ei.value.read())["error"]["message"]


def test_bad_json_and_routes(server):
    base, _, _ = server
    req = urllib.request.Request(base + "/v1/completions", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=60)
    assert ei.value.code == 400
    assert "bad JSON body" in json.loads(ei.value.read())["error"]["message"]
    for call in (lambda: _get(base, "/nope"),
                 lambda: _post(base, "/v2/completions", {"prompt": [1]})):
        with pytest.raises(urllib.error.HTTPError) as ei:
            call()
        assert ei.value.code == 404


def test_per_request_sampling_runs(server):
    """Sampling knobs reach the engine as a per-request SamplingParams:
    the completion has its length and finite logprobs; temperature 0
    keeps the greedy tokens."""
    base, cfg, params = server
    prompt = [5, 6, 7, 8]
    resp = _post(base, "/v1/completions",
                 {"prompt": prompt, "max_tokens": 6, "temperature": 0.9,
                  "top_p": 0.8, "min_p": 0.01, "logprobs": 1})
    ch = resp["choices"][0]
    assert len(ch["token_ids"]) == 6
    assert all(np.isfinite(ch["logprobs"]["token_logprobs"]))
    greedy = _post(base, "/v1/completions",
                   {"prompt": prompt, "max_tokens": 6, "temperature": 0.0,
                    "repetition_penalty": 1.0})
    assert greedy["choices"][0]["token_ids"] == _direct(params, cfg, prompt, 6)


def _ends_at(gen, seq):
    """The prefix of gen that ends with the first occurrence of seq."""
    for i in range(len(seq), len(gen) + 1):
        if gen[i - len(seq):i] == seq:
            return gen[:i]
    return gen


@pytest.mark.parametrize("kind", ["stop_flat", "stop_lists", "eos"])
def test_stop_sequences_and_eos(server, kind):
    base, cfg, params = server
    prompt = [3, 1, 4, 1, 5]
    full = _direct(params, cfg, prompt, 10)
    body = {"prompt": prompt, "max_tokens": 10}
    if kind == "stop_flat":  # one stop sequence as a flat list
        seq = full[3:5]
        body["stop"] = seq
    elif kind == "stop_lists":  # a list of stop sequences, one never seen
        seq = full[4:6]
        body["stop"] = [[63, 63, 63, 63, 63, 63, 63], seq]
    else:
        seq = full[2:3]
        body["eos_token"] = seq[0]
    want = _ends_at(full, seq)
    ch = _post(base, "/v1/completions", body)["choices"][0]
    assert ch["token_ids"] == want
    assert len(want) < 10 and ch["finish_reason"] == "stop"
    streamed, _, _, errors = _stream(base, body)
    assert streamed == want and not errors


def test_finish_reason_rule():
    assert _finish_reason([1, 2, 3], 3, None) == "length"
    assert _finish_reason([1, 2, 3], 5, 3) == "stop"
    assert _finish_reason([1, 2, 3], 3, None, [[2, 3]]) == "stop"
    assert _finish_reason([1, 2], 5, None, [[9]]) == "stop"  # ended early


@pytest.fixture(scope="module")
def pair():
    """mfa_tpu's server and the port's on the same fp32 weights."""
    jp = jl.init_params(jax.random.key(3), JCFG)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    jhttpd = jax_make_server(JaxEngine(jp, JCFG, **KW), port=0, burst=4)
    thttpd = make_server(Engine(tp, TCFG, device="cpu", **KW), port=0,
                         burst=4)
    yield _start(jhttpd), _start(thttpd)
    _stop(jhttpd)
    _stop(thttpd)


@pytest.mark.parametrize("case", ["plain", "stream", "stop"])
def test_server_matches_mfa_tpu(pair, case):
    jbase, tbase = pair
    body = {"prompt": [11, 3, 42, 7, 19, 5], "max_tokens": 7, "logprobs": 1}
    ref = _post(jbase, "/v1/completions", body)["choices"][0]
    if case == "stop":
        body["stop"] = ref["token_ids"][2:4]
        ref = _post(jbase, "/v1/completions", body)["choices"][0]
        assert ref["finish_reason"] == "stop"
    if case == "stream":
        toks, lps, _, errors = _stream(tbase, body)
        assert not errors
        jtoks, jlps, _, _ = _stream(jbase, body)
        assert jtoks == ref["token_ids"]
        got = {"token_ids": toks, "logprobs": {"token_logprobs": lps},
               "finish_reason": ref["finish_reason"]}
    else:
        got = _post(tbase, "/v1/completions", body)["choices"][0]
    assert got["token_ids"] == ref["token_ids"]
    assert got["finish_reason"] == ref["finish_reason"]
    np.testing.assert_allclose(got["logprobs"]["token_logprobs"],
                               ref["logprobs"]["token_logprobs"], atol=1e-4)


def test_engine_abandon_and_decode_rate():
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, seed=0, device="cpu")
    eng = Engine(params, cfg, device="cpu", **KW)
    a = eng.submit([1, 2, 3], 4)
    b = eng.submit([4, 5], 4)
    eng.abandon([a.uid, 999])  # unknown uids are ignored
    assert set(eng._all_reqs) == set(eng._stream_pos) == {b.uid}
    stats = eng.run(burst=4)
    assert set(eng.poll()) == {b.uid}  # the abandoned request never streams
    assert stats.decode_tokens_per_s == stats.decode_tokens / stats.wall_s > 0
    assert EngineStats().decode_tokens_per_s == 0.0


def test_engine_failure_fails_in_flight_and_recovers():
    """A step that raises once while two requests are in flight: the plain
    client gets the 500 body, the streamed one the SSE error event; the
    engine recovered once, abandoned both, returned every page, and the
    next request equals a direct engine's tokens."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, seed=0, device="cpu")
    eng = Engine(params, cfg, device="cpu", **KW)
    free0 = eng.sched.allocator.free_pages
    httpd = make_server(eng, port=0, burst=4)
    loop = httpd.loop
    base = _start(httpd)
    orig, fired = eng.step_pipelined, []

    def flaky(n):
        if not fired:
            if len(loop._streams) < 2:  # wait for the second client
                time.sleep(0.02)
                return orig(n)
            fired.append(True)
            raise RuntimeError("injected step failure")
        return orig(n)

    eng.step_pipelined = flaky
    out = {}

    def plain():
        try:
            _post(base, "/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 40})
        except urllib.error.HTTPError as e:
            out["plain"] = (e.code, json.loads(e.read())["error"]["message"])

    def streamed():
        out["stream"] = _stream(base, {"prompt": [4, 5, 6], "max_tokens": 40})

    try:
        threads = [threading.Thread(target=plain), threading.Thread(target=streamed)]
        for t in threads:
            t.start()
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert out["plain"][0] == 500
        assert out["plain"][1] == "engine failure: injected step failure"
        assert out["stream"][3] == ["engine failure: injected step failure"]
        assert fired and eng.stats.recoveries == 1
        assert not eng._all_reqs and not eng._stream_pos
        assert not eng.sched.active and not eng.sched.waiting
        assert eng.sched.allocator.free_pages == free0
        prompt = [9, 8, 7, 6]
        resp = _post(base, "/v1/completions", {"prompt": prompt, "max_tokens": 6})
        assert resp["choices"][0]["token_ids"] == _direct(params, cfg, prompt, 6)
    finally:
        _stop(httpd)


def test_listen_backlog_holds_a_burst_of_clients():
    """socketserver's backlog of 5 drops a burst of connections while the
    loop thread holds the interpreter lock (each dropped client retries
    after the kernel's 1 s SYN timeout); the port listens with 128."""
    cfg = tl.LlamaConfig.tiny()
    eng = Engine(tl.init_params(cfg, seed=0, device="cpu"), cfg, device="cpu",
                 **KW)
    httpd = make_server(eng, port=0)
    try:
        assert httpd.request_queue_size >= 64
    finally:
        httpd.loop.close()
        httpd.server_close()


def test_many_clients_under_a_short_switch_interval(server):
    """32 clients at once (more than the engine's 4 slots and the box's
    cores), half streamed, with the interpreter switching threads every
    10 us: every client gets its own full completion, equal to the same
    prompt's lone answer."""
    import sys

    base, cfg, params = server
    prompts = [[1 + i % 7, 2 + i % 5, 3] for i in range(32)]
    want = {tuple(p): _post(base, "/v1/completions",
                            {"prompt": p, "max_tokens": 4})["choices"][0]["token_ids"]
            for p in set(map(tuple, prompts))}
    results = {}

    def worker(i):
        body = {"prompt": prompts[i], "max_tokens": 4}
        if i % 2:
            results[i] = _stream(base, body, timeout=120)[0]
        else:
            results[i] = _post(base, "/v1/completions", body,
                               timeout=120)["choices"][0]["token_ids"]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert all(results[i] == want[tuple(p)] for i, p in enumerate(prompts))
