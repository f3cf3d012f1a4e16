"""HTTP serving front end (counterpart of mfa_tpu/serve/server.py): OpenAI-
style completions over the Engine, with the stdlib only (http.server,
queue, threading).

- POST /v1/completions (and /completions): {"prompt": [token ids] | "text",
  "max_tokens", "stream": bool, "eos_token": optional int, "stop": token-id
  list(s), "logprobs", and per-request "temperature", "top_p", "min_p",
  "repetition_penalty"}. With no tokenizer configured, prompts must be
  token-id lists and responses carry `token_ids`; inject a tokenizer (any
  object with encode(str) -> ids and decode(ids) -> str) to accept and
  return text. "stream": true answers with server-sent events in chunked
  encoding, ended by the literal `data: [DONE]`.
- GET /v1/models, /health, /stats: discovery, liveness, EngineStats.

Threading model: the Engine is not thread-safe (host-side cache metadata,
decode graphs), so one loop thread owns it. HTTP handler threads touch only
two queue boundaries: a submit queue in, and a per-request chunk queue out
(fed from Engine.poll()'s deltas); they touch no tensor, so no CUDA call
from them can break a graph capture on the loop thread (serve/graphs.py
captures in the "global" mode). Torch keeps the current CUDA device and
the grad mode per thread, so the loop thread enters the engine's device
and no_grad itself. Requests admitted while others decode join the running
batch: continuous batching over HTTP. An engine failure is recovered
(Engine.recover) and fails the requests in flight, and the loop serves on.
"""

from __future__ import annotations

import contextlib
import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

import torch

from mfa_tpu_torch.serve.sampling import SamplingParams

_log = logging.getLogger(__name__)
_DONE = object()  # stream sentinel


class _Err:
    """Stream error sentinel: delivered instead of a token chunk when the
    request failed (bad submit or engine failure)."""

    def __init__(self, msg: str, code: int = 500):
        self.msg = msg
        self.code = code


class ServingLoop:
    """Owns the Engine on one thread; bridges it to concurrent callers."""

    def __init__(self, engine, burst: int = 8, model_name: str = "mfa-tpu",
                 pipeline: bool = True):
        """pipeline: keep up to Engine.PIPELINE_DEPTH decode bursts in
        flight (Engine.step_pipelined: a burst's readback overlaps the next
        burst on the card) at the cost of one extra burst of streaming
        latency per token batch; else Engine.step_burst."""
        self.engine = engine
        self.burst = burst
        self.pipeline = pipeline
        self.model_name = model_name
        self._submit_q: "queue.Queue" = queue.Queue()
        self._streams: Dict[int, queue.Queue] = {}
        self._reqs: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_token: Optional[int] = None,
               stop: Optional[List[List[int]]] = None,
               sampling=None) -> "queue.Queue":
        """Thread-safe submit; returns the queue this request's token
        chunks arrive on (terminated by the _DONE sentinel)."""
        out: "queue.Queue" = queue.Queue()
        self._submit_q.put((prompt, max_new_tokens, eos_token, stop,
                            sampling, out))
        return out

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def _admit_one(self, item) -> bool:
        prompt, mnt, eos, stop, sampling, out = item
        try:
            req = self.engine.submit(prompt, mnt, eos_token=eos,
                                     stop=stop, sampling=sampling)
        except Exception as e:  # reject THIS request, keep serving
            out.put(_Err(str(e), code=400))
            out.put(_DONE)
            return False
        with self._lock:
            self._streams[req.uid] = out
            self._reqs[req.uid] = req
        return True

    def _admit(self):
        admitted = False
        while True:
            try:
                item = self._submit_q.get_nowait()
            except queue.Empty:
                return admitted
            admitted |= self._admit_one(item)

    def _fail_all(self, msg: str):
        """Engine failure: error out every in-flight stream; the loop
        thread stays alive for future requests."""
        with self._lock:
            streams = list(self._streams.values())
            uids = list(self._streams.keys())
            self._streams.clear()
            self._reqs.clear()
        # evict the orphans from the engine's streaming bookkeeping too —
        # they will never reach `done`, so poll() would never release them
        self.engine.abandon(uids)
        for stream in streams:
            stream.put(_Err(msg))
            stream.put(_DONE)

    def _run(self):
        dev = self.engine.device
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else \
            contextlib.nullcontext()
        with ctx, torch.no_grad():
            self._serve()

    def _serve(self):
        while not self._stop.is_set():
            self._admit()
            if not self.engine.sched.has_work:
                # idle: block briefly on the submit queue instead of
                # spinning — and admit the dequeued item DIRECTLY (a
                # get-then-put requeue would move it behind requests that
                # arrived meanwhile, breaking FIFO admission order)
                try:
                    item = self._submit_q.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._admit_one(item)
                continue
            try:
                if self.pipeline:
                    self.engine.step_pipelined(self.burst)
                else:
                    self.engine.step_burst(self.burst)
            except Exception as e:
                # a dead loop thread would hang every present and future
                # request: recover the engine and fail the in-flight ones
                _log.exception("engine step failed; recovering")
                msg = f"engine failure: {e}"
                try:
                    self.engine.recover()
                    # recover() requeues the in-flight requests, but their
                    # clients are about to be errored: drop the orphans
                    # instead of decoding them into nothing
                    self.engine.sched.waiting.clear()
                except Exception as r:
                    _log.exception("engine recovery failed")
                    msg += f"; recovery failed: {r}"
                self._fail_all(msg)
                continue
            for uid, toks in self.engine.poll().items():
                stream = self._streams.get(uid)
                if stream is None:
                    continue
                req = self._reqs[uid]
                done = len(req.generated)
                lps = req.logprobs[done - len(toks):done]
                stream.put((list(toks), [float(x) for x in lps]))
                if req.done:
                    stream.put(_DONE)
                    with self._lock:
                        self._streams.pop(uid, None)
                        self._reqs.pop(uid, None)


def _finish_reason(req_tokens: List[int], max_tokens: int,
                   eos_token: Optional[int],
                   stop: Optional[List[List[int]]] = None) -> str:
    if eos_token is not None and req_tokens and req_tokens[-1] == eos_token:
        return "stop"
    if stop and any(s and req_tokens[-len(s):] == s for s in stop):
        return "stop"
    return "length" if len(req_tokens) >= max_tokens else "stop"


class _Handler(BaseHTTPRequestHandler):
    # injected by make_server:
    loop: ServingLoop = None  # type: ignore
    encode: Optional[Callable[[str], List[int]]] = None
    decode: Optional[Callable[[List[int]], str]] = None

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # -------------- plumbing --------------

    def _json(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str):
        self._json(code, {"error": {"message": msg, "type": "invalid_request_error"}})

    # -------------- GET --------------

    def do_GET(self):
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": self.loop.model_name, "object": "model",
                 "owned_by": "mfa_tpu"}]})
        elif self.path == "/stats":
            s = self.loop.engine.stats
            self._json(200, {
                "prefill_tokens": s.prefill_tokens,
                "decode_tokens": s.decode_tokens,
                "steps": s.steps,
                "recoveries": s.recoveries,
                "spec_acceptance": s.spec_acceptance,
            })
        else:
            self._error(404, f"no route {self.path}")

    # -------------- POST --------------

    def do_POST(self):
        # drain the body FIRST: returning before reading it desyncs
        # HTTP/1.1 keep-alive (leftover bytes parse as the next request)
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n < 0:
                raise ValueError(n)
            raw = self.rfile.read(n)
        except ValueError:
            return self._error(400, "bad Content-Length")
        if self.path not in ("/v1/completions", "/completions"):
            return self._error(404, f"no route {self.path}")
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            return self._error(400, f"bad JSON body: {e}")

        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if self.encode is None:
                return self._error(
                    400, "string prompts need a tokenizer; this server was "
                         "started without one — send a list of token ids")
            prompt = self.encode(prompt)
        if not (isinstance(prompt, list)
                and all(isinstance(t, int) for t in prompt) and prompt):
            return self._error(400, "prompt must be a non-empty list of "
                                    "token ids (or a string with a tokenizer)")
        max_tokens = int(body.get("max_tokens", 16))
        if max_tokens < 1:
            return self._error(400, "max_tokens must be >= 1")
        # per-request capacity is validated by Scheduler.submit; its
        # ValueError surfaces to this caller as a 400 _Err
        eos = body.get("eos_token")
        eos = int(eos) if eos is not None else None
        stop = body.get("stop")
        if stop is not None:
            if not isinstance(stop, list):
                return self._error(400, "stop must be a list of token ids "
                                        "or a list of token-id lists")
            if stop and isinstance(stop[0], int):
                stop = [stop]
            if not all(isinstance(s, list)
                       and all(isinstance(t, int) for t in s)
                       for s in stop):
                return self._error(400, "stop must contain token-id lists")
        stream = bool(body.get("stream", False))
        sampling = None
        knobs = {k: body[k] for k in ("temperature", "top_p", "min_p",
                                      "repetition_penalty") if k in body}
        if knobs:
            d = self.loop.engine.sampling  # unspecified knobs inherit
            try:
                sampling = SamplingParams(
                    temperature=float(knobs.get("temperature",
                                                d.temperature)),
                    top_p=float(knobs.get("top_p", d.top_p)),
                    min_p=float(knobs.get("min_p", d.min_p)),
                    repetition_penalty=float(
                        knobs.get("repetition_penalty",
                                  d.repetition_penalty)),
                )
            except (TypeError, ValueError) as e:
                return self._error(400, f"bad sampling parameter: {e}")
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"

        out_q = self.loop.submit(prompt, max_tokens, eos_token=eos,
                                 stop=stop, sampling=sampling)
        if stream:
            return self._stream_response(rid, out_q)

        tokens: List[int] = []
        logprobs: List[float] = []
        while True:
            chunk = out_q.get()
            if chunk is _DONE:
                break
            if isinstance(chunk, _Err):
                out_q.get()  # consume the trailing _DONE
                return self._error(chunk.code, chunk.msg)
            toks, lps = chunk
            tokens.extend(toks)
            logprobs.extend(lps)
        choice = {
            "index": 0,
            "token_ids": tokens,
            "finish_reason": _finish_reason(tokens, max_tokens, eos, stop),
        }
        if body.get("logprobs"):
            choice["logprobs"] = {"token_logprobs": logprobs,
                                  "tokens": tokens}
        if self.decode is not None:
            choice["text"] = self.decode(tokens)
        self._json(200, {
            "id": rid, "object": "text_completion",
            "created": int(time.time()), "model": self.loop.model_name,
            "choices": [choice],
            "usage": {"prompt_tokens": len(prompt),
                      "completion_tokens": len(tokens),
                      "total_tokens": len(prompt) + len(tokens)},
        })

    def _stream_response(self, rid: str, out_q: "queue.Queue"):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send_event(obj):
            data = f"data: {json.dumps(obj)}\n\n".encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def send_raw(payload: str):
            data = f"data: {payload}\n\n".encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        while True:
            chunk = out_q.get()
            if chunk is _DONE:
                break
            if isinstance(chunk, _Err):
                send_event({"error": {"message": chunk.msg}})
                out_q.get()  # trailing _DONE
                break
            toks, lps = chunk
            delta = {"id": rid, "object": "text_completion.chunk",
                     "model": self.loop.model_name,
                     "choices": [{"index": 0, "token_ids": toks,
                                  "logprobs": {"token_logprobs": lps}}]}
            if self.decode is not None:
                delta["choices"][0]["text"] = self.decode(toks)
            send_event(delta)
        send_raw("[DONE]")  # OpenAI protocol literal, NOT json-encoded
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 drops the connections of a burst of
    # clients that arrive while the loop thread holds the interpreter lock
    # (the accept thread waits for it), and each dropped client retries
    # only after the kernel's 1 s SYN timeout
    request_queue_size = 128


def make_server(engine, host: str = "127.0.0.1", port: int = 8000,
                burst: int = 8, model_name: str = "mfa-tpu",
                tokenizer=None, pipeline: bool = True) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around an Engine.

    tokenizer: optional object with .encode(str)->ids and .decode(ids)->str
    (a transformers tokenizer works as-is). Returns a ThreadingHTTPServer;
    call .serve_forever() (or serve() below), and .loop.close() on
    shutdown.
    """
    loop = ServingLoop(engine, burst=burst, model_name=model_name,
                       pipeline=pipeline)
    handler = type("BoundHandler", (_Handler,), dict(
        loop=loop,
        encode=(getattr(tokenizer, "encode", None) if tokenizer else None),
        decode=(getattr(tokenizer, "decode", None) if tokenizer else None),
    ))
    httpd = _Server((host, port), handler)
    httpd.loop = loop  # type: ignore[attr-defined]
    return httpd


def serve(engine, host: str = "0.0.0.0", port: int = 8000, **kw):
    """Blocking convenience: serve an Engine over HTTP until interrupted."""
    httpd = make_server(engine, host=host, port=port, **kw)
    try:
        httpd.serve_forever()
    finally:
        httpd.loop.close()  # type: ignore[attr-defined]
        httpd.server_close()
