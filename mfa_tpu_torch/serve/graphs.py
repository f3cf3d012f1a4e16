"""Decode steps replayed from CUDA graphs: the port's counterpart of the JAX
engine's jitted decode program, compiled once per power-of-two batch bucket
(mfa_tpu/serve/engine.py:_bucket) and then dispatched with no Python in the
way.

Issued from Python, a decode step is about a hundred small launches a
layer, and the host takes longer to issue them than the card takes to run
them. DecodeGraphs captures one `llama.greedy_step` (decode_step, the
engine's draw, logprob) per batch bucket into a torch.cuda.CUDAGraph and
replays it:

- Inputs are static device buffers, slots and tokens [nb]. The graph copies
  its sampled tokens back into the token buffer, so n replays are an
  n-step burst with no host work in between. After each replay two small
  eager copies move the step's tokens and logprobs into row i of the
  burst's own [n, nb] buffers: one graph per bucket, not one per (bucket,
  burst length), keeps captures and graph memory at one per bucket, and
  the copies take microseconds beside a step of milliseconds.
- Captures run in the strict "global" mode, which refuses any call that
  is unsafe while a stream captures. The launchers' per-call
  cudaFuncSetAttribute and kernel 10's cudaMemsetAsync (an empty
  contraction) are legal there; a pageable host-to-device copy is not,
  so the step's inputs must already be on the device.
- A capture records work and runs none of it. decode_step writes the cache
  in place, so a warm-up step would append to live slots: the bucket's
  first real step runs eagerly instead, on the capture stream (it loads
  the kernels, fills the RoPE tables and sets cuBLAS up for that stream),
  and the capture follows it.
- A graph freezes the addresses it was captured with, kernel arguments
  and the TMA tensor maps that kernels 6 and 10 encode on the host
  included. The cache's pools, scales, block table and lengths are
  updated in place, the params never move, and intermediates live in the
  graphs' private memory pool, so every address holds across replays. The
  paged kernel's grid follows the table's width, never the lengths
  (kernels/paged.py:split_plan), so one graph serves every length. A new
  cache (Engine.recover) needs new graphs: reset().
- `_build.launches` counts in Python, where a capture would count once and
  a replay never. Each graph keeps the counts its capture recorded (taken
  back out of the counter: a capture launches nothing) and every replay
  adds them.
- Sampling: the engine's SamplingParams are fixed per engine; a batch
  with per-request parameters ([4, nb] vectors) or presence rows ([nb,
  vocab] bool, the repetition penalty) takes a graph of its own for its
  bucket (key (nb, vecs, presence)), with those as static buffers (the
  presence rows are marked in the graph and copied back to the caller's
  tensor after the burst). The random draw is not in the graph: before
  each replay one eager launch fills the bucket's static [nb, vocab]
  uniform buffer from the engine's generator, exactly the call the eager
  step makes, so the same generator state gives the same tokens replayed
  or eager. Greedy engines capture what they did before sampling existed.
- SpeculativeGraphs holds one graph per (bucket, k) of a GREEDY
  speculative iteration (llama.speculative_iteration: k draft steps, one
  verify, the acceptance and both caches' lengths), replayed n_iters times
  with one readback; captured like the decode step, on the target's and
  the draft's caches.

On the card a capture or replay that fails raises; nothing falls back to
eager decode. On the CPU there is nothing to capture, and the same calls
run `llama.decode_burst`, the plain loop. Under a mesh (Engine(mesh=)) a
step's all-reduces are in the graph, so graphs are captured only when the
mesh can be captured (shard/mesh.py:capturable: NCCL, or an axis of one
rank, which runs no collective under gloo); under gloo with more ranks
the steps run eagerly (and stats.captures stays 0).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Optional

import torch

from mfa_tpu_torch.kernels import _build
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.serve.sampling import SamplingParams, uniform_noise
from mfa_tpu_torch.shard.mesh import capturable

# Private switch for measurements only (chip_smoke.py and
# scripts/profile_torch_engine.py time the eager step with it off); not an
# engine option.
_ENABLED = True


@dataclasses.dataclass
class _Bucket:
    graph: torch.cuda.CUDAGraph
    slots: torch.Tensor  # [nb] int64 input
    tokens: torch.Tensor  # [nb] int64 input; after a replay, its draw
    lps: torch.Tensor  # [nb] fp32 logprobs of those tokens
    logits: torch.Tensor  # [nb, vocab] fp32, in the graph pool
    launches: collections.Counter  # kernel launches of one replay
    noise: Optional[torch.Tensor] = None  # [nb, vocab] fp32 uniforms
    presence: Optional[torch.Tensor] = None  # [nb, vocab] bool
    vecs: Optional[torch.Tensor] = None  # [4, nb] fp32 per-row knobs

    def replay(self) -> None:
        self.graph.replay()
        _build.launches.update(self.launches)


class _Captures:
    """What the engine's graphs share: the capture stream, one memory pool,
    the stats, and the eager-step-then-capture of a step function."""

    def __init__(self, device: torch.device, stats, mesh=None):
        self.device = device
        self.stats = stats
        self.mesh = mesh
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None

    def drop_pool(self) -> None:
        self._pool = None

    @property
    def enabled(self) -> bool:
        return self.device.type == "cuda" and _ENABLED and capturable(self.mesh)

    def capture(self, step):
        """Run step() eagerly on the capture stream (it writes its results
        into static buffers), then capture a second step() into a graph.
        -> (graph, the capture's return value, the launches it recorded)."""
        main = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            step()
            before = collections.Counter(_build.launches)
            t0 = time.perf_counter()
            graph.capture_begin(pool=self._pool, capture_error_mode="global")
            try:
                out = step()
            finally:
                graph.capture_end()
            self.stats.capture_s += time.perf_counter() - t0
        main.wait_stream(side)
        recorded = collections.Counter(_build.launches)
        recorded.subtract(before)
        recorded = +recorded  # the launches the capture recorded
        _build.launches.subtract(recorded)
        self.stats.captures += 1
        return graph, out, recorded


class DecodeGraphs(_Captures):
    """The decode graphs of one engine: one per batch bucket (and sampling
    kind), captured on first use against one cache. `stats` (an
    EngineStats) gets the capture count and seconds. sampling: the
    engine's SamplingParams (None: greedy); mesh: the params' and cache's
    (module docstring)."""

    def __init__(self, params, cfg: llama.LlamaConfig, device: torch.device,
                 stats, sampling: Optional[SamplingParams] = None, mesh=None):
        super().__init__(device, stats, mesh)
        self.params = params
        self.cfg = cfg
        self.sampling = sampling
        self.reset()

    def reset(self) -> None:
        """Drop every graph and its memory pool: they address the cache they
        were captured on. Keys: the bucket size for the engine's plain draw,
        (bucket, vecs, presence) for per-request vectors or presence rows."""
        self.buckets: Dict[object, _Bucket] = {}
        self._cache = None
        self.drop_pool()

    def burst(self, cache, slots: torch.Tensor, tokens: torch.Tensor,
              n: int, presence: Optional[torch.Tensor] = None,
              sampling_vecs: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """n decode steps of a padded batch, each step's tokens fed to the
        next on the device. slots, tokens: [nb] int64 on the device;
        presence: [nb, vocab] bool rows, marked in place with every draw;
        sampling_vecs: [4, nb] fp32; generator: the engine's, for
        stochastic draws. Returns fresh (tokens [n, nb] int64, logprobs [n,
        nb] fp32) on the device; the cache is updated in place."""
        if not self.enabled:
            _, toks, lps = llama.decode_burst(
                self.params, self.cfg, cache, slots, tokens, n, self.sampling,
                generator, presence, sampling_vecs, mesh=self.mesh)
            return toks, lps
        if self._cache is not None and cache is not self._cache:
            raise RuntimeError("the decode graphs were captured on another "
                               "cache: reset() them first")
        nb = int(slots.shape[0])
        key = nb if presence is None and sampling_vecs is None else (
            nb, sampling_vecs is not None, presence is not None)
        noisy = llama.needs_noise(self.sampling, sampling_vecs)
        toks = torch.empty((n, nb), dtype=torch.long, device=self.device)
        lps = torch.empty((n, nb), dtype=torch.float32, device=self.device)
        b = self.buckets.get(key)
        for i in range(n):
            if b is None:  # runs step 0 eagerly
                b = self._capture(key, cache, slots, tokens, presence,
                                  sampling_vecs, noisy, generator)
            else:
                if i == 0:
                    b.slots.copy_(slots)
                    b.tokens.copy_(tokens)
                    if presence is not None:
                        b.presence.copy_(presence)
                    if sampling_vecs is not None:
                        b.vecs.copy_(sampling_vecs)
                if noisy:
                    uniform_noise(None, generator, None, out=b.noise)
                b.replay()
            toks[i].copy_(b.tokens)
            lps[i].copy_(b.lps)
        if presence is not None:
            presence.copy_(b.presence)
        return toks, lps

    def _capture(self, key, cache, slots, tokens, presence, vecs, noisy,
                 generator) -> _Bucket:
        """Run the bucket's first step eagerly, then capture it."""
        b = _Bucket(None, slots.clone(), tokens.clone(),
                    torch.empty(slots.shape, dtype=torch.float32,
                                device=self.device), None, None)
        if presence is not None:
            b.presence = presence.clone()
        if vecs is not None:
            b.vecs = vecs.clone()
        if noisy:  # the eager step's draw; the capture only reads the buffer
            b.noise = uniform_noise((b.slots.shape[0], self.cfg.vocab_size),
                                    generator, self.device)

        def step():
            logits, ids, lp = llama.greedy_step(
                self.params, self.cfg, cache, b.slots, b.tokens, self.sampling,
                b.noise, b.presence, b.vecs, self.mesh)
            b.tokens.copy_(ids)
            b.lps.copy_(lp)
            return logits

        b.graph, b.logits, b.launches = self.capture(step)
        self._cache = cache
        self.buckets[key] = b
        return b


@dataclasses.dataclass
class _SpecBucket:
    graph: torch.cuda.CUDAGraph
    slots: torch.Tensor  # [nb] int64
    tokens: torch.Tensor  # [nb] int64: the last emitted token, fed forward
    out: tuple  # (t_out [nb, k], lps [nb, k], n_emit [nb], m [nb])
    launches: collections.Counter

    def replay(self) -> None:
        self.graph.replay()
        _build.launches.update(self.launches)


class SpeculativeGraphs(_Captures):
    """One graph per (batch bucket, k) of a greedy speculative iteration
    (llama.speculative_iteration) on the target's and the draft's caches."""

    def __init__(self, params, draft_params, cfg: llama.LlamaConfig,
                 draft_cfg: llama.LlamaConfig, device: torch.device, stats,
                 mesh=None):
        super().__init__(device, stats, mesh)
        self.params, self.draft_params = params, draft_params
        self.cfg, self.draft_cfg = cfg, draft_cfg
        self.reset()

    def reset(self) -> None:
        """Drop every graph and its memory pool (they address the caches
        they were captured on)."""
        self.buckets: Dict[tuple, _SpecBucket] = {}
        self._caches = None
        self.drop_pool()

    def burst(self, cache, draft_cache, slots: torch.Tensor,
              tokens: torch.Tensor, k: int, n_iters: int):
        """n_iters greedy speculative iterations of a padded batch. Returns
        (t_out [n_iters, nb, k], lps [n_iters, nb, k], n_emit [n_iters,
        nb], m [n_iters, nb]) on the device; both caches are updated in
        place."""
        if not self.enabled:
            return llama.speculative_burst(
                self.params, self.draft_params, self.cfg, self.draft_cfg,
                cache, draft_cache, slots, tokens, k, n_iters, self.mesh)
        if self._caches is not None and (cache, draft_cache) != self._caches:
            raise RuntimeError("the speculative graphs were captured on other "
                               "caches: reset() them first")
        nb = int(slots.shape[0])
        b = self.buckets.get((nb, k))
        outs = None
        for i in range(n_iters):
            if b is None:  # runs iteration 0 eagerly
                b = self._capture(cache, draft_cache, slots, tokens, k)
            else:
                if i == 0:
                    b.slots.copy_(slots)
                    b.tokens.copy_(tokens)
                b.replay()
            if outs is None:
                outs = tuple(torch.empty((n_iters,) + x.shape, dtype=x.dtype,
                                         device=self.device) for x in b.out)
            for dst, src in zip(outs, b.out):
                dst[i].copy_(src)
        return outs

    def _capture(self, cache, draft_cache, slots, tokens, k) -> _SpecBucket:
        """Run the bucket's first iteration eagerly (its results become the
        static output buffers), then capture one that copies into them."""
        b = _SpecBucket(None, slots.clone(), tokens.clone(), (), None)
        out = []

        def step():
            *res, nxt = llama.speculative_iteration(
                self.params, self.draft_params, self.cfg, self.draft_cfg, cache,
                draft_cache, b.slots, b.tokens, k, self.mesh)
            b.tokens.copy_(nxt)
            if out:
                for dst, src in zip(out, res):
                    dst.copy_(src)
            else:
                out.extend(x.clone() for x in res)

        b.graph, _, b.launches = self.capture(step)
        b.out = tuple(out)
        self._caches = (cache, draft_cache)
        self.buckets[(int(slots.shape[0]), k)] = b
        return b
