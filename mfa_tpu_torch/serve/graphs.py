"""Decode steps replayed from CUDA graphs: the port's counterpart of the JAX
engine's jitted decode program, compiled once per power-of-two batch bucket
(mfa_tpu/serve/engine.py:_bucket) and then dispatched with no Python in the
way.

Issued from Python, a decode step is about a hundred small launches a
layer, and the host takes longer to issue them than the card takes to run
them. DecodeGraphs captures one `llama.greedy_step` (decode_step, greedy
argmax, logprob) per batch bucket into a torch.cuda.CUDAGraph and
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

On the card a capture or replay that fails raises; nothing falls back to
eager decode. On the CPU there is nothing to capture, and the same calls
run `llama.decode_burst`, the plain loop.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Optional

import torch

from mfa_tpu_torch.kernels import _build
from mfa_tpu_torch.models import llama

# Private switch for measurements only (chip_smoke.py and
# scripts/profile_torch_engine.py time the eager step with it off); not an
# engine option.
_ENABLED = True


@dataclasses.dataclass
class _Bucket:
    graph: torch.cuda.CUDAGraph
    slots: torch.Tensor  # [nb] int64 input
    tokens: torch.Tensor  # [nb] int64 input; after a replay, its argmax
    lps: torch.Tensor  # [nb] fp32 logprobs of those tokens
    logits: torch.Tensor  # [nb, vocab] fp32, in the graph pool
    launches: collections.Counter  # kernel launches of one replay

    def replay(self) -> None:
        self.graph.replay()
        _build.launches.update(self.launches)


class DecodeGraphs:
    """The decode graphs of one engine: one per batch bucket, captured on
    first use against one cache. `stats` (an EngineStats) gets the capture
    count and seconds."""

    def __init__(self, params, cfg: llama.LlamaConfig, device: torch.device,
                 stats):
        self.params = params
        self.cfg = cfg
        self.device = device
        self.stats = stats
        self._stream: Optional[torch.cuda.Stream] = None
        self.reset()

    def reset(self) -> None:
        """Drop every graph and its memory pool: they address the cache they
        were captured on."""
        self.buckets: Dict[int, _Bucket] = {}
        self._cache = None
        self._pool = None

    @property
    def enabled(self) -> bool:
        return self.device.type == "cuda" and _ENABLED

    def burst(self, cache, slots: torch.Tensor, tokens: torch.Tensor,
              n: int):
        """n greedy decode steps of a padded batch, each step's tokens fed to
        the next on the device. slots, tokens: [nb] int64 on the device.
        Returns fresh (tokens [n, nb] int64, logprobs [n, nb] fp32) on the
        device; the cache is updated in place."""
        if not self.enabled:
            _, toks, lps = llama.decode_burst(self.params, self.cfg, cache,
                                              slots, tokens, n)
            return toks, lps
        if self._cache is not None and cache is not self._cache:
            raise RuntimeError("the decode graphs were captured on another "
                               "cache: reset() them first")
        nb = int(slots.shape[0])
        toks = torch.empty((n, nb), dtype=torch.long, device=self.device)
        lps = torch.empty((n, nb), dtype=torch.float32, device=self.device)
        b = self.buckets.get(nb)
        for i in range(n):
            if b is None:
                b = self._capture(cache, slots, tokens)  # runs step 0 eagerly
            else:
                if i == 0:
                    b.slots.copy_(slots)
                    b.tokens.copy_(tokens)
                b.replay()
            toks[i].copy_(b.tokens)
            lps[i].copy_(b.lps)
        return toks, lps

    def _capture(self, cache, slots, tokens) -> _Bucket:
        """Run the bucket's first step eagerly, then capture it."""
        main = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        b_slots, b_tokens = slots.clone(), tokens.clone()
        b_lps = torch.empty(b_slots.shape, dtype=torch.float32,
                            device=self.device)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            _, ids, lp = llama.greedy_step(self.params, self.cfg, cache,
                                           b_slots, b_tokens)
            b_tokens.copy_(ids)
            b_lps.copy_(lp)
            del ids, lp
            before = collections.Counter(_build.launches)
            t0 = time.perf_counter()
            graph.capture_begin(pool=self._pool, capture_error_mode="global")
            try:
                logits, ids, lp = llama.greedy_step(self.params, self.cfg,
                                                    cache, b_slots, b_tokens)
                b_tokens.copy_(ids)
                b_lps.copy_(lp)
            finally:
                graph.capture_end()
            self.stats.capture_s += time.perf_counter() - t0
        main.wait_stream(side)
        recorded = collections.Counter(_build.launches)
        recorded.subtract(before)
        recorded = +recorded  # the launches the capture recorded
        _build.launches.subtract(recorded)
        self.stats.captures += 1
        self._cache = cache
        b = _Bucket(graph, b_slots, b_tokens, b_lps, logits, recorded)
        self.buckets[int(b_slots.shape[0])] = b
        return b
