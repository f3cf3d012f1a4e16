"""Generation engine, synchronous loop (counterpart of mfa_tpu/serve/engine.py).

Step shape: release finished slots -> admit -> prefill admitted prompts
(kernel 1, writes KV pages) -> map pages for the next position -> one
batched decode step over all active slots (kernel 3) -> greedy sample ->
append / finish. Decode batches are padded to power-of-two buckets, the
padding rows pointing at a free scratch slot whose junk append is rolled
back by the next step's batched release, as in the JAX engine.

Not ported yet (raise NotImplementedError): decode bursts, the pipelined
loop, chunked prefill, the prefix cache, speculative decoding, recovery,
meshes and vision.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mfa_tpu_torch.cache.paged_cache import map_pages, release_slots
from mfa_tpu_torch.dispatch.config import resolve_device
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.serve.sampling import SamplingParams, sample, token_logprobs
from mfa_tpu_torch.serve.scheduler import Request, Scheduler


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    steps: int = 0
    preemptions: int = 0
    prefill_batches: int = 0
    # host seconds of prefill waves and decode steps, each ending in the
    # readback of its sampled tokens (so the device work is included)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    wall_s: float = 0.0


def _bucket(n: int, buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return 1 << (n - 1).bit_length()


class Engine:
    def __init__(
        self,
        params,
        cfg: llama.LlamaConfig,
        num_pages: int = 256,
        page_size: int = 64,
        max_seqs: int = 16,
        pages_per_seq: int = 16,
        quant_dtype: Optional[str] = None,
        sampling: Optional[SamplingParams] = None,
        device="cuda",
        mesh=None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        draft_params=None,
        vision=None,
    ):
        """params must live on `device` (init_params / params_from_numpy
        with the same device). The cache is created there."""
        if (mesh is not None or prefill_chunk is not None or prefix_cache
                or draft_params is not None or vision is not None):
            raise NotImplementedError(
                "meshes, chunked prefill, the prefix cache, speculative "
                "decoding and vision are not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.quant_dtype = quant_dtype
        self.params = params
        self.cache = llama.build_kv_caches(
            cfg, num_pages, page_size, max_seqs, pages_per_seq, quant_dtype,
            device=self.device)
        self.sched = Scheduler(max_seqs, pages_per_seq, page_size, num_pages)
        self.sampling = sampling or SamplingParams()
        self.stats = EngineStats()
        # Finished slots awaiting their device-metadata clear: one batched
        # release_slots at the next step entry (_flush_released).
        self._to_release: list = []
        self._next_uid = 0
        self._stream_pos: Dict[int, int] = {}  # uid -> tokens consumed
        self._all_reqs: Dict[int, Request] = {}

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_token: Optional[int] = None,
               stop: Optional[List[List[int]]] = None) -> Request:
        """stop: token-id sequences that end generation when the output ends
        with one of them (the matched tokens stay in the output)."""
        req = Request(self._next_uid, list(prompt), max_new_tokens,
                      eos_token, stop=stop)
        self._next_uid += 1
        self.sched.submit(req)
        self._stream_pos[req.uid] = 0
        self._all_reqs[req.uid] = req
        return req

    def poll(self):
        """Tokens generated since the last poll(): {uid: [tokens...]}.
        Finished requests flush their tail and drop out of later polls."""
        out = {}
        done_uids = []
        for uid, pos in self._stream_pos.items():
            req = self._all_reqs.get(uid)
            if req is None:
                continue
            if len(req.generated) > pos:
                out[uid] = req.generated[pos:]
                self._stream_pos[uid] = len(req.generated)
            if req.done:
                done_uids.append(uid)
        for uid in done_uids:
            del self._stream_pos[uid]
            self._all_reqs.pop(uid, None)
        return out

    def _sample(self, logits):
        """-> host (ids [n], logprobs [n]); logprobs under the unfiltered
        model distribution."""
        ids = sample(logits)
        lps = token_logprobs(logits, ids)
        return ids.cpu().numpy(), lps.cpu().numpy()

    def _prefill_admitted(self, reqs: List[Request]) -> None:
        """Prefill all newly admitted prompts in one batched pass. Resumed
        (preempted) requests re-prefill their prompt plus all but the last
        generated token; the last one replays through the decode step."""
        if not reqs:
            return
        t0 = time.perf_counter()
        token_lists = [r.prompt + r.generated[:-1] for r in reqs]
        self.cache, logits = llama.prefill_batch(
            self.params, self.cfg, self.cache, [r.slot for r in reqs],
            [r.pages for r in reqs], token_lists)
        firsts, first_lps = self._sample(logits)
        self.stats.prefill_batches += 1
        self.stats.prefill_s += time.perf_counter() - t0
        for req, toks, first, flp in zip(reqs, token_lists, firsts, first_lps):
            self.stats.prefill_tokens += len(toks)
            if not req.generated:  # fresh request (not a resume)
                req.generated.append(int(first))
                req.logprobs.append(float(flp))
                self.stats.decode_tokens += 1
            if req.done:
                self._finish(req)

    def _map_new_pages(self, n: int = 1) -> None:
        """Map pages for the next n decode positions of every active
        request in ONE scatter; under page pressure preempt the youngest
        request and retry."""
        m_slots, m_idx, m_ids = [], [], []
        preempted = set()
        for req in list(self.sched.active.values()):
            while req.uid not in preempted:
                try:
                    pairs = self.sched.ensure_decode_pages(req, n)
                except MemoryError:
                    victims = [r for r in self.sched.active.values()
                               if r.uid not in preempted]
                    if len(victims) <= 1:
                        raise  # nothing left to steal from
                    victim = max(victims, key=lambda r: r.uid)
                    preempted.add(victim.uid)
                    self.sched.preempt(victim)
                    self.stats.preemptions += 1
                    continue
                for page_index, page_id in pairs:
                    m_slots.append(req.slot)
                    m_idx.append(page_index)
                    m_ids.append(page_id)
                break
        if preempted:
            keep = [i for i, s in enumerate(m_slots) if s in self.sched.active]
            m_slots = [m_slots[i] for i in keep]
            m_idx = [m_idx[i] for i in keep]
            m_ids = [m_ids[i] for i in keep]
        if m_slots:
            self.cache = map_pages(self.cache, m_slots, m_idx, m_ids)

    def _pad_batch(self, active):
        """Pad the active batch to a power-of-two bucket. Padding rows point
        at a free scratch slot whose junk appends the caller rolls back;
        with every slot busy the batch runs unpadded.
        Returns (slots [nb], tokens [nb], scratch | None)."""
        n = len(active)
        nb = _bucket(n)
        slots = np.zeros((nb,), np.int64)
        tokens = np.zeros((nb,), np.int64)
        for i, r in enumerate(active):
            slots[i] = r.slot
            tokens[i] = r.generated[-1]
        scratch = None
        if nb > n:
            for cand in range(self.sched.max_seqs):
                if cand not in self.sched.active:
                    scratch = cand
                    break
            if scratch is None:
                return slots[:n], tokens[:n], None
            slots[n:] = scratch
        return slots, tokens, scratch

    def _decode_active(self, active) -> None:
        """One batched decode step + bookkeeping for `active` requests
        (pages for the next position must already be mapped)."""
        t0 = time.perf_counter()
        n = len(active)
        slots, tokens, scratch = self._pad_batch(active)
        self.cache, logits = llama.decode_step(
            self.params, self.cfg, self.cache, slots, tokens)
        if scratch is not None:
            # roll back the scratch slot the padded rows appended into
            self._to_release.append(scratch)
        next_tokens, next_lps = self._sample(logits[:n])
        self.stats.steps += 1
        self.stats.decode_s += time.perf_counter() - t0
        for i, req in enumerate(active):
            req.generated.append(int(next_tokens[i]))
            req.logprobs.append(float(next_lps[i]))
            self.stats.decode_tokens += 1
            if req.done:
                self._finish(req)

    def step(self) -> None:
        """One engine iteration: admit, prefill, batched decode step."""
        self._flush_released()
        self._prefill_admitted(self.sched.admit())
        if not self.sched.active:
            return
        self._map_new_pages(1)
        self._decode_active(list(self.sched.active.values()))

    def _finish(self, req: Request) -> None:
        slot = req.slot
        self.sched.finish(req)
        self._to_release.append(slot)

    def _flush_released(self) -> None:
        """Batched device-metadata clear of finished slots: one scatter pair
        however many requests finished since the last flush."""
        if not self._to_release:
            return
        slots = self._to_release
        self._to_release = []
        self.cache = release_slots(self.cache, slots)

    def run(self, burst: int = 1, pipeline: bool = False) -> EngineStats:
        """Drain all work with the synchronous loop (one decode step per
        iteration). Bursts and the pipelined loop are not ported yet."""
        if burst != 1 or pipeline:
            raise NotImplementedError(
                "decode bursts and the pipelined loop are not ported yet")
        t0 = time.perf_counter()
        while self.sched.has_work:
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.wall_s += time.perf_counter() - t0
        return self.stats
