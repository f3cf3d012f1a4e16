"""Generation engine (counterpart of mfa_tpu/serve/engine.py).

Step shape: release finished slots -> admit -> prefill admitted prompts
(kernels 2 + 3 in bf16, else 1, writes KV pages; image prompts, with vision=, in a wave of
their own through the vision tower and the image-block kernel) ->
advance every
in-progress long prompt or prefix-cache suffix by one chunk (kernel 8,
write-then-attend) -> map pages for the next position(s) -> batched
decode over the requests whose prefill is complete (kernel 6; kernel 10
on int8 weights) -> greedy sample -> append / finish. Decode and chunk
batches are padded to power-of-two buckets, the padding rows pointing at
a free scratch slot, as in the JAX engine.

Decode runs one step at a time (run()), in bursts of up to n steps with
one token readback each (run(burst=n, pipeline=False): step_burst), or
with up to PIPELINE_DEPTH bursts in flight (run(burst=n): the pipelined
loop). On the card every decode step replays the CUDA graph of its batch
bucket (serve/graphs.py). run(max_retries=k) recovers from a failed step
(recover()) up to k times.

Not ported yet (raise NotImplementedError): speculative decoding and
meshes.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from mfa_tpu_torch.cache.paged_cache import map_pages, release_slots
from mfa_tpu_torch.dispatch.config import host_to_device, resolve_device
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.serve.graphs import DecodeGraphs
from mfa_tpu_torch.serve.sampling import SamplingParams, sample, token_logprobs
from mfa_tpu_torch.serve.scheduler import Request, Scheduler


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    steps: int = 0
    recoveries: int = 0
    preemptions: int = 0
    prefill_batches: int = 0  # prefill_batch calls, image waves included
    chunk_batches: int = 0  # prefill_chunk_batch calls
    # the image waves among prefill_batches: their calls, prompt tokens
    # and host seconds (also counted in prefill_tokens / prefill_s)
    image_batches: int = 0
    image_prefill_tokens: int = 0
    image_prefill_s: float = 0.0
    # host seconds of prefill waves and of decode bursts (their dispatch
    # and the readback of their sampled tokens, so the device work is
    # included; capture_s too)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    wall_s: float = 0.0
    readbacks: int = 0  # decode bursts read back (one per step at burst 1)
    # decode graphs captured, and the host seconds their captures took
    captures: int = 0
    capture_s: float = 0.0


def _bucket(n: int, buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return 1 << (n - 1).bit_length()


class Engine:
    PIPELINE_DEPTH = 2

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
        with the same device). The cache is created there.

        prefill_chunk: prompts longer than this many tokens are ingested one
        page-aligned chunk per step, interleaved with decode (a multiple of
        page_size). prefix_cache: requests reuse the pages of an earlier
        prompt's shared prefix and prefill only their suffix.

        vision: optional (vision_params, SiglipVisionConfig,
        image_token_id), on `device` too, enabling submit(..., images=)
        Gemma3 image prompts: their prefill merges the projected image
        features over the placeholder rows under the image-block mask
        (the image-block kernel); decode is unchanged (the images live in
        the prompt)."""
        if mesh is not None or draft_params is not None:
            raise NotImplementedError(
                "meshes and speculative decoding are not ported yet")
        if prefill_chunk is not None and prefill_chunk % page_size != 0:
            raise ValueError("prefill_chunk must be a multiple of page_size")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.quant_dtype = quant_dtype
        self.params = params
        self.cache = llama.build_kv_caches(
            cfg, num_pages, page_size, max_seqs, pages_per_seq, quant_dtype,
            device=self.device)
        self.sched = Scheduler(max_seqs, pages_per_seq, page_size, num_pages,
                               prefix_cache=prefix_cache)
        self.sampling = sampling or SamplingParams()
        self.stats = EngineStats()
        self.graphs = DecodeGraphs(params, cfg, self.device, self.stats)
        # dispatched decode bursts whose tokens are not read back yet
        self._pending_bursts: Deque[dict] = collections.deque()
        # Finished slots awaiting their device-metadata clear: one batched
        # release_slots at the next step entry (_flush_released).
        self._to_release: list = []
        self._next_uid = 0
        self._stream_pos: Dict[int, int] = {}  # uid -> tokens consumed
        self._all_reqs: Dict[int, Request] = {}
        self.prefill_chunk = prefill_chunk
        self._prefilling: Dict[int, tuple] = {}  # uid -> (req, pos, tokens)
        self.vision = vision

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_token: Optional[int] = None,
               stop: Optional[List[List[int]]] = None, images=None) -> Request:
        """stop: token-id sequences that end generation when the output ends
        with one of them (the matched tokens stay in the output).
        images: [n_images, 3, H, W] pixels matching the prompt's <image>
        placeholder runs (needs the engine's vision= tuple); image prompts
        prefill whole (never chunked) and never share prefix pages."""
        if images is not None:
            if self.vision is None:
                raise ValueError(
                    "images= requires an Engine vision= tuple "
                    "(vision_params, vision_cfg, image_token_id)")
            image_tok, vcfg = self.vision[2], self.vision[1]
            n_img = images.shape[0]
            placeholders = sum(1 for t in prompt if t == image_tok)
            if placeholders != n_img * vcfg.mm_tokens_per_image:
                raise ValueError(
                    f"{n_img} images need {n_img * vcfg.mm_tokens_per_image} "
                    f"<image> tokens (id {image_tok}), the prompt has "
                    f"{placeholders}")
        req = Request(self._next_uid, list(prompt), max_new_tokens,
                      eos_token, stop=stop, images=images)
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
        """Prefill all newly admitted prompts in one batched pass, the image
        prompts in a second one. Long text prompts (past prefill_chunk) and
        prefix-cache hits, whose suffix starts at a page-aligned offset, go
        to the chunked path instead; image prompts always prefill whole
        (the image-block mask needs every prompt row in one pass). Resumed
        (preempted) requests re-prefill their prompt plus all but the last
        generated token, with their images; the last one replays through
        the decode step."""
        toks_of = {r.uid: r.prompt + r.generated[:-1] for r in reqs}
        for r in reqs:
            toks = toks_of[r.uid]
            if (((self.prefill_chunk is not None
                    and len(toks) > self.prefill_chunk) or r.cached_len > 0)
                    and r.images is None):
                self._prefilling[r.uid] = (r, r.cached_len, toks)
        reqs = [r for r in reqs if r.uid not in self._prefilling]
        # text prompts keep kernel 1; image prompts, padded to their own
        # longest prompt, take the tower and the image-block kernel
        text_reqs = [r for r in reqs if r.images is None]
        img_reqs = [r for r in reqs if r.images is not None]
        for group, vision in ((text_reqs, None), (img_reqs, self.vision)):
            if not group:
                continue
            t0 = time.perf_counter()
            token_lists = [toks_of[r.uid] for r in group]
            self.cache, logits = llama.prefill_batch(
                self.params, self.cfg, self.cache, [r.slot for r in group],
                [r.pages for r in group], token_lists, vision=vision,
                pixel_lists=[r.images for r in group] if vision else None)
            firsts, first_lps = self._sample(logits)
            secs = time.perf_counter() - t0
            self.stats.prefill_batches += 1
            self.stats.prefill_s += secs
            if vision is not None:
                self.stats.image_batches += 1
                self.stats.image_prefill_s += secs
                self.stats.image_prefill_tokens += sum(map(len, token_lists))
            for req, toks, first, flp in zip(group, token_lists, firsts,
                                             first_lps):
                self.stats.prefill_tokens += len(toks)
                if self.sched.prefix is not None and req.images is None:
                    self.sched.prefix.register(req)
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
        for req in self._decode_ready():
            while req.uid not in preempted:
                try:
                    pairs = self.sched.ensure_decode_pages(req, n)
                except MemoryError:
                    # mid-prefill requests are no victims: their chunk
                    # offsets would not survive the re-prefill
                    victims = [r for r in self.sched.active.values()
                               if r.uid not in preempted
                               and r.uid not in self._prefilling]
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

    def _scratch_slot(self) -> Optional[int]:
        """A free slot for padding rows, or None when every slot is busy."""
        for cand in range(self.sched.max_seqs):
            if cand not in self.sched.active:
                return cand
        return None

    def _advance_chunked_prefill(self) -> None:
        """Advance EVERY in-progress long prompt (or prefix-hit suffix) by
        one chunk in a single batched pass (llama.prefill_chunk_batch):
        prefill work per step stays bounded, and concurrent long prompts do
        not serialize."""
        if not self._prefilling:
            return
        t0 = time.perf_counter()
        items = list(self._prefilling.values())
        page = self.page_size
        if self.prefill_chunk is not None:
            chunk = self.prefill_chunk
        else:
            # suffix-only mode (prefix-cache hits): one chunk covers the
            # largest remaining suffix, bucketed to power-of-two pages
            max_rem = max(len(t) - pos for _, pos, t in items)
            np_pages = -(-max_rem // page)
            chunk = (1 << max(np_pages - 1, 0).bit_length()) * page
        pad_rows = _bucket(len(items)) - len(items)
        scratch = self._scratch_slot() if pad_rows else None
        if scratch is None:
            pad_rows = 0  # every slot busy: the batch runs unpadded
        slots, pages_l, chunk_toks, offs, totals = [], [], [], [], []
        for req, pos, tokens in items:
            slots.append(req.slot)
            pages_l.append(req.pages)
            chunk_toks.append(tokens[pos: pos + chunk])
            offs.append(pos)
            totals.append(len(tokens))
        for _ in range(pad_rows):
            slots.append(scratch)
            pages_l.append([])      # zero table row -> null-page writes
            chunk_toks.append([0])
            offs.append(0)
            totals.append(chunk + page)  # never "final"
        self.cache, logits = llama.prefill_chunk_batch(
            self.params, self.cfg, self.cache, slots, pages_l, chunk_toks,
            offs, totals, chunk)
        # logits carry the padded bucket rows; sample only the real items
        ids, lps = self._sample(logits[: len(items)])
        self.stats.chunk_batches += 1
        self.stats.prefill_s += time.perf_counter() - t0
        for i, (req, pos, tokens) in enumerate(items):
            pos += min(chunk, len(tokens) - pos)
            if pos < len(tokens):
                self._prefilling[req.uid] = (req, pos, tokens)
                continue
            del self._prefilling[req.uid]
            self.stats.prefill_tokens += len(tokens) - req.cached_len
            if self.sched.prefix is not None:
                self.sched.prefix.register(req)
            if not req.generated:
                req.generated.append(int(ids[i]))
                req.logprobs.append(float(lps[i]))
                self.stats.decode_tokens += 1
            if req.done:
                self._finish(req)

    def _decode_ready(self) -> List[Request]:
        """Active requests whose prefill is complete."""
        return [r for r in self.sched.active.values()
                if r.uid not in self._prefilling]

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
            scratch = self._scratch_slot()
            if scratch is None:
                return slots[:n], tokens[:n], None
            slots[n:] = scratch
        return slots, tokens, scratch

    def _upload(self, values) -> torch.Tensor:
        return host_to_device(values, torch.long, self.device)

    @staticmethod
    def _burst_len(active, n: int) -> int:
        """Steps of the next burst: n, or the remaining budget (in-flight
        tokens counted) rounded up to a power of two, as mfa_tpu buckets
        its burst programs. <= 0 when every budget is spent."""
        rem = max(r.max_new_tokens - len(r.generated) - r.inflight
                  for r in active)
        if rem <= 0 or rem >= n:
            return min(rem, n)
        return min(n, 1 << (rem - 1).bit_length())

    def _dispatch(self, active, n_eff: int, slots, scratch, tokens) -> dict:
        """Enqueue an n_eff-step decode burst of `active` (slots from
        _pad_batch; tokens on the host or, chained, on the device) and the
        copy of its tokens and logprobs to pinned host memory, without
        waiting for either. -> the burst record for _process_burst_result."""
        t0 = time.perf_counter()
        if not isinstance(tokens, torch.Tensor):
            tokens = self._upload(tokens)
        toks, lps = self.graphs.burst(self.cache, self._upload(slots), tokens,
                                      n_eff)
        event = None
        if self.device.type == "cuda":
            toks_h = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            lps_h = torch.empty(lps.shape, dtype=lps.dtype, pin_memory=True)
            toks_h.copy_(toks, non_blocking=True)
            lps_h.copy_(lps, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            toks_h, lps_h = toks, lps
        for r in active:
            r.inflight += n_eff
        self.stats.decode_s += time.perf_counter() - t0
        return dict(active=list(active), n_eff=n_eff, toks=toks, toks_h=toks_h,
                    lps_h=lps_h, event=event, slots=slots, scratch=scratch)

    def _process_burst_result(self, d) -> None:
        """Wait for one burst's readback and append its tokens. Rows that
        finish mid-burst (eos, stop, budget) drop the tokens past it; their
        spare appends went to pages of the slot released next."""
        t0 = time.perf_counter()
        if d["event"] is not None:
            d["event"].synchronize()
        toks_np, lps_np = d["toks_h"].numpy(), d["lps_h"].numpy()
        self.stats.readbacks += 1
        self.stats.steps += d["n_eff"]
        for i, req in enumerate(d["active"]):
            req.inflight = max(0, req.inflight - d["n_eff"])
            was_done = req.done  # finished in an earlier processed burst
            for t, lp in zip(toks_np[:, i], lps_np[:, i]):
                if req.done:
                    break
                req.generated.append(int(t))
                req.logprobs.append(float(lp))
                self.stats.decode_tokens += 1
            if req.done and not was_done:
                self._finish(req)
        # roll back the scratch slot's junk appends only while it is still
        # free: an admission may have claimed it since (its prefill SETS the
        # row and length, behind the junk appends on the stream)
        if d["scratch"] is not None and d["scratch"] not in self.sched.active:
            self._to_release.append(d["scratch"])
        self.stats.decode_s += time.perf_counter() - t0

    def _decode_active(self, active) -> None:
        """One batched decode step + bookkeeping for `active` requests
        (pages for the next position must already be mapped)."""
        slots, tokens, scratch = self._pad_batch(active)
        self._process_burst_result(
            self._dispatch(active, 1, slots, scratch, tokens))

    def step(self) -> None:
        """One engine iteration: admit, prefill, one chunk of every
        in-progress chunked prefill, batched decode step."""
        self._drain_pipeline()
        self._flush_released()
        self._prefill_admitted(self.sched.admit())
        self._advance_chunked_prefill()
        # mapping may preempt: the batch is taken after it, so a request it
        # sent back to the queue (slot -1) never decodes
        self._map_new_pages(1)
        active = self._decode_ready()
        if not active:
            return
        self._decode_active(active)

    def step_burst(self, n: int) -> None:
        """Admit + prefill, then up to n decode steps on the device with ONE
        token readback for all of them (mfa_tpu's step_burst). The burst
        length follows _burst_len; rows finishing mid-burst are truncated.
        Unlike mfa_tpu's, the batch is taken after the page mapping, which
        may preempt (as in step())."""
        self._drain_pipeline()
        self._flush_released()
        self._prefill_admitted(self.sched.admit())
        self._advance_chunked_prefill()
        active = self._decode_ready()
        if not active:
            return
        n_eff = self._burst_len(active, n)
        self._map_new_pages(n_eff)
        active = self._decode_ready()
        slots, tokens, scratch = self._pad_batch(active)
        self._process_burst_result(
            self._dispatch(active, n_eff, slots, scratch, tokens))

    # ---- pipelined burst serving -------------------------------------
    #
    # step_burst waits for its tokens every burst, and the card idles
    # while the host reads them back and books them. The pipelined loop
    # keeps up to PIPELINE_DEPTH bursts in flight: burst N+1 is dispatched
    # on device state (the cache, updated in place, and burst N's last
    # sampled tokens) BEFORE burst N's tokens are read back, so the
    # readback and the host bookkeeping overlap burst N+1. Safety rests on
    # one stream: every write to the cache (decode appends, page maps,
    # release_slots, prefill) is enqueued on the current stream, and the
    # host dispatches none of them without first having enqueued the
    # in-flight bursts; so a host decision made "early" (a page map, a
    # slot release, an admission's prefill) runs on the device after the
    # bursts in flight, and a finished row's spare appends land before its
    # pages can be mapped to a new owner. Host-to-device copies of the
    # loop go through pinned memory (dispatch/config.py:host_to_device)
    # and never wait for the stream. Requests finishing mid-flight (eos,
    # stop) are found one burst late; their extra rows waste compute but
    # corrupt nothing (_process_burst_result drops tokens past `done`).

    def _dispatch_chained(self, burst: int, prev) -> Optional[dict]:
        """Dispatch one decode burst without waiting for those in flight.

        prev: the newest dispatched burst record (None when none is in
        flight). Returns the new record, or None when no burst can be
        dispatched now: no decode-ready request, every budget projected
        spent, or page pressure (the caller then falls back to step_burst,
        which drains and preempts)."""
        active = self._decode_ready()
        if not active:
            return None
        n_eff = self._burst_len(active, burst)
        if n_eff <= 0:
            return None
        m_slots, m_idx, m_ids = [], [], []
        try:
            for req in active:
                for page_index, page_id in self.sched.ensure_decode_pages(
                        req, req.inflight + n_eff):
                    m_slots.append(req.slot)
                    m_idx.append(page_index)
                    m_ids.append(page_id)
        except MemoryError:
            # pages granted above stay mapped: their requests own them and
            # will decode into them
            if m_slots:
                self.cache = map_pages(self.cache, m_slots, m_idx, m_ids)
            return None
        if m_slots:
            self.cache = map_pages(self.cache, m_slots, m_idx, m_ids)

        slots, tokens_host, scratch = self._pad_batch(active)
        if (prev is not None and len(prev["active"]) == len(active)
                and all(a is b for a, b in zip(prev["active"], active))
                and np.array_equal(prev["slots"], slots)):
            # the rows of the burst in flight: chain its last tokens
            tokens = prev["toks"][-1]
        elif any(r.inflight for r in active):
            # the row set changed while a burst is in flight (a request
            # finished or was admitted): in-flight rows take their last
            # token through a slot-indexed map on the device, the others
            # (and padding rows) the host's exact tokens
            tokmap = torch.zeros((self.sched.max_seqs,), dtype=torch.long,
                                 device=self.device)
            tokmap[self._upload(prev["slots"])] = prev["toks"][-1]
            tokens = tokmap[self._upload(slots)]
            rows = [i for i, r in enumerate(active) if r.inflight == 0]
            rows += list(range(len(active), len(slots)))
            if rows:
                tokens[self._upload(rows)] = self._upload(tokens_host[rows])
        else:
            tokens = tokens_host
        return self._dispatch(active, n_eff, slots, scratch, tokens)

    def _drain_pipeline(self) -> None:
        """Read back every in-flight burst (the pipeline barrier): the
        synchronous step paths call it first, so the host state they build
        a batch from is exact."""
        while self._pending_bursts:
            self._process_burst_result(self._pending_bursts.popleft())

    def step_pipelined(self, n: int) -> None:
        """One pipelined iteration: admit + prefill, top the pipeline up to
        PIPELINE_DEPTH bursts in flight, then process the oldest (its
        readback overlaps the younger burst). Falls back to step_burst when
        nothing can be dispatched with an empty pipeline (page pressure)."""
        pending = self._pending_bursts
        self._flush_released()
        self._prefill_admitted(self.sched.admit())
        self._advance_chunked_prefill()
        while len(pending) < self.PIPELINE_DEPTH:
            d = self._dispatch_chained(n, pending[-1] if pending else None)
            if d is None:
                break
            pending.append(d)
        if pending:
            self._process_burst_result(pending.popleft())
        elif self._decode_ready():
            self.step_burst(n)

    def _run_pipelined(self, burst: int) -> None:
        """Drain all work with up to PIPELINE_DEPTH decode bursts in flight
        (see the block comment above)."""
        while self.sched.has_work or self._pending_bursts:
            if not (self._pending_bursts or self._decode_ready()
                    or self.sched.waiting or self._prefilling):
                return
            self.step_pipelined(burst)

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

    def recover(self) -> int:
        """Reset device state after a failed step and requeue the requests
        in flight (mfa_tpu's recover). Generated tokens are kept; their KV
        is rebuilt by re-prefilling on re-admission. The decode graphs
        address the old cache and are dropped. Returns the number of
        requeued requests."""
        self._prefilling.clear()
        self._to_release.clear()  # the rebuilt cache starts zeroed
        self._pending_bursts.clear()  # stale bursts die with the state
        active = sorted(self.sched.active.values(), key=lambda r: r.uid)
        for req in active:
            req.inflight = 0
            self.sched.finish(req)
        if self.sched.prefix is not None:
            # the rebuilt cache wipes the shared pages' contents: no later
            # admission may alias them (no request holds a reference now)
            self.sched.prefix.evict(10**9, self.sched.allocator)
        self.graphs.reset()
        c0 = self.cache
        shape = (c0.num_pages, c0.page_size, c0.lengths.shape[0],
                 c0.pages_per_seq, c0.quant_dtype)
        self.cache = c0 = None  # free the old pools before the new ones
        self.cache = llama.build_kv_caches(self.cfg, *shape,
                                           device=self.device)
        for req in reversed(active):
            self.sched.waiting.appendleft(req)
        self.stats.recoveries += 1
        return len(active)

    def run(self, max_retries: int = 0, burst: int = 1,
            pipeline: bool = True) -> EngineStats:
        """Drain all work (mfa_tpu's run). With burst > 1, up to `burst`
        decode steps run on the device between token readbacks
        (step_burst), and with pipeline (the default) up to PIPELINE_DEPTH
        bursts stay in flight (_run_pipelined). A failing step triggers
        recover() and the work restarts, up to max_retries times; then the
        failure raises."""
        t0 = time.perf_counter()
        retries = 0
        while self.sched.has_work:
            try:
                if burst > 1 and pipeline:
                    self._run_pipelined(burst)
                elif burst > 1:
                    self.step_burst(burst)
                else:
                    self.step()
            except Exception:
                if retries >= max_retries:
                    raise
                retries += 1
                self.recover()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.wall_s += time.perf_counter() - t0
        return self.stats
