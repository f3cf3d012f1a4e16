"""Generation engine, synchronous loop (counterpart of mfa_tpu/serve/engine.py).

Step shape: release finished slots -> admit -> prefill admitted prompts
(kernels 2 + 3 in bf16, else 1, writes KV pages; image prompts, with vision=, in a wave of
their own through the vision tower and the image-block kernel) ->
advance every
in-progress long prompt or prefix-cache suffix by one chunk (kernel 8,
write-then-attend) -> map pages for the next position -> one batched
decode step over the requests whose prefill is complete (kernel 6) ->
greedy sample -> append / finish. Decode and chunk batches are padded to
power-of-two buckets, the padding rows pointing at a free scratch slot, as
in the JAX engine.

Not ported yet (raise NotImplementedError): decode bursts, the pipelined
loop, speculative decoding, recovery and meshes.
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
    prefill_batches: int = 0  # prefill_batch calls, image waves included
    chunk_batches: int = 0  # prefill_chunk_batch calls
    # the image waves among prefill_batches: their calls, prompt tokens
    # and host seconds (also counted in prefill_tokens / prefill_s)
    image_batches: int = 0
    image_prefill_tokens: int = 0
    image_prefill_s: float = 0.0
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
        """One engine iteration: admit, prefill, one chunk of every
        in-progress chunked prefill, batched decode step."""
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
