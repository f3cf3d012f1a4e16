"""Generation engine (counterpart of mfa_tpu/serve/engine.py).

Step shape: release finished slots -> admit -> prefill admitted prompts
(kernels 2 + 3 in bf16, else 1, writes KV pages; image prompts, with vision=, in a wave of
their own through the vision tower and the image-block kernel) ->
advance every
in-progress long prompt or prefix-cache suffix by one chunk (kernel 8,
write-then-attend) -> map pages for the next position(s) -> batched
decode over the requests whose prefill is complete (kernel 6; kernel 10
on int8 weights) -> sample -> append / finish. The KV pages are
bf16, or int8, fp8 (e4m3) or int4 with fp32 row scales (quant_dtype;
"auto" picks by the cache capacity a sequence can reach,
dispatch/config.py:recommend_kv_quant), and kernels 6 and 8 read every
format in place. Decode and chunk
batches are padded to power-of-two buckets, the padding rows pointing at
a free scratch slot, as in the JAX engine.

Decode runs one step at a time (run()), in bursts of up to n steps with
one token readback each (run(burst=n, pipeline=False): step_burst), or
with up to PIPELINE_DEPTH bursts in flight (run(burst=n): the pipelined
loop). On the card every decode step replays the CUDA graph of its batch
bucket (serve/graphs.py). run(max_retries=k) recovers from a failed step
(recover()) up to k times.

Sampling (serve/sampling.py): the engine's SamplingParams (temperature,
top-k, top-p, min-p, repetition penalty) and per-request overrides
(submit(sampling=): per-row vectors in one sampler, top-k engine-wide),
with randomness from one seeded torch.Generator on the engine's device;
the repetition penalty reads device presence rows per slot, marked as
prompts admit and tokens sample. Speculative decoding (draft_params=,
draft_cfg=, spec_tokens=): a draft model with its own cache over the same
pages proposes spec_tokens tokens, the target scores them in one
verify_step (kernel 6 on a span of queries), and rejected ones roll back
by a lengths reset; greedy engines run n_iters draft / verify / accept
iterations on the device per readback (graphed on the card), sampled ones
step on the host with the rejection rule (speculative_accept).

Meshes (mesh=, shard/mesh.py): SPMD tensor parallelism. Every rank builds
an Engine over its own params shard (llama.shard_params /
init_params(mesh=)) and a cache of its own kv heads, and gets the same
submits: the scheduler, block tables and page ids are replicated and
deterministic, so every rank steps the same batches. The projections'
partial sums are all-reduced over "model", so the logits, and greedy and
seeded sampled tokens, are equal on every rank; each readback checks that
(a RuntimeError if not). Decode graphs are captured only when the mesh
can be captured (NCCL, or one rank an axis); under gloo with more ranks
the steps run eagerly and stats.captures stays 0.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from mfa_tpu_torch.cache.paged_cache import map_pages, release_slots
from mfa_tpu_torch.dispatch.config import (host_to_device,
                                           recommend_kv_quant, resolve_device)
from mfa_tpu_torch.models import llama
from mfa_tpu_torch.serve.graphs import DecodeGraphs, SpeculativeGraphs
from mfa_tpu_torch.serve.sampling import (SamplingParams, gumbel_from_uniform,
                                          sample, sample_dynamic,
                                          speculative_accept, token_logprobs,
                                          uniform_noise)
from mfa_tpu_torch.serve.scheduler import Request, Scheduler
from mfa_tpu_torch.shard.mesh import MODEL_AXIS, assert_replicated, axis_size


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
    # speculative decoding: draft tokens proposed and accepted
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def spec_acceptance(self) -> float:
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.wall_s if self.wall_s else 0.0


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
        draft_cfg: Optional[llama.LlamaConfig] = None,
        spec_tokens: int = 4,
        vision=None,
        seed: int = 0,
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
        the prompt).

        quant_dtype: None (pages in the model dtype), "int8", "fp8",
        "int4" or "auto" (recommend_kv_quant(pages_per_seq * page_size),
        as the JAX engine resolves it).

        sampling: the engine's SamplingParams (default greedy); seed: of
        the engine's torch.Generator, on `device`. draft_params /
        draft_cfg (on `device`): speculative decoding with spec_tokens
        proposals an iteration; the draft shares the target's vocabulary,
        pages and tables, and refuses the repetition penalty, per-request
        sampling and image prompts, as mfa_tpu's does.

        mesh: a DeviceMesh with a "model" axis (and "expert" for MoE banks)
        for tensor-parallel serving (module docstring); params (and
        draft_params) are then this rank's shard, the cache holds this
        rank's kv heads, and every rank makes the same calls. A "data" axis
        replicates."""
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh (shard/mesh.py:"
                                f"make_mesh), got {type(mesh).__name__}")
            for p, c in ((params, cfg), (draft_params, draft_cfg)):
                if p is None:
                    continue
                llama._check_stack(p, c)
                llama._check_heads(c, mesh)
                want = c.n_kv_heads // axis_size(mesh, MODEL_AXIS) * c.head_dim
                if p["layers"][0]["wk"].shape[-1] != want:
                    raise ValueError(
                        "Engine(mesh=) takes this rank's params shard "
                        "(llama.shard_params or init_params(mesh=)): wk has "
                        f"{p['layers'][0]['wk'].shape[-1]} columns, the "
                        f"rank's kv heads {want}")
        self.mesh = mesh
        if prefill_chunk is not None and prefill_chunk % page_size != 0:
            raise ValueError("prefill_chunk must be a multiple of page_size")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        if quant_dtype == "auto":
            quant_dtype = recommend_kv_quant(pages_per_seq * page_size)
        self.quant_dtype = quant_dtype
        self.params = params
        self.cache = llama.build_kv_caches(
            cfg, num_pages, page_size, max_seqs, pages_per_seq, quant_dtype,
            device=self.device, mesh=mesh)
        self.sched = Scheduler(max_seqs, pages_per_seq, page_size, num_pages,
                               prefix_cache=prefix_cache)
        self.sampling = sampling or SamplingParams()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the repetition penalty's context mask, one row per slot: marked as
        # prompts admit and tokens sample, gathered per batch, cleared per
        # admission wave (mfa_tpu's _pres_dev)
        self._pres_dev = (self._new_presence(max_seqs, cfg.vocab_size)
                          if self.sampling.needs_presence else None)
        self.stats = EngineStats()
        self.graphs = DecodeGraphs(params, cfg, self.device, self.stats,
                                   self.sampling, mesh)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_tokens = spec_tokens
        self.draft_cache = None
        self.spec_graphs = None
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            if self.sampling.needs_presence:
                raise ValueError(
                    "speculative decoding does not support the repetition "
                    "penalty (verification is context-free)")
            self.draft_cache = llama.build_kv_caches(
                draft_cfg, num_pages, page_size, max_seqs, pages_per_seq,
                quant_dtype, device=self.device, mesh=mesh)
            self.spec_graphs = SpeculativeGraphs(
                params, draft_params, cfg, draft_cfg, self.device, self.stats,
                mesh)
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

    def _new_presence(self, rows: int, vocab: int) -> torch.Tensor:
        return torch.zeros((rows, vocab), dtype=torch.bool, device=self.device)

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_token: Optional[int] = None,
               stop: Optional[List[List[int]]] = None,
               sampling: Optional[SamplingParams] = None,
               images=None) -> Request:
        """stop: token-id sequences that end generation when the output ends
        with one of them (the matched tokens stay in the output).
        sampling: a per-request SamplingParams (temperature, top_p, min_p,
        repetition_penalty; top_k stays the engine's); a batch mixing
        requests runs one sampler with per-row vectors.
        images: [n_images, 3, H, W] pixels matching the prompt's <image>
        placeholder runs (needs the engine's vision= tuple); image prompts
        prefill whole (never chunked) and never share prefix pages."""
        if images is not None:
            if self.vision is None:
                raise ValueError(
                    "images= requires an Engine vision= tuple "
                    "(vision_params, vision_cfg, image_token_id)")
            if self.draft_params is not None:
                raise ValueError(
                    "speculative decoding does not support image prompts "
                    "(the draft model has no vision tower)")
            image_tok, vcfg = self.vision[2], self.vision[1]
            n_img = images.shape[0]
            placeholders = sum(1 for t in prompt if t == image_tok)
            if placeholders != n_img * vcfg.mm_tokens_per_image:
                raise ValueError(
                    f"{n_img} images need {n_img * vcfg.mm_tokens_per_image} "
                    f"<image> tokens (id {image_tok}), the prompt has "
                    f"{placeholders}")
        if sampling is not None:
            if self.draft_params is not None:
                raise ValueError("per-request sampling is incompatible "
                                 "with speculative decoding")
            if sampling.needs_presence and self._pres_dev is None:
                # rows of requests without a penalty stay zero and their
                # penalty is 1, so a mask made late is sound
                self._pres_dev = self._new_presence(self.sched.max_seqs,
                                                    self.cfg.vocab_size)
        req = Request(self._next_uid, list(prompt), max_new_tokens,
                      eos_token, stop=stop, sampling=sampling, images=images)
        self._next_uid += 1
        self.sched.submit(req)
        self._stream_pos[req.uid] = 0
        self._all_reqs[req.uid] = req
        return req

    def abandon(self, uids) -> None:
        """Drop the streaming bookkeeping of requests whose clients are gone
        (the server's failure path): requests that never reach `done`
        would otherwise stay in _all_reqs and _stream_pos for good."""
        for uid in list(uids):
            self._stream_pos.pop(uid, None)
            self._all_reqs.pop(uid, None)

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

    def _check_replicated(self, tokens_np) -> None:
        """Under a "model" axis every rank must read back the same tokens
        (SPMD: the same logits after the all-reduce, the same generator)."""
        if axis_size(self.mesh, MODEL_AXIS) > 1:
            t = torch.as_tensor(tokens_np)
            if self.device.type == "cuda":
                t = t.to(self.device)
            assert_replicated(t, self.mesh, MODEL_AXIS, "sampled tokens")

    def _sample(self, logits, presence=None, vecs=None):
        """-> host (ids [n], logprobs [n]); logprobs under the unfiltered
        model distribution. presence: [n, vocab] rows; vecs: per-row
        parameter vectors (_sampling_vecs)."""
        gumbel = None
        if llama.needs_noise(self.sampling, vecs):
            gumbel = gumbel_from_uniform(uniform_noise(
                tuple(logits.shape), self.generator, logits.device))
        if vecs is not None:
            ids = sample_dynamic(logits, gumbel, *vecs,
                                 top_k=self.sampling.top_k, presence=presence)
        else:
            ids = sample(logits, self.sampling, presence, gumbel)
        lps = token_logprobs(logits, ids)
        ids = ids.cpu().numpy()
        self._check_replicated(ids)
        return ids, lps.cpu().numpy()

    def _sampling_vecs(self, reqs, rows: int) -> Optional[torch.Tensor]:
        """Per-row (temperature, top_p, min_p, repetition_penalty) [4, rows]
        fp32 on the device when any request overrides the engine's
        sampling, else None. Padding rows take the engine's."""
        if not any(r.sampling is not None for r in reqs):
            return None
        d = self.sampling
        vecs = np.zeros((4, rows), np.float32)
        vecs[:] = np.array([d.temperature, d.top_p, d.min_p,
                            d.repetition_penalty], np.float32)[:, None]
        for i, r in enumerate(reqs):
            s = r.sampling or d
            vecs[:, i] = (s.temperature, s.top_p, s.min_p,
                          s.repetition_penalty)
        return host_to_device(vecs, torch.float32, self.device)

    def _pres_rows(self, slots) -> Optional[torch.Tensor]:
        """The presence rows of a batch's slots (a fresh [n, vocab] tensor),
        or None when the sampler needs none."""
        if self._pres_dev is None:
            return None
        return self._pres_dev[self._upload(np.asarray(slots))]

    def _pres_mark(self, slots, tokens) -> None:
        """Mark token ids present for their slots (one device scatter)."""
        if self._pres_dev is None or len(slots) == 0:
            return
        self._pres_dev[self._upload(np.asarray(slots)),
                       self._upload(np.asarray(tokens))] = True

    def _pres_mark_context(self, reqs) -> None:
        """Mark each request's context (prompt + generated so far)."""
        if self._pres_dev is None:
            return
        slots, toks = [], []
        for r in reqs:
            ctx = r.prompt + r.generated
            slots.extend([r.slot] * len(ctx))
            toks.extend(ctx)
        self._pres_mark(slots, toks)

    def _prefill_admitted(self, reqs: List[Request]) -> None:
        """Prefill all newly admitted prompts in one batched pass, the image
        prompts in a second one. Long text prompts (past prefill_chunk) and
        prefix-cache hits, whose suffix starts at a page-aligned offset, go
        to the chunked path instead; image prompts always prefill whole
        (the image-block mask needs every prompt row in one pass). Resumed
        (preempted) requests re-prefill their prompt plus all but the last
        generated token, with their images; the last one replays through
        the decode step."""
        if not reqs:
            return
        if self._pres_dev is not None:
            # a reused slot may carry a finished request's bits: rows are
            # cleared per admission wave, not when a request finishes
            self._pres_dev[self._upload(np.asarray([r.slot for r in reqs]))] = False
        self._pres_mark_context(reqs)  # prompts count for the penalty
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
                pixel_lists=[r.images for r in group] if vision else None,
                mesh=self.mesh)
            if self.draft_cache is not None:
                self.draft_cache, _ = llama.prefill_batch(
                    self.draft_params, self.draft_cfg, self.draft_cache,
                    [r.slot for r in group], [r.pages for r in group],
                    token_lists, mesh=self.mesh)
            firsts, first_lps = self._sample(
                logits, self._pres_rows([r.slot for r in group]),
                self._sampling_vecs(group, len(group)))
            self._pres_mark(
                [r.slot for r in group if not r.generated],
                [int(f) for r, f in zip(group, firsts) if not r.generated])
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
        self._map(m_slots, m_idx, m_ids)

    def _map(self, m_slots, m_idx, m_ids) -> None:
        """Map pages into both caches' tables (the draft's too)."""
        if not m_slots:
            return
        self.cache = map_pages(self.cache, m_slots, m_idx, m_ids)
        if self.draft_cache is not None:
            self.draft_cache = map_pages(self.draft_cache, m_slots, m_idx,
                                         m_ids)

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
            offs, totals, chunk, self.mesh)
        if self.draft_cache is not None:
            self.draft_cache, _ = llama.prefill_chunk_batch(
                self.draft_params, self.draft_cfg, self.draft_cache, slots,
                pages_l, chunk_toks, offs, totals, chunk, self.mesh)
        # logits carry the padded bucket rows; sample only the real items
        reqs = [it[0] for it in items]
        ids, lps = self._sample(logits[: len(items)],
                                self._pres_rows([r.slot for r in reqs]),
                                self._sampling_vecs(reqs, len(items)))
        self.stats.chunk_batches += 1
        self.stats.prefill_s += time.perf_counter() - t0
        mark_slots, mark_toks = [], []
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
                mark_slots.append(req.slot)
                mark_toks.append(int(ids[i]))
                self.stats.decode_tokens += 1
            if req.done:
                self._finish(req)
        self._pres_mark(mark_slots, mark_toks)

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

    def _to_host(self, *tensors):
        """Start copies of device tensors to pinned host memory without
        waiting. -> (host tensors, an event to wait on, or None on the
        CPU)."""
        if self.device.type != "cuda":
            return tensors, None
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        event = torch.cuda.Event()
        event.record()
        return tuple(out), event

    def _dispatch(self, active, n_eff: int, slots, scratch, tokens,
                  presence=None) -> dict:
        """Enqueue an n_eff-step decode burst of `active` (slots from
        _pad_batch; tokens on the host or, chained, on the device; presence:
        the rows' presence [nb, vocab], marked in place by the burst) and
        the copy of its tokens and logprobs to pinned host memory, without
        waiting for either. -> the burst record for _process_burst_result."""
        t0 = time.perf_counter()
        if not isinstance(tokens, torch.Tensor):
            tokens = self._upload(tokens)
        toks, lps = self.graphs.burst(
            self.cache, self._upload(slots), tokens, n_eff, presence,
            self._sampling_vecs(active, len(slots)), self.generator)
        (toks_h, lps_h), event = self._to_host(toks, lps)
        for r in active:
            r.inflight += n_eff
        self.stats.decode_s += time.perf_counter() - t0
        return dict(active=list(active), n_eff=n_eff, toks=toks, toks_h=toks_h,
                    lps_h=lps_h, event=event, slots=slots, scratch=scratch,
                    pres=presence)

    def _process_burst_result(self, d) -> None:
        """Wait for one burst's readback and append its tokens. Rows that
        finish mid-burst (eos, stop, budget) drop the tokens past it; their
        spare appends went to pages of the slot released next."""
        t0 = time.perf_counter()
        if d["event"] is not None:
            d["event"].synchronize()
        toks_np, lps_np = d["toks_h"].numpy(), d["lps_h"].numpy()
        self._check_replicated(toks_np)
        self.stats.readbacks += 1
        self.stats.steps += d["n_eff"]
        mark_slots, mark_toks = [], []
        for i, req in enumerate(d["active"]):
            req.inflight = max(0, req.inflight - d["n_eff"])
            was_done = req.done  # finished in an earlier processed burst
            for t, lp in zip(toks_np[:, i], lps_np[:, i]):
                if req.done:
                    break
                req.generated.append(int(t))
                req.logprobs.append(float(lp))
                mark_slots.append(req.slot)
                mark_toks.append(int(t))
                self.stats.decode_tokens += 1
            if req.done and not was_done:
                self._finish(req)
        self._pres_mark(mark_slots, mark_toks)
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
        self._process_burst_result(self._dispatch(
            active, 1, slots, scratch, tokens, self._pres_rows(slots)))

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
        self._process_burst_result(self._dispatch(
            active, n_eff, slots, scratch, tokens, self._pres_rows(slots)))

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
            self._map(m_slots, m_idx, m_ids)
            return None
        self._map(m_slots, m_idx, m_ids)

        slots, tokens_host, scratch = self._pad_batch(active)
        pres = None
        if (prev is not None and len(prev["active"]) == len(active)
                and all(a is b for a, b in zip(prev["active"], active))
                and np.array_equal(prev["slots"], slots)):
            # the rows of the burst in flight: chain its last tokens (and
            # its burst-final presence rows)
            tokens = prev["toks"][-1]
            pres = prev["pres"]
        elif any(r.inflight for r in active):
            if self._pres_dev is not None:
                return None  # presence cannot chain across a row change
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
            pres = self._pres_rows(slots)
        return self._dispatch(active, n_eff, slots, scratch, tokens, pres)

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
            # nothing could be dispatched with the pipeline empty (page
            # pressure, or presence rows across a row change)
            self.step_burst(n)

    def _run_pipelined(self, burst: int) -> None:
        """Drain all work with up to PIPELINE_DEPTH decode bursts in flight
        (see the block comment above)."""
        while self.sched.has_work or self._pending_bursts:
            if not (self._pending_bursts or self._decode_ready()
                    or self.sched.waiting or self._prefilling):
                return
            self.step_pipelined(burst)

    # ---- speculative decoding -----------------------------------------

    def step_speculative(self) -> None:
        """One speculative step (mfa_tpu's step_speculative): admit +
        prefill both models, then the draft proposes k tokens, the target
        verifies the span in one verify_step, the accepted tokens are
        emitted and the rest rolled back by a lengths reset. Greedy
        engines run n_iters such iterations on the device per readback
        (SpeculativeGraphs; output equal to plain greedy decoding of the
        target); sampled engines run one, stepped on the host, with the
        rejection rule. k and n_iters are powers of two capped by every
        row's table headroom: a span write past the table would land in
        the row's own live last page."""
        self._flush_released()
        self._prefill_admitted(self.sched.admit())
        self._advance_chunked_prefill()
        active = self._decode_ready()
        if not active:
            return
        capacity = self.sched.pages_per_seq * self.page_size
        headroom = min(capacity - (r.total_len - 1) for r in active)
        k = min(self.spec_tokens, headroom)
        if k < 2:  # no room to speculate: one plain step
            self._map_new_pages(1)
            active = self._decode_ready()
            if active:
                self._decode_active(active)
            return
        k = 1 << (k.bit_length() - 1) if k < self.spec_tokens else k
        n_iters = 1
        if self.sampling.greedy:
            # every iteration may accept all k: n_iters fits the headroom
            n_iters = max(1, min(4, headroom // k))
            n_iters = 1 << (n_iters.bit_length() - 1)
        self._map_new_pages(n_iters * k)
        active = self._decode_ready()  # the mapping may preempt
        if not active:
            return
        slots, tokens, scratch = self._pad_batch(active)
        slots_d, toks_d = self._upload(slots), self._upload(tokens)
        t0 = time.perf_counter()
        if self.sampling.greedy:
            outs = self.spec_graphs.burst(self.cache, self.draft_cache, slots_d,
                                          toks_d, k, n_iters)
            hosts, event = self._to_host(*outs)
            if event is not None:
                event.synchronize()
            t_np, lp_np, ne_np, m_np = (h.numpy() for h in hosts)
        else:
            t_np, lp_np, ne_np, m_np = self._sampled_iteration(
                slots_d, toks_d, len(active), k)
        self._check_replicated(t_np)
        self.stats.readbacks += 1
        self.stats.steps += n_iters
        self.stats.decode_s += time.perf_counter() - t0
        for i, req in enumerate(active):
            for it in range(n_iters):
                if req.done:
                    break  # iterations past eos (the slot is released)
                self.stats.spec_proposed += k
                self.stats.spec_accepted += int(m_np[it, i])
                for j in range(int(ne_np[it, i])):
                    if req.done:
                        break
                    req.generated.append(int(t_np[it, i, j]))
                    req.logprobs.append(float(lp_np[it, i, j]))
                    self.stats.decode_tokens += 1
            if req.done:
                # the device lengths ran past eos; releasing the slot
                # makes those rows dead
                self._finish(req)
        if scratch is not None:
            self._to_release.append(scratch)

    def _sampled_iteration(self, slots_d, toks_d, n_act: int, k: int):
        """One sampled speculative iteration, stepped on the host: the draft
        samples k tokens keeping its logits, the target verifies [t, d_1 ..
        d_{k-1}], speculative_accept applies the rejection rule, and both
        caches roll back to base + n_emit. -> host arrays shaped as
        SpeculativeGraphs.burst's with n_iters 1."""
        _, d_toks, _, d_logits = llama.decode_burst(
            self.draft_params, self.draft_cfg, self.draft_cache, slots_d,
            toks_d, k, self.sampling, self.generator, return_logits=True,
            mesh=self.mesh)
        feed = torch.cat([toks_d[None], d_toks[:-1]], dim=0).T  # [nb, k]
        _, logits = llama.verify_step(self.params, self.cfg, self.cache,
                                      slots_d, feed, self.mesh)  # [nb, k, vocab]
        t_dev, m_dev = speculative_accept(d_logits.transpose(0, 1), logits,
                                          d_toks.T, self.sampling,
                                          self.generator)
        lp_dev = token_logprobs(logits, t_dev)
        n_emit = torch.where(m_dev < k, m_dev + 1, torch.full_like(m_dev, k))
        # rows past the active ones are the scratch slot's: length 0
        new_lens = self.cache.lengths[slots_d].long() - k + n_emit
        new_lens[n_act:] = 0
        llama.rollback(self.cache, slots_d, new_lens)
        llama.rollback(self.draft_cache, slots_d, new_lens)
        hosts, event = self._to_host(t_dev, lp_dev, n_emit, m_dev)
        if event is not None:
            event.synchronize()
        return tuple(h.numpy()[None] for h in hosts)

    def _finish(self, req: Request) -> None:
        slot = req.slot
        self.sched.finish(req)
        self._to_release.append(slot)

    def _flush_released(self) -> None:
        """Batched device-metadata clear of finished slots: one scatter pair
        (a pair a cache) however many requests finished since the last
        flush."""
        if not self._to_release:
            return
        slots = self._to_release
        self._to_release = []
        self.cache = release_slots(self.cache, slots)
        if self.draft_cache is not None:
            self.draft_cache = release_slots(self.draft_cache, slots)


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
        if self._pres_dev is not None:
            self._pres_dev.zero_()
        c0 = self.cache
        shape = (c0.num_pages, c0.page_size, c0.lengths.shape[0],
                 c0.pages_per_seq, c0.quant_dtype)
        self.cache = c0 = None  # free the old pools before the new ones
        self.cache = llama.build_kv_caches(self.cfg, *shape,
                                           device=self.device, mesh=self.mesh)
        if self.draft_cache is not None:
            self.spec_graphs.reset()
            self.draft_cache = None
            self.draft_cache = llama.build_kv_caches(
                self.draft_cfg, *shape, device=self.device, mesh=self.mesh)
        for req in reversed(active):
            self.sched.waiting.appendleft(req)
        self.stats.recoveries += 1
        return len(active)

    def run(self, max_retries: int = 0, burst: int = 1,
            pipeline: bool = True) -> EngineStats:
        """Drain all work (mfa_tpu's run). With a draft model every step is
        step_speculative. Else with burst > 1, up to `burst` decode steps
        run on the device between token readbacks (step_burst), and with
        pipeline (the default) up to PIPELINE_DEPTH bursts stay in flight
        (_run_pipelined). A failing step triggers recover() and the work
        restarts, up to max_retries times; then the failure raises."""
        t0 = time.perf_counter()
        retries = 0
        while self.sched.has_work:
            try:
                if self.draft_cache is not None:
                    self.step_speculative()
                elif burst > 1 and pipeline:
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
