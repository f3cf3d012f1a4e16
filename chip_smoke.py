#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mfa_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Build every kernel from mfa_tpu_torch/csrc with nvcc (sm_90a).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes: max/mean abs error within bf16 tolerances (max < 2e-2,
   mean < 2e-3, SURVEY.md §4; the plain version runs on the same inputs
   upcast to fp32; LSE within 1e-3 with the same -inf rows), and times with
   CUDA events: kernel, plain version, one PyTorch library call for the
   same function where one exists (a yardstick only: the port never calls
   it), and the least time the card could take (bytes over 3.35 TB/s vs
   operations over 989 TFLOP/s, counting the work these inputs need).
   Kernels: prefill, split-KV decode, one launch with the split merge
   inside it (b16 S8192 d128 at the default split count and 2, the merge
   printed bit-equal or not to the two-launch design's arithmetic on the
   launch's own partials; then a long cache, b1 S32768, at d 64, 128 and
   256, groups 1, 2, 4 and 8, window and softcap, lengths 0, 1 and off the
   64-token tile, rows past a length NaN), paged decode, varlen (at d
   128 and 256; on equal lengths bit for bit equal to kernel 1, O and LSE)
   and paged prefill (also Gemma3-4B's chunk batch at head_dim 256 on
   int8 pages, causal and window 1023, and on bf16, fp8 and int4 pages,
   rows past each length poisoned); the five backward launches (fused,
   the dK/dV + dQ split, the varlen split) within max |a - r| <= 2e-2 max
   |r| and mean |a - r| <= 2e-2 mean |r| for each of dq, dk, dv, and fused
   against split, also at Gemma3-4B's train shape (b4 hq8 hkv4 s2048
   d256, causal and window (1023, 0); the split the same bits twice,
   kernel 14 on 4 x 2048 bit-equal to 12 + 13, SDPA's backward with a band
   mask beside them); at
   Gemma3-4B's head_dim 256, prefill (causal, window 1023 and none) and
   paged decode (int8 and bf16 pages, group 2, window 1023: 40 blocks, so
   the paged kernel splits each sequence and merges the splits in its one
   launch),
   and the image-block prefill (kernel 9) in four cases, one of them with
   no image within the limits of kernel 1's causal output (kernels 1-4, 7
   and 9 run the wgmma + TMA tile); the zero-shift engines
   (kernels 2, 3, 4: flagged + repair at the 8B wave, at 4096 tokens and at
   Gemma3-4B's text wave, with 0 flags on benign inputs and flags, a
   repaired output and an "unchecked" output off the limits on adversarial
   ones; the bound kernel with and without risky bits; fp16 through kernel
   1); and the int8 weight matmul (kernel 10) at w_gate for m = 1, 17, 64,
   255, 256 and 3601 in fp16 x and fp32 out, and at the 8B projections for
   m = 16 and 3601 (limit: 2^-8 of the largest output; cuBLAS on the
   dequantized bf16 weight as the yardstick); kernels 6 and 8 on fp8 (e4m3)
   and int4 pages (kernel 6 at the 8B serve step, lengths 8192, Gemma3's
   d 256 step with 3 splits, a window with a softcap and d 64; kernel 8 at
   the chunk batch), with NaN scales and, for fp8, the NaN code 0x7F in
   the rows past each length; kernel 6 on multi-query spans (q [b,
   q_span, hq, d], launch name paged_span: 8 cases of q_span x group up
   to 32 rows over bf16, int8, fp8 and int4 pages at d 64, 128 and 256,
   rows past each length poisoned, each span row against a q_span 1 call
   at its own length) and with 16 q heads a kv head, timed at the 8B
   verify shape beside q_span 1; the dense families' shapes
   (family_kernels): kernel 8 at Qwen2-7B's chunk batch (7 q heads a kv
   head, a group that does not divide the kernel's 64 rows) beside group 8
   on the same positions, groups 5 and 6 on bf16, fp8 and int4 pages,
   Gemma2-9B's batch (d 256, softcap 50, window 4095 and none); kernel 6 at
   both models' decode steps; kernel 1 at the Gemma2-9B wave (softcap) and
   kernels 2 + 3 at Qwen2-7B's; kernel 10's expert-bank launch
   (moe_kernels, launch name wmatmul_bank): the dense form at Mixtral-8x7B's
   decode step (m 16, 8 experts, gate/up over shared rows, down over each
   expert's), the grouped form at a wave's 7202 expert-sorted rows (one
   empty expert, one of a single row) and at a 4 x 512 chunk batch, and K /
   N tails, within 2^-8 of the largest output, beside torch.matmul on the
   bf16-dequantized bank. Then (sinks_kernels) the band options at the 8B's
   heads and at d 256: kernels 1-4 with 4 attention sinks and window (4095,
   0) at b1 s8192, kernel 1 with ALiBi (slopes 2^(-8 (h + 1) / 32)) at b16
   s256 and b1 s4096 and with kv_position_offset 1024, kernel 7 with sinks
   and ALiBi on the ragged pack, kernels 5 and 6 with sinks (window 4095)
   and ALiBi at lens 8192 (int8, int4 and bf16 pages, a span of 4),
   kernel 8 with sinks at the chunk batch past position 4096, kernels
   11-14 with ALiBi, 11 with sinks and 11-13 with the offset; SDPA with the
   equivalent bool mask or float bias as the library time. Then
   (fp32_kernels) every forward kernel on fp32 inputs against its plain
   fp32 version, TF32 off: kernels 1, 2 + 3 and 3 alone at the 8B wave and
   a 4096-token prompt (0 flags on benign inputs; on std-1e3 and shifted
   ones the plain version's flags, > 0, and every flagged tile equal to
   kernel 1 bit for bit), kernel 4 at d 64 and BASELINE's first config
   (and on std-1e3 and shifted inputs against an fp64 reference),
   kernel 5 at b16 S8192 (one split and two), kernel 6 with fp32 q on fp32,
   int8, fp8 and int4 pages, kernel 7 packed and ragged, kernel 8 at the
   chunk batch on every page format, kernel 9 at Gemma3-4B's image wave;
   within atol = rtol = 1e-4 (quantized pages: the bf16-q limits), timed
   against bounds of 4-byte rows at 3.35 TB/s and operations at 165
   TFLOP/s (TF32's 495 over three passes) and SDPA in fp32. Then
   (fp32_backward_kernels) kernels 11-14 on fp32 inputs (the mma.sync
   3xTF32 tile of csrc/flash_bwd_f32.cuh) against the plain fp32
   backward: the 8B train
   shape, d 64 / 80 / 256, Gemma3-4B's window, sinks, ALiBi, the offset,
   softcap 50, group 7, kernel 14 on 8 x 512 (bit for bit 12 + 13) and the
   ragged pack, each of dQ, dK, dV within allclose(rtol 1e-4, atol 1e-4
   max |ref|), SDPA's fp32 backward as the library time; and
   (fp32_wmatmul_kernels) kernel 10 and its expert launch on fp32 x (three
   bf16 parts) at the 8B projections and Mixtral's decode and wave shapes
   within 1e-5 of the largest output, bounds at 330 TFLOP/s (three bf16
   passes), torch.matmul on the fp32-dequantized weight as the library.
3. The main path, each part with every launch count zeroed just before it
   and read just after: the library surface (flash_attn_func,
   flash_attn_varlen_func packed and paged, flash_attn_with_kvcache
   contiguous and paged, and the gradient functions flash_attn_func_grad,
   flash_attention_bwd(fused=False), flash_attn_varlen_func_grad); the
   per-layer paged KV cache (layer_cache: create_cache, write_prompt,
   map_page, append_token under kernel 6 for 16 sequences of 200-4000
   tokens and 32 steps, at Llama-3-8B's and H2O-Danube's attention widths,
   pages of 64 and 16, bf16 / int8 / fp8 / int4, each step against the
   plain version, then the card's pages and scales against the CPU's
   writes of the same K/V: none may differ); the
   serving engine at Llama-3-8B width (32 layers, random bf16 weights from
   a seed, int8 paged KV, page 64) answering 16 requests of 200-256 prompt
   tokens and 32 new tokens each (every engine's decode steps replay the
   CUDA graph of their batch bucket, serve/graphs.py; the launch counts
   include the replays), and once more with the graphs off for the eager
   decode rate (same tokens); then the same weights and traffic on fp8
   and then int4 KV pages (kernel 6 on those pages from the graphs; rates,
   KV bytes per token and peak memory beside the int8 run's); then, with
   the same weights, an engine
   with chunked prefill (chunks of 512) and the prefix cache answering 4
   long prompts, 9 prompts that share a 1024-token system prompt and 4
   short ones, on int8, then int4, then fp8 KV; then the first engine's traffic with run(burst=8,
   pipeline=False) and run(burst=8) (up to 8 decode steps a readback, two
   bursts in flight): tokens identical to the stepwise engine's, every
   page returned, nothing in flight; then the 8B's width cut to 4 layers
   on a 40-page int8 pool with the prefix cache (engine_8b_pressure):
   idle prefix pages evicted and requests preempted, stepwise and with
   run(burst=8), every request at its length and every page accounted
   for; then, with the same weights and the
   engines freed, three
   SGD train steps of the full 32-layer model on 4 x 2049 tokens with
   remat (every layer's backward through the fused backward kernel); then,
   with those weights freed, the engine at Gemma3-4B's full width and depth
   (34 layers, head_dim 256, 5 sliding layers of window 1024 to 1 global,
   the 27-layer SigLIP tower at 896 px, random bf16 weights from a seed,
   int8 paged KV) answering 6 image prompts (7 images; two runs start past
   the window) and 4 text prompts, 32 new tokens each: image prompts
   prefill through the tower and kernel 9, text prompts through kernels 2
   + 3 at d 256, every decode step through the paged kernel at d 256; then
   the same Gemma3-4B weights (the tower freed) behind the chunked +
   prefix engine with the 8B's chunked traffic on int8, then int4 and fp8
   KV (kernel 8 at d 256, 34 launches a chunk batch), then three SGD
   train steps of its 34 layers on 4 x 2049 tokens (kernel 11 at d 256,
   34 launches a step); then
   Llama-3-8B again with int8 weights (init_params(quantize="int8")) and
   the traffic of the first engine: every projection through kernel 10.
   Then a full-width 2-layer Qwen2-7B (q/k/v biases drawn) written as a
   Hugging Face checkpoint (safetensors shards, index, config.json) and
   loaded back with from_safetensors in bf16 (bit-equal) and int8 (equal
   to quantize_weight), both loads served with the in-memory weights'
   tokens; then Qwen2-7B (28 layers) and Gemma2-9B (42 layers: softcaps,
   alternating 4096 windows; its waves on kernel 1) at full depth behind
   the chunked + prefix engine with the chunked cell's traffic on int8 KV.
   Then, those weights freed, Mixtral-8x7B at full width and depth (32
   layers, 8 experts, top 2) with int8 weights and expert banks (46.7 GB)
   and int8 KV: the first engine's traffic with run(burst=8) and again
   stepwise with the graphs off (the same tokens; every decode step 96
   expert launches, the dense MoE form; each wave the grouped form), then
   the chunked + prefix traffic; weight bytes against bf16's, peak memory,
   rows an expert takes in a wave. Then, those weights freed, Mistral-7B
   at full width and depth with 4 attention sinks (window 4096, bf16
   weights and KV): 8 prompts of 4200-6000 tokens, 64 new tokens each, with
   run(burst=8), with the graphs off (the same tokens) and with
   attn_sinks=0 (other tokens on at least one request); one 5000-token
   prompt chunked against whole; the chunked + prefix traffic with its
   long prompts past the window; then three SGD train steps of the same
   model on 1 x 8193 tokens (kernel 11 with sinks, 32 launches a step).
   Before the train steps, the first engine's weights and traffic twice
   more: with sampling (engine top-k 50 and a per-request mix of greedy,
   temperature / top-p, temperature / min-p and penalized greedy rows;
   the greedy rows equal the first engine's, one seed gives one stream,
   another seed changes a sampled row), and speculatively (spec_tokens 4,
   a draft of Llama-3.2-1B's widths built here with random weights, then
   the 8B as its own draft, then sampled; verify_step against sequential
   decode steps at 2 layers).
   Then, still before them, the first engine behind the HTTP front end
   (serve/server.py make_server, bursts of 8, pipelined; server_8b): a
   lone request plain and streamed equal to a direct engine's tokens, the
   first engine's 16 prompts from 16 concurrent clients twice (8 streamed,
   4 with logprobs; TTFT p50 / p95 on the client clock and tok/s through
   HTTP, cold while the batch buckets' graphs are captured and warm after
   them), a stop sequence, bad bodies (400), and one failing step with 4
   requests in flight (500 bodies and SSE error events, one recover(),
   the bookkeeping emptied, the next request equal to the direct
   engine's); then the scheduler's host time at that serve's shapes on
   the native allocator and on the Python one.
   The library surface also calls flash_attn_func with a softcap and in
   fp16 (kernel 1) and at head_dim 64 (kernel 4); every bf16 prompt wave
   runs kernels 2 + 3. minimal_fp32 runs BASELINE's first config (fp32,
   non-causal, b2 s128 h8 d64: kernel 4) and tests/test_minimal.py's two
   cases against mfa_tpu_torch/ref/oracle.py within 2e-5, then every
   entry point on fp32 tensors (kernels 1-9 in fp32, no bf16 launch).
   engine_8b_fp32 (after the Danube phases, every earlier weight freed):
   Llama-3-8B in fp32 (32.1 GB of weights, projections in true fp32) with
   the first engine's traffic on fp32 and on int8 KV pages, graphed and
   with the graphs off (the same tokens), then the chunked + prefix
   traffic on int8 KV (kernel 8 with fp32 q); fp32 launches of kernels 2,
   3, 6 and 8. train_8b_fp32: three SGD steps of those fp32
   weights on 4 x 2049 tokens with remat (kernels 2 + 3 and 11 in fp32,
   32.1 GB of gradients beside the weights). engine_8b_fp32_int8w: the
   trained weights quantized to int8 with the embedding kept fp32, so
   every projection runs kernel 10 on fp32 x; the first engine's traffic
   graphed and graphs off (the same tokens). engine_mixtral_fp32: Mixtral
   at full width, 4 layers, int8 weights and banks with an fp32 embedding:
   the expert launch on fp32 x (wmatmul_bank_fp32), graphed and graphs
   off. The library surface in fp32 (minimal_fp32) also takes the
   gradients of BASELINE's first config, of flash_attn_func (fused and the
   split) and of flash_attn_varlen_func (kernels 11-14 in fp32).
   Right after the first engine, the sharding layer (mfa_tpu_torch/shard/):
   tp_engine_8b runs the first engine's weights and traffic behind
   Engine(mesh=) at {"model": 1} over NCCL in this process, graphed
   (tokens identical to the first engine's), then at {"model": 2} on two
   spawned ranks that share the card over gloo (NCCL refuses two ranks on
   one GPU; graphs off), on bf16 and on int8 weights: the ranks' tokens
   identical, the first decode step's logits within relative L2 0.05 of
   the unsharded model's. cp_ring_8b: ring attention prefill (causal and
   window 4095) and its gradient at 8B heads, s 8192, over 4 ranks against
   kernels 1 and 11 unsharded; context_parallel_decode (b16, S 32768) and
   context_parallel_paged_decode (int8 pools) over 2, against kernels 5
   and 6 on the whole cache; sequence_parallel_loss_fn on 2 layers at 8B
   width against loss_fn. ep_mixtral: Mixtral-8x7B's MoE layer (int8
   banks) expert-parallel over 2 ranks, both forms, at 16 and 4096 rows
   against the unsharded routed output. pipeline_8b: a GPipe SGD step of
   4 layers at 8B width over pipe 2, 4 microbatches of 1 x 2048, against
   the unsharded step. The ranks build nothing (the kernels are built
   first) and report their launch counts; their rates are the card's
   shared by ranks over gloo, not multi-GPU rates.
4. The 8B model cut to 2 layers, on the card (kernels) and on the CPU
   (plain versions) with the same weights: prefill, decode, chunked prefill
   and prefix-hit suffix logits agree on int8, fp8 and int4 KV pages, and
   one SGD train step gives the
   same loss and gradients, and a sampled engine step gives the same
   logits; then Gemma3-4B cut to 2 layers (one sliding,
   one global) with a 2-layer tower at 224 px: image-prompt prefill and
   the next decode step's logits agree, and so do a chunked 1200-token
   text prompt's and a prefix hit's (int8 KV); then the 2-layer 8B with int8
   weights: prefill and decode logits agree, argmax equal, and layer 0's
   int8 weights (here and in Mixtral's phase) equal the CPU's quantization
   of the same draw byte for byte; then Qwen2-7B
   and Gemma2-9B at full width cut to 2 layers (int8 KV): prefill, decode,
   chunked and prefix-hit logits agree; then Mixtral-8x7B at full width cut
   to 2 layers with int8 banks: the share of tokens routed to the same top-2
   experts on both devices, and the logits of the tokens routed alike in
   every layer (forward, prefill, decode); then 4 layers of Mixtral's width
   with bf16 banks behind the engine on the card, graphed tokens equal to
   graphs-off tokens; then Mistral-7B at full width cut to 2 layers with a
   window of 64 and 4 sinks: prefill, decode, chunked and prefix-hit
   logits agree (int8 KV); then (cuda_vs_cpu_fp32) 2 layers of the fp32 8B
   at full width on fp32 KV: a prompt wave, four decode steps
   teacher-forced on the card's tokens, two chunks and a prefix-hit suffix,
   every logit row within relative L2 1e-4 of the CPU's; then
   (cuda_vs_cpu_fp32_train) 2 layers of the fp32 8B from the same
   params_from_numpy weights: the int8-weight forward's logits (kernel 10
   on fp32 x) within relative L2 1e-4, and one SGD step on 1 x 257 tokens:
   the loss within relative 1e-5, every gradient within relative L2 1e-4.
5. The instruments (utils/timing.py, utils/profiling.py, utils/native.py):
   the peak table's entries for this card, scan_timeit of the paged
   decode kernel at the 8B serve step within 2x of its CUDA-event time, a
   profiler trace holding an annotation and the kernel's symbol, and the
   g++ runtime's build seconds.
6. A JSON line of per-kernel numbers, the card's name and power limit, and
   last the {"ok": true, "device": ...} line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

SEED = 0
IMAGE_TOKEN = 262144  # Gemma3's <image> soft-token id (image_token_index)


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _time_ms(fn, iters: int = 20) -> float:
    """Device ms per call: a sleep kernel holds the stream while the host
    queues all iterations, so host overhead does not enter the window."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(min(2e9, 2e9 * host_s * iters + 1e7)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float):
    """The least ms the card could take: bytes over the H100 SXM's memory
    rate against operations over its dense bf16 rate (utils/timing.py's
    table), whichever is larger."""
    from mfa_tpu_torch.utils.timing import PEAK_BF16_FLOPS, PEAK_BYTES

    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _visible_pairs(sq: int, sk: int, q_start: int = 0, wl: int = -1,
                   wr: int = -1, sinks: int = 0) -> int:
    """(row, column) pairs a band lets through: row r (position q_start + r)
    sees columns c < sk with pos - wl <= c <= pos + wr (-1 = unbounded),
    and with a left window the columns c < sinks up to its band's end."""
    import numpy as np

    pos = q_start + np.arange(sq)
    hi = np.full(sq, sk - 1) if wr < 0 else np.minimum(sk - 1, pos + wr)
    lo = np.zeros(sq, np.int64) if wl < 0 else np.maximum(0, pos - wl)
    n = np.maximum(0, hi - lo + 1)
    if wl >= 0 and sinks > 0:  # sink columns below the band
        n += np.maximum(0, np.minimum(np.minimum(sinks, lo), hi + 1))
    return int(n.sum())


def _err(out, ref, tol_max=2e-2, tol_mean=2e-3, what=""):
    import torch

    d = (out.float() - ref.float()).abs()
    mx, mean = float(d.max()), float(d.mean())
    ok = bool(torch.isfinite(out.float()).all()) and mx < tol_max and mean < tol_mean
    print(f"  {what}: max_abs_err {mx:.3e} (< {tol_max}) mean {mean:.3e} "
          f"(< {tol_mean}) {'ok' if ok else 'FAIL'}", flush=True)
    return mx, ok


def _lse_err(lse, ref, what=""):
    import torch

    same_inf = torch.equal(torch.isneginf(lse), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    d = float((torch.where(fin, lse, 0) - torch.where(fin, ref, 0)).abs().max())
    ok = same_inf and d < 1e-3
    print(f"  {what} lse: max_abs_err {d:.3e} (< 1e-3), -inf rows match "
          f"{same_inf} {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def _merge_bits(o, lse, partials, dtype):
    """Print whether a split launch's O and LSE are bit-equal to the
    two-launch design's merge (its combine kernel's arithmetic,
    decode._combine_exact) over the launch's own split partials: printed,
    not held here (tests/test_torch_kernels_gpu.py holds it)."""
    from mfa_tpu_torch.kernels import decode

    o_part, lse_part = partials
    b, hkv, _, rows, d = o_part.shape
    hq = o.shape[-2]
    span = rows * hkv // hq
    eo, el = decode._combine_exact(o_part, lse_part, dtype)
    eo = eo.reshape(b, hkv, span, hq // hkv, d).transpose(1, 2).reshape(o.shape)
    el = el.reshape(b, hkv, span, hq // hkv).transpose(1, 2).reshape(lse.shape)
    n_o, n_l = int((o != eo).sum()), int((lse != el).sum())
    print(f"  one launch vs the two-launch merge on its {lse_part.shape[2]} splits' "
          f"partials: bit-equal {n_o == 0 and n_l == 0} ({n_o} of {o.numel()} O and "
          f"{n_l} of {lse.numel()} LSE values differ)", flush=True)
    return n_o == 0 and n_l == 0


def _wave_launches(got, n, softcap=False, head_dim=128, suffix=""):
    """A bf16 prompt wave runs the default engine: n zero-shift launches,
    each followed by its repair launch, and kernel 1 not at all; with an
    attention softcap (Gemma2) the classic engine: n kernel 1 launches and
    no zero-shift one; at a head_dim that is not a multiple of 128
    (H2O-Danube's 80) the bound prepass: n kernel 4 launches, as mfa_tpu
    selects it. suffix "_fp32": the same launches of the fp32 tile."""
    def n_of(name):
        return got.get(name + suffix, 0)

    if softcap:
        return n_of("prefill") == n and not n_of("flagged") and not n_of("repair")
    if head_dim % 128:
        return n_of("bound") == n and not n_of("flagged") and not n_of("prefill")
    return n_of("flagged") == n and n_of("repair") == n and not n_of("prefill")


def kernel_phase(records):
    """Phase 2. Fills records[name] with errors and times; returns ok."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import decode, paged, prefill
    from mfa_tpu_torch.kernels.quant import quantize_rows

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    ok = True
    # -- kernel 1: prefill (main path: 16 prompts x 256, Llama-3-8B heads)
    d = 128
    for b, hq, hkv, s in ((16, 32, 8, 256), (1, 32, 8, 4096)):
        q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
        scale = d ** -0.5
        o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                           bound_softmax=False)
        ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), scale,
                                        -1, 0, 0.0, True)
        tag = f"prefill (kernel 1) causal b={b} hq={hq} hkv={hkv} s={s} d={d} bf16"
        print(tag, flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        ms = _time_ms(lambda: prefill.prefill_attention(q, k, v, causal=True,
                                                        bound_softmax=False))
        plain_ms = _time_ms(lambda: prefill._prefill_plain(
            q, k, v, scale, -1, 0, 0.0, False), iters=3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        pairs = s * (s + 1) / 2
        bound_ms, by = _bound(2 * (2 * b * hq * s * d + 2 * b * hkv * s * d),
                              4 * b * hq * pairs * d)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa) "
              f"{lib_ms:.4f} bound_ms {bound_ms:.4f} ({by})", flush=True)
        if s == 256:
            records["prefill"].update(max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=by,
                                      library_ms=lib_ms)
        else:
            records["prefill"]["max_abs_err"] = max(
                records["prefill"]["max_abs_err"], mx)

    # -- kernel 5: split-KV decode, one launch at any split count (b=16, S=8192)
    from mfa_tpu_torch.kernels import _build

    b, hq, hkv, S = 16, 32, 8, 8192
    q, kc, vc = rn(b, hq, d), rn(b, hkv, S, d), rn(b, hkv, S, d)
    lens = torch.full((b,), S, dtype=torch.int32, device=dev)
    heur = decode.default_splits(b, hkv, S)
    kv_bytes = 2 * b * hkv * S * d * 2
    bound_ms, by = _bound(kv_bytes + 2 * b * hq * d * 2 + b * hq * 4,
                          4 * b * hq * S * d)
    for ns in dict.fromkeys((heur, 2)):
        nsp, tps = decode.split_layout(S, ns)
        partials = (torch.empty((b, hkv, nsp, hq // hkv, d), device=dev),
                    torch.empty((b, hkv, nsp, hq // hkv), device=dev))

        def call():
            return decode._decode_cuda(q, kc, vc, lens, d ** -0.5, nsp, tps, -1, 0.0,
                                       partials=partials)

        def plain():
            po, pl = decode._decode_partials_plain(q, kc, vc, lens, d ** -0.5, nsp,
                                                   tps, -1, 0.0)
            return decode.combine_splits(po, pl, axis=2, return_lse=True)

        _build.reset_launches()
        o, lse = call()
        launched = dict(_build.launches)
        po, pl = decode._decode_partials_plain(q.float(), kc.float(), vc.float(),
                                               lens, d ** -0.5, nsp, tps, -1, 0.0)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        print(f"decode b={b} hq={hq} hkv={hkv} S={S} d={d} num_splits={nsp} bf16: "
              f"launches {launched}", flush=True)
        mx, good = _err(o, ro.reshape(b, hq, d), what="O")
        ok &= good and _lse_err(lse, rl.reshape(b, hq), "") and launched == {"decode": 1}
        if nsp > 1:
            _merge_bits(o, lse, partials, bf)
        records["decode"]["max_abs_err"] = max(
            records["decode"].get("max_abs_err", 0.0), mx)
        ms = _time_ms(call)
        plain_ms = _time_ms(plain, iters=3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True))
        print(f"  ms {ms:.4f} (one launch) plain_ms {plain_ms:.4f} library_ms(sdpa) "
              f"{lib_ms:.4f} bound_ms {bound_ms:.4f} ({by})", flush=True)
        if ns == heur:
            records["decode"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=by, library_ms=lib_ms)
    del q, kc, vc, po, pl, ro, partials

    # -- kernel 6: paged decode (page 64, pos_offset=1, LSE)
    page = 64
    for quant, lengths in ((True, "serve"), (False, "serve"), (True, "long")):
        if lengths == "serve":
            lens_l = [300 - 7 * i for i in range(16)]  # lengths about 300
        else:
            lens_l = [8192] * 16
        b = len(lens_l)
        pps = max(lens_l) // page + 1
        P = b * pps + 1
        q = rn(b, hq, d)
        kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
        if quant:
            kp, ks = quantize_rows(kf, "int8")
            vp, vs = quantize_rows(vf, "int8")
        else:
            kp, vp, ks, vs = kf, vf, None, None
        bt = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
              ).reshape(b, pps).to(torch.int32)  # non-contiguous pages
        L = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        o, lse = paged.paged_attention(q, kp, vp, L, bt, k_scales=ks,
                                       v_scales=vs, pos_offset=1,
                                       return_lse=True)
        ro, rl = paged._paged_plain(q.float(), kp, vp, ks, vs, L, bt,
                                    d ** -0.5, -1, 0.0, 1)
        tag = (f"paged {'int8' if quant else 'bf16'} pages b={b} hq={hq} "
               f"hkv={hkv} page={page} lens={min(lens_l)}..{max(lens_l)} "
               f"pos_offset=1")
        print(tag, flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        ms = _time_ms(lambda: paged.paged_attention(
            q, kp, vp, L, bt, k_scales=ks, v_scales=vs, pos_offset=1,
            return_lse=True))
        plain_ms = _time_ms(lambda: paged._paged_plain(
            q, kp, vp, ks, vs, L, bt, d ** -0.5, -1, 0.0, 1), iters=3)
        rows = sum(lens_l) * hkv
        nbytes = 2 * rows * d * kp.element_size() + (8 * rows if quant else 0) \
            + b * pps * 4 + 2 * b * hq * d * 2 + b * hq * 4
        bound_ms, by = _bound(nbytes, 4 * hq // hkv * rows * d)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a "
              f"bound_ms {bound_ms:.4f} ({by})", flush=True)
        rec = records["paged"]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        if quant and lengths == "serve":
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by, library_ms=None)
    ok &= decode_kernels(records)
    ok &= varlen_kernels(records, rn)
    ok &= paged_prefill_kernels(records, rn, gen)
    ok &= backward_kernels(records, rn)
    ok &= gemma3_kernels(records, rn, gen)
    ok &= zero_shift_kernels(records, rn)
    ok &= wmatmul_kernels(records, gen)
    ok &= moe_kernels(records, gen)
    ok &= kv_format_kernels(records)
    ok &= span_kernels(records)
    ok &= family_kernels(records, rn, gen)
    return ok


KV_FORMATS = ("fp8", "int4")  # the quantized KV formats beside int8


def _kv_pages(kf, vf, quant):
    """Float pages -> (k_pages, v_pages, k_scales, v_scales) in `quant`'s
    format (int4 packed to feature pairs)."""
    from mfa_tpu_torch.kernels.quant import pack_int4, quantize_rows

    (kp, ks), (vp, vs) = quantize_rows(kf, quant), quantize_rows(vf, quant)
    if quant == "int4":
        kp, vp = pack_int4(kp), pack_int4(vp)
    return kp, vp, ks, vs


def _poison_stale(pages, scales, quant, stale):
    """Rows `stale` ([hkv, P, page] bool) get NaN scales, and fp8 payloads
    the e4m3 NaN code 0x7F: what a row past a length may hold."""
    import torch

    scales[stale] = float("nan")
    if quant == "fp8":
        pages.view(torch.uint8)[stale] = 0x7F


def _row_bytes(quant, d: int) -> int:
    """Bytes one K or V row of a page moves, its fp32 scale included."""
    return {None: 2 * d, "int8": d + 4, "fp8": d + 4, "int4": d // 2 + 4}[quant]


def kv_format_kernels(records):
    """Kernel 6 (paged decode) and kernel 8 (paged prefill) on fp8 (e4m3)
    and int4 pages, each against its plain version (max 2e-2, mean 2e-3;
    LSE within 1e-3 with the same -inf rows). Kernel 6 at the 8B serve
    step, lengths 8192, Gemma3-4B's decode step at d 256 (3 splits, one
    launch), a window with a softcap, and d 64; kernel 8 at the engine's
    chunk batch. Rows past each length in a sequence's last page hold NaN
    scales, and fp8 rows there the NaN code 0x7F: neither may reach O (the
    plain version runs on the rows before the poisoning). Times the serve
    step, lengths 8192, Gemma3's step and the chunk batch, beside the
    bound by bytes (int4 rows d / 2 + 4 bytes, fp8 d + 4). Its inputs come
    from a generator of its own."""
    import torch

    from mfa_tpu_torch.kernels import paged, paged_prefill

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    ok, page = True, 64
    cases = (  # tag, b, hq, hkv, d, lens, window, softcap, timed
        ("8B serve step", 16, 32, 8, 128, [300 - 7 * i for i in range(16)], -1, 0.0,
         True),
        ("lens 8192", 16, 32, 8, 128, [8192] * 16, -1, 0.0, True),
        ("Gemma3-4B decode d256, window 1023", 10, 8, 4, 256,
         [300 + (1700 * i) // 9 for i in range(10)], 1023, 0.0, True),
        ("window 100, softcap 30", 4, 32, 8, 128, [1000, 77, 400, 513], 100, 30.0,
         False),
        ("d 64", 8, 16, 2, 64, [700, 1, 64, 333, 0, 129, 1000, 5], -1, 0.0, False))
    for tag, b, hq, hkv, d, lens_l, wl, cap, timed in cases:
        pps = max(lens_l) // page + 1
        P = b * pps + 1
        q = rn(b, hq, d)
        kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
        bt = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
              ).reshape(b, pps).to(torch.int32)
        L = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        stale = torch.zeros(hkv, P, page, dtype=torch.bool, device="cuda")
        for i, n in enumerate(lens_l):
            if n % page:
                stale[:, int(bt[i, n // page]), n % page:] = True
        splits = paged.split_plan(b, hkv, pps, page)[0]
        for quant in KV_FORMATS:
            kp, vp, ks, vs = _kv_pages(kf, vf, quant)
            clean = tuple(t.clone() for t in (kp, vp, ks, vs))
            _poison_stale(kp, ks, quant, stale)
            _poison_stale(vp, vs, quant, stale)

            def run(kp=kp, vp=vp, ks=ks, vs=vs, quant=quant):
                return paged.paged_attention(
                    q, kp, vp, L, bt, k_scales=ks, v_scales=vs, window_left=wl,
                    logit_softcap=cap, pos_offset=1, quant_dtype=quant, return_lse=True)

            o, lse = run()
            ro, rl = paged._paged_plain(q.float(), *clean, L, bt, d ** -0.5, wl, cap,
                                        1, quant_dtype=quant)
            print(f"paged {quant} pages, {tag}: b={b} hq={hq} hkv={hkv} d={d} "
                  f"page={page} lens={min(lens_l)}..{max(lens_l)} window={wl} "
                  f"softcap={cap} splits={splits}; rows past lens: NaN scales"
                  f"{', 0x7F payload' if quant == 'fp8' else ''}", flush=True)
            mx, good = _err(o, ro, what="O")
            ok &= good and _lse_err(lse, rl, "")
            rec = records[paged.launch_name("paged", quant)]
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
            if not timed:
                continue
            ms = _time_ms(run)
            plain_ms = _time_ms(lambda: paged._paged_plain(
                q, *clean, L, bt, d ** -0.5, wl, cap, 1, quant_dtype=quant), iters=3)
            rows = sum(min(n, wl) if wl >= 0 else n for n in lens_l) * hkv
            nbytes = 2 * rows * _row_bytes(quant, d) + b * pps * 4 \
                + 2 * b * hq * d * 2 + b * hq * 4
            bound_ms, by = _bound(nbytes, 4 * hq // hkv * rows * d)
            print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a bound_ms "
                  f"{bound_ms:.4f} ({by}) bound share {bound_ms / ms:.3f}", flush=True)
            if tag == "8B serve step":
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           library_ms=None)
        del q, kf, vf, kp, vp, o, ro
    # -- kernel 8 at the engine's chunk batch: 4 x 512 at q_start 0, 1024,
    # 2048, 3072, the last chunk 500 rows (its last page part stale)
    hq, hkv, d, sq = 32, 8, 128, 512
    q_start, q_lens = [0, 1024, 2048, 3072], [512, 512, 512, 500]
    lens = [s_ + n for s_, n in zip(q_start, q_lens)]
    b = len(lens)
    pps = max(lens) // page + 1
    P = b * pps + 1
    q = rn(b, sq, hq, d)
    kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
    table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
             ).reshape(b, pps).to(torch.int32)
    L, QS, QL = (torch.tensor(x, dtype=torch.int32, device="cuda")
                 for x in (lens, q_start, q_lens))
    stale = torch.zeros(hkv, P, page, dtype=torch.bool, device="cuda")
    for i, n in enumerate(lens):
        if n % page:
            stale[:, int(table[i, n // page]), n % page:] = True
    for quant in KV_FORMATS:
        kp, vp, ks, vs = _kv_pages(kf, vf, quant)
        clean = tuple(t.clone() for t in (kp, vp, ks, vs))
        _poison_stale(kp, ks, quant, stale)
        _poison_stale(vp, vs, quant, stale)

        def run(lse=False, kp=kp, vp=vp, ks=ks, vs=vs, quant=quant):
            return paged_prefill.paged_prefill_attention(
                q, kp, vp, L, QS, table, q_lens=QL, k_scales=ks, v_scales=vs,
                causal=True, quant_dtype=quant, return_lse=lse)

        o, lse = run(True)
        ro, rl = paged_prefill._paged_prefill_plain(
            q.float(), *clean, L, QS, QL, table, d ** -0.5, -1, 0, 0.0, quant_dtype=quant)
        print(f"paged_prefill {quant} pages, engine chunk batch: 4 x 512 rows at "
              f"q_start {q_start}, q_lens {q_lens}, hq={hq} hkv={hkv} d={d} "
              f"page={page}; rows past lens: NaN scales"
              f"{', 0x7F payload' if quant == 'fp8' else ''}", flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        ms = _time_ms(run)
        plain_ms = _time_ms(lambda: paged_prefill._paged_prefill_plain(
            q, *clean, L, QS, QL, table, d ** -0.5, -1, 0, 0.0, quant_dtype=quant),
            iters=3)
        kv_rows = sum(lens) * hkv
        nbytes = 2 * kv_rows * _row_bytes(quant, d) + b * pps * 4 + 2 * b * sq * hq * d * 2
        pairs = sum(_visible_pairs(n, n_k, s_, -1, 0)
                    for s_, n, n_k in zip(q_start, q_lens, lens))
        bound_ms, by = _bound(nbytes, 4 * hq * pairs * d)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a bound_ms "
              f"{bound_ms:.4f} ({by}) bound share {bound_ms / ms:.3f}", flush=True)
        records[paged.launch_name("paged_prefill", quant)].update(
            max_abs_err=mx, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=None)
    del q, kf, vf, kp, vp, o, ro
    torch.cuda.empty_cache()
    return ok


SPAN_CASES = (  # q_span, group, d, pages, pos_offset, window, softcap
    (2, 4, 128, "int8", 2, -1, 0.0),
    (4, 4, 128, None, 0, -1, 0.0),
    (3, 4, 64, "fp8", 3, 50, 0.0),
    (8, 2, 256, "int4", 0, -1, 30.0),
    (4, 8, 128, "fp8", 4, -1, 0.0),     # 32 rows: two row blocks
    (8, 4, 256, "int8", 8, 100, 0.0),   # 32 rows at d 256
    (8, 2, 64, "int4", 8, -1, 0.0),
    (4, 8, 256, None, 0, 300, 20.0))


def span_kernels(records):
    """Kernel 6 on multi-query spans (q [b, q_span, hq, d], launch name
    "paged_span"; speculative verification) against its plain version (max
    2e-2, mean 2e-3; LSE within 1e-3 with the same -inf rows): SPAN_CASES
    over bf16, int8, fp8 and int4 pages at d 64, 128 and 256, pos_offset 0
    and q_span, windows and softcaps, rows past each length holding NaN
    (bf16) or NaN scales and, for fp8, the 0x7F code. With pos_offset 0,
    each span row si also against a q_span = 1 call at lens - (q_span - 1 -
    si) (same limits). Times the 8B verify shape (b16, span 4, hq32 hkv8
    d128, int8 pages of 64, lens 195-300, pos_offset 4) beside q_span = 1
    at the same lens, and groups of 16 (hq32 hkv2) at q_span = 1. Its
    inputs come from a generator of its own."""
    import torch

    from mfa_tpu_torch.kernels import paged

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def setup(b_lens, hkv, d, quant, page=64):
        pps = max(b_lens) // page + 1
        P = len(b_lens) * pps + 1
        kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
        if quant is None:
            kp, vp, ks, vs = kf, vf, None, None
        else:
            kp, vp, ks, vs = _kv_pages(kf, vf, quant)
        bt = (torch.randperm(P - 1, generator=gen, device="cuda")[: len(b_lens) * pps]
              + 1).reshape(len(b_lens), pps).to(torch.int32)
        L = torch.tensor(b_lens, dtype=torch.int32, device="cuda")
        return [kp, vp, ks, vs], bt, L, pps

    ok, rec, page, hkv = True, records["paged_span"], 64, 2
    lens_l = [300, 8, page, 383 // page * page - 1, 195]
    for span, group, d, quant, pos_offset, wl, cap in SPAN_CASES:
        hq = hkv * group
        pages, bt, L, _ = setup(lens_l, hkv, d, quant)
        clean = [None if t is None else t.clone() for t in pages]
        stale = torch.zeros(pages[0].shape[:3], dtype=torch.bool, device="cuda")
        for i, n in enumerate(lens_l):
            if n % page:
                stale[:, int(bt[i, n // page]), n % page:] = True
        if quant is None:
            pages[0][stale] = float("nan")
            pages[1][stale] = float("nan")
        else:
            _poison_stale(pages[0], pages[2], quant, stale)
            _poison_stale(pages[1], pages[3], quant, stale)
        q = rn(len(lens_l), span, hq, d)
        kw = dict(window_left=wl, pos_offset=pos_offset, logit_softcap=cap,
                  quant_dtype=quant)
        o, lse = paged.paged_attention(q, pages[0], pages[1], L, bt, k_scales=pages[2],
                                       v_scales=pages[3], return_lse=True, **kw)
        ro, rl = paged._paged_plain(q.float(), *clean, L, bt, d ** -0.5, wl, cap,
                                    pos_offset, quant_dtype=quant)
        print(f"paged_span q_span={span} group={group} ({span * group} rows) d={d} "
              f"{quant or 'bf16'} pages hkv={hkv} lens={lens_l} pos_offset={pos_offset} "
              f"window={wl} softcap={cap}; rows past lens poisoned", flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        if pos_offset == 0:
            worst, same = 0.0, True
            for si in range(span):
                eff = (L - (span - 1 - si)).clamp(min=0)
                o1, l1 = paged.paged_attention(q[:, si], pages[0], pages[1], eff, bt,
                                               k_scales=pages[2], v_scales=pages[3],
                                               return_lse=True, **kw)
                dd = (o[:, si].float() - o1.float()).abs()
                worst = max(worst, float(dd.max()))
                same &= float(dd.mean()) < 2e-3 and float(dd.max()) < 2e-2
                fin = torch.isfinite(l1)
                same &= torch.equal(torch.isneginf(lse[:, si]), torch.isneginf(l1))
                same &= float((lse[:, si][fin] - l1[fin]).abs().max()) < 1e-3
            print(f"  rows against q_span 1 calls at lens - (q_span - 1 - si): "
                  f"max_abs {worst:.3e} {'ok' if same else 'FAIL'}", flush=True)
            ok &= same
        del pages, clean, q, o, ro
    # -- the 8B verify shape, and q_span 1 at its lens
    lens_v = [300 - 7 * i for i in range(16)]
    b, hq, hkv, d = 16, 32, 8, 128
    pages, bt, L, pps = setup(lens_v, hkv, d, "int8")
    rows = sum(lens_v) * hkv
    for span, tag in ((4, "8B verify shape, span 4, pos_offset 4"),
                      (1, "q_span 1 at the same lens, pos_offset 1")):
        q = rn(b, span, hq, d) if span > 1 else rn(b, hq, d)
        po = span if span > 1 else 1

        def run(q=q, po=po):
            return paged.paged_attention(q, pages[0], pages[1], L, bt, k_scales=pages[2],
                                         v_scales=pages[3], pos_offset=po,
                                         return_lse=True)

        o, lse = run()
        ro, rl = paged._paged_plain(q.float(), *pages, L, bt, d ** -0.5, -1, 0.0, po)
        print(f"paged int8 pages, {tag}: b={b} hq={hq} hkv={hkv} d={d} page={page} "
              f"lens={min(lens_v)}..{max(lens_v)}", flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        ms = _time_ms(run)
        plain_ms = _time_ms(lambda: paged._paged_plain(
            q, *pages, L, bt, d ** -0.5, -1, 0.0, po), iters=3)
        nbytes = 2 * rows * _row_bytes("int8", d) + b * pps * 4 \
            + 2 * b * span * hq * d * 2 + b * span * hq * 4
        bound_ms, by = _bound(nbytes, 4 * span * hq // hkv * rows * d)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a bound_ms "
              f"{bound_ms:.6f} ({by}) bound share {bound_ms / ms:.3f}", flush=True)
        if span > 1:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                       library_ms=None)
    # -- groups of 16 at q_span 1 (hq32 hkv2): the 16-row blocks
    hkv = 2
    pages, bt, L, pps = setup(lens_v, hkv, d, "int8")
    q = rn(b, hq, d)
    o, lse = paged.paged_attention(q, pages[0], pages[1], L, bt, k_scales=pages[2],
                                   v_scales=pages[3], pos_offset=1, return_lse=True)
    ro, rl = paged._paged_plain(q.float(), *pages, L, bt, d ** -0.5, -1, 0.0, 1)
    print(f"paged int8 pages, group 16 at q_span 1: b={b} hq={hq} hkv={hkv} d={d} "
          f"lens={min(lens_v)}..{max(lens_v)}", flush=True)
    mx, good = _err(o, ro, what="O")
    ok &= good and _lse_err(lse, rl, "")
    records["paged"]["max_abs_err"] = max(records["paged"].get("max_abs_err", 0.0), mx)
    ms = _time_ms(lambda: paged.paged_attention(
        q, pages[0], pages[1], L, bt, k_scales=pages[2], v_scales=pages[3],
        pos_offset=1, return_lse=True))
    rows = sum(lens_v) * hkv
    bound_ms, by = _bound(2 * rows * _row_bytes("int8", d) + b * pps * 4
                          + 2 * b * hq * d * 2 + b * hq * 4, 4 * hq // hkv * rows * d)
    print(f"  ms {ms:.4f} library_ms n/a bound_ms {bound_ms:.6f} ({by}) bound share "
          f"{bound_ms / ms:.3f}", flush=True)
    del pages, q, o, ro
    torch.cuda.empty_cache()
    return ok


def decode_kernels(records):
    """Kernel 5's launch 1 (csrc/decode_sm90.cuh) beyond the main shape: a
    long cache (b1 S32768) at d 64, 128 and 256, groups 1, 2, 4 and 8, a
    window and a softcap, lengths of 0, 1 and not a multiple of the 64-token
    tile, at the default split count and at 3, each against the plain
    version (max 2e-2, mean 2e-3; LSE within 1e-3 with the same -inf rows).
    Rows past a length hold NaN: the kernel masks them. Times the long
    cache at d 128 against SDPA on the same cache. Its inputs come from a
    generator of its own, so the checks after it see the inputs they had
    before it existed."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import decode

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    ok = True
    for b, hq, hkv, S, d, lens, wl, cap in (
            (1, 32, 8, 32768, 128, [32768], -1, 0.0),
            (1, 32, 8, 32768, 64, [32701], -1, 0.0),
            (1, 16, 2, 32768, 256, [32700], 4000, 0.0),
            (4, 8, 8, 2000, 64, [2000, 0, 1, 1000], -1, 0.0),
            (3, 16, 8, 3000, 256, [2999, 130, 0], 500, 30.0),
            (2, 16, 4, 4100, 128, [4100, 4033], 1000, 0.0),
            (2, 64, 8, 5000, 64, [4999, 77], -1, 25.0)):
        q, kc, vc = rn(b, hq, d), rn(b, hkv, S, d), rn(b, hkv, S, d)
        for i, n in enumerate(lens):
            kc[i, :, n:] = float("nan")
            vc[i, :, n:] = float("nan")
        L = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for ns in dict.fromkeys((decode.default_splits(b, hkv, S), 3)):
            nsp, tps = decode.split_layout(S, ns)
            o, lse = decode.decode_attention(q, kc, vc, L, num_splits=ns, window_left=wl,
                                             logit_softcap=cap, return_lse=True)
            po, pl = decode._decode_partials_plain(
                q.float(), kc.float().nan_to_num(), vc.float().nan_to_num(), L, d ** -0.5,
                nsp, tps, wl, cap)
            ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
            print(f"decode b={b} hq={hq} hkv={hkv} S={S} d={d} lens={lens[:4]} window={wl} "
                  f"softcap={cap} num_splits={nsp} bf16", flush=True)
            mx, good = _err(o, ro.reshape(b, hq, d), what="O")
            ok &= good and _lse_err(lse, rl.reshape(b, hq), "")
            records["decode"]["max_abs_err"] = max(records["decode"]["max_abs_err"], mx)
            del po, pl, ro, rl
        if S == 32768 and d == 128:
            kc.nan_to_num_()
            vc.nan_to_num_()
            ms = _time_ms(lambda: decode.decode_attention(q, kc, vc, L))
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, enable_gqa=True))
            nsp, tps = decode.split_layout(S, decode.default_splits(b, hkv, S))
            plain_ms = _time_ms(lambda: decode._decode_partials_plain(
                q, kc, vc, L, d ** -0.5, nsp, tps, -1, 0.0), iters=3)
            bms, bby = _bound(2 * b * hkv * S * d * 2 + 2 * b * hq * d * 2 + b * hq * 4,
                              4 * b * hq * S * d)
            print(f"  whole call ({nsp} splits) ms {ms:.4f} plain_ms(launch 1) "
                  f"{plain_ms:.4f} library_ms(sdpa) {lib_ms:.4f} bound_ms {bms:.4f} "
                  f"({bby})", flush=True)
        del q, kc, vc
    torch.cuda.empty_cache()
    return ok


def gemma3_kernels(records, rn, gen):
    """Gemma3-4B's attention shapes (8 q / 4 kv heads of head_dim 256):
    kernel 1 at d 256 (the text wave), the paged kernel at d 256 (every
    decode step), and kernel 9 (the image wave) in four cases."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import blockmask, paged, prefill
    from mfa_tpu_torch.kernels.quant import quantize_rows

    dev, b, hq, hkv, s, d = "cuda", 4, 8, 4, 2048, 256
    scale = d ** -0.5
    ok = True
    q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
    io_bytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    for wl in (1023, -1):
        o, lse = prefill.prefill_attention(q, k, v, causal=True, window_size=(wl, -1),
                                           return_lse=True, bound_softmax=False)
        ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), scale,
                                        wl, 0, 0.0, True)
        print(f"prefill (kernel 1) d256 causal window {wl}: b={b} hq={hq} hkv={hkv} "
              f"s={s} bf16", flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        records["prefill"]["max_abs_err"] = max(records["prefill"]["max_abs_err"], mx)
        ms = _time_ms(lambda: prefill.prefill_attention(q, k, v, causal=True,
                                                        window_size=(wl, -1),
                                                        bound_softmax=False))
        plain_ms = _time_ms(lambda: prefill._prefill_plain(q, k, v, scale, wl, 0, 0.0,
                                                           False), iters=3)
        if wl < 0:
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        else:
            band = blockmask.block_mask(torch.full((1, s), -1, device=dev), wl)[0]
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True))
        bound_ms, by = _bound(io_bytes, 4 * b * hq * _visible_pairs(s, s, 0, wl, 0) * d)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa"
              f"{' is_causal' if wl < 0 else ' + band mask'}) {lib_ms:.4f} bound_ms "
              f"{bound_ms:.4f} ({by})", flush=True)
    del o, lse, ro, rl

    # -- paged decode at d 256: group 2, lengths 300-2000, window 1023
    page, nb = 64, 10
    lens_l = [300 + (1700 * i) // (nb - 1) for i in range(nb)]
    pps = max(lens_l) // page + 1
    P = nb * pps + 1
    qd = rn(nb, hq, d)
    kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
    bt = (torch.randperm(P - 1, generator=gen, device=dev)[: nb * pps] + 1
          ).reshape(nb, pps).to(torch.int32)
    L = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    for quant in (True, False):
        if quant:
            (kp, ks), (vp, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
        else:
            kp, vp, ks, vs = kf, vf, None, None

        def run(kp=kp, vp=vp, ks=ks, vs=vs):
            return paged.paged_attention(qd, kp, vp, L, bt, k_scales=ks, v_scales=vs,
                                         window_left=1023, pos_offset=1,
                                         return_lse=True)

        o, lse = run()
        ro, rl = paged._paged_plain(qd.float(), kp, vp, ks, vs, L, bt, scale, 1023,
                                    0.0, 1)
        print(f"paged d256 {'int8' if quant else 'bf16'} pages b={nb} hq={hq} "
              f"hkv={hkv} page={page} lens={min(lens_l)}..{max(lens_l)} window 1023 "
              f"pos_offset=1", flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        nsp = paged.split_plan(nb, hkv, pps, page)[0]
        if nsp > 1:  # the split route: its partials, for the merge's bits
            partials = (torch.empty((nb, hkv, nsp, hq // hkv, d), device=dev),
                        torch.empty((nb, hkv, nsp, hq // hkv), device=dev))
            o2, lse2 = paged._paged_cuda(qd, kp, vp, ks, vs, L, bt, scale, 1023, 0.0, 1,
                                         "int8" if quant else None, partials=partials)
            ok &= torch.equal(o2, o) and torch.equal(lse2, lse)
            _merge_bits(o2, lse2, partials, torch.bfloat16)
        records["paged"]["max_abs_err"] = max(records["paged"].get("max_abs_err", 0.0), mx)
        ms = _time_ms(run)
        plain_ms = _time_ms(lambda: paged._paged_plain(
            qd, kp, vp, ks, vs, L, bt, scale, 1023, 0.0, 1), iters=3)
        rows = sum(min(n, 1023) for n in lens_l) * hkv  # the window's rows
        nbytes = 2 * rows * d * kp.element_size() + (8 * rows if quant else 0) \
            + nb * pps * 4 + 2 * nb * hq * d * 2 + nb * hq * 4
        bound_ms, by = _bound(nbytes, 4 * hq // hkv * rows * d)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a "
              f"bound_ms {bound_ms:.4f} ({by})", flush=True)

    # -- kernel 9: image-block prefill
    def ids_of(bb, ss, runs):
        ids = torch.full((bb, ss), -1, dtype=torch.int32, device=dev)
        for i in range(bb):
            for gi, (a, z) in enumerate(runs):
                ids[i, a:z + 1] = gi
        return ids

    rec = records["blockmask"]
    cases = (("Gemma3-4B image wave: one 256-token run at 700, window 1023",
              (q, k, v), ids_of(b, s, [(700, 955)]), 1023, True),
             ("same, global layer (no window)", (q, k, v), ids_of(b, s, [(700, 955)]),
              -1, False),
             ("two runs across tile edges, s 1000, window 255",
              (rn(2, hq, 1000, d), rn(2, hkv, 1000, d), rn(2, hkv, 1000, d)),
              ids_of(2, 1000, [(100, 200), (383, 700)]), 255, False),
             ("d 128, s 777, one run 250-520, window 127",
              (rn(2, 16, 777, 128), rn(2, 8, 777, 128), rn(2, 8, 777, 128)),
              ids_of(2, 777, [(250, 520)]), 127, False),
             ("no image (all ids -1), window 1023: kernel 1's causal output",
              (q, k, v), ids_of(b, s, []), 1023, False))
    for tag, (qq, kk, vv), ids, wl, record in cases:
        bb, hh, ss, dd = qq.shape
        o = blockmask.image_block_prefill(qq, kk, vv, ids, window_left=wl)
        ro = blockmask._image_block_plain(qq.float(), kk.float(), vv.float(), ids,
                                          dd ** -0.5, wl)
        print(f"blockmask {tag}: b={bb} hq={hh} hkv={kk.shape[1]} s={ss} d={dd} bf16",
              flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        if not (ids >= 0).any():
            # with no image kernel 9 runs kernel 1's code over the same
            # tiles in the same order: the same bits
            k1 = prefill.prefill_attention(qq, kk, vv, causal=True, window_size=(wl, -1),
                                           bound_softmax=False)
            same = torch.equal(o, k1)
            print(f"  equal to kernel 1's causal output bit for bit: {same} "
                  f"{'ok' if same else 'FAIL'}", flush=True)
            ok &= same
            continue
        ms = _time_ms(lambda: blockmask.image_block_prefill(qq, kk, vv, ids,
                                                            window_left=wl))
        plain_ms = _time_ms(lambda: blockmask._image_block_plain(
            qq, kk, vv, ids, dd ** -0.5, wl), iters=3)
        mask = blockmask.block_mask(ids, wl)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask[:, None], enable_gqa=True))
        pairs = int(mask.sum())
        nbytes = 2 * (2 * qq.numel() + 2 * kk.numel()) + ids.numel() * 4
        bound_ms, by = _bound(nbytes, 4 * hh * pairs * dd)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms(sdpa + bool mask) "
              f"{lib_ms:.4f} bound_ms {bound_ms:.4f} ({by}); visible pairs {pairs} of "
              f"{bb * ss * ss} per head", flush=True)
        if record:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                       library_ms=lib_ms)
        del mask
    torch.cuda.empty_cache()
    return ok


def _causal_reference64(q, k, v, scale):
    """Causal GQA attention and its natural-log LSE in float64
    (scripts/probe_adversarial_prefill.py's reference)."""
    import torch

    group = q.shape[1] // k.shape[1]
    kf = k.double().repeat_interleave(group, dim=1)
    vf = v.double().repeat_interleave(group, dim=1)
    sc = (q.double() @ kf.transpose(-1, -2)) * scale
    n = q.shape[2]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    sc = sc.masked_fill(~mask, float("-inf"))
    return torch.softmax(sc, dim=-1) @ vf, torch.logsumexp(sc, dim=-1).float()


def zero_shift_kernels(records, rn):
    """Kernels 2, 3 and 4 (the zero-shift engines, csrc/bound.cu) against
    the plain classic version (fp32 on the same bf16 inputs): the flagged +
    repair pair at the 8B wave (b16 hq32 hkv8 s256 d128), at b1 s4096, and
    at Gemma3-4B's text wave (b4 hq8 hkv4 s2048 d256, window 1023 and none):
    0 flags on benign inputs, flags and a repaired output on std-1e3 inputs
    and under the +-40 near-flush bias, where "unchecked" is off. The
    repair launch is timed alone with no flag and with every tile flagged.
    The bound kernel: "prepass" at d 128 on adversarial inputs, the d 64
    default and "unchecked" on benign ones. fp16 with a strong key takes
    kernel 1 and stays finite."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import prefill

    ok = True
    bf = torch.bfloat16
    for tag, b, hq, hkv, s, d, wl, record in (
            ("8B wave", 16, 32, 8, 256, 128, -1, True),
            ("long prompt", 1, 32, 8, 4096, 128, -1, False),
            ("Gemma3-4B text wave, window 1023", 4, 8, 4, 2048, 256, 1023, False),
            ("Gemma3-4B text wave, global layer", 4, 8, 4, 2048, 256, -1, False)):
        scale, nt = d ** -0.5, -(-s // 64)
        q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
        kw = dict(causal=True, window_size=(wl, -1))
        o, lse, flags = prefill.prefill_attention(q, k, v, return_lse=True,
                                                  bound_softmax="flag_debug", **kw)
        ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), scale, wl, 0,
                                        0.0, True)
        n_flags = int(flags.sum())  # read back here only, never on the main path
        print(f"flagged + repair, {tag}: b={b} hq={hq} hkv={hkv} s={s} d={d} bf16, "
              f"benign: {n_flags} of {flags.numel()} tiles flagged", flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "") and n_flags == 0
        for n in ("flagged", "repair"):
            records[n]["max_abs_err"] = max(records[n].get("max_abs_err", 0.0), mx)
        out = torch.empty_like(q)
        lse_o = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
        none = torch.zeros((b, hq, nt), dtype=torch.int32, device="cuda")
        every = torch.ones_like(none)
        ms = _time_ms(lambda: prefill._zs_launch("flagged", q, k, v, out, None, flags,
                                                 scale, wl, 0))
        rep0 = _time_ms(lambda: prefill._zs_launch("repair", q, k, v, out, None, none,
                                                    scale, wl, 0))
        rep1 = _time_ms(lambda: prefill._zs_launch("repair", q, k, v, out, None, every,
                                                   scale, wl, 0))
        k1 = _time_ms(lambda: prefill.prefill_attention(q, k, v, bound_softmax=False,
                                                        **kw))
        plain_ms = _time_ms(lambda: prefill._zero_shift_plain(q, k, v, scale, wl, 0),
                            iters=3)
        rplain = _time_ms(lambda: prefill._prefill_plain(q, k, v, scale, wl, 0, 0.0,
                                                         False), iters=3)
        if wl < 0:
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        else:
            band = prefill._band(s, s, wl, 0, "cuda")[0]
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True))
        io = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        bound_ms, by = _bound(io + b * hq * nt * 4,
                              4 * b * hq * _visible_pairs(s, s, 0, wl, 0) * d)
        rb0, rby0 = _bound(b * hq * nt * 4, 0)
        print(f"  flagged ms {ms:.4f} (kernel 1 {k1:.4f}), repair ms {rep0:.4f} with no "
              f"flag (bound {rb0:.6f}, {rby0}) and {rep1:.4f} with every tile flagged; "
              f"plain_ms {plain_ms:.4f} (repair's: classic {rplain:.4f}) library_ms(sdpa) "
              f"{lib_ms:.4f} bound_ms {bound_ms:.4f} ({by})", flush=True)
        if record:
            records["flagged"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=by, library_ms=lib_ms)
            records["repair"].update(ms=rep0, plain_ms=rplain, bound_ms=rb0,
                                     bound_by=rby0, library_ms=None)
        del q, k, v, o, lse, ro, rl, out, lse_o
        torch.cuda.empty_cache()

    # adversarial inputs at the 8B wave shape
    b, hq, hkv, s, d = 16, 32, 8, 256, 128
    scale = d ** -0.5
    for tag in ("std 1e3", "near-flush bias +-40"):
        q, k, v = rn(b, hq, s, d).float(), rn(b, hkv, s, d).float(), rn(b, hkv, s, d)
        q, k = (q * 1e3, k * 1e3) if tag == "std 1e3" else (q + 40.0, k - 40.0)
        q, k = q.to(bf), k.to(bf)
        ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), scale, -1, 0,
                                        0.0, True)
        o, lse, flags = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                                  bound_softmax="flag_debug")
        o1, lse1 = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                             bound_softmax=False)
        raw = prefill.prefill_attention(q, k, v, causal=True, bound_softmax="unchecked")
        n_flags = int(flags.sum())
        print(f"flagged + repair, adversarial ({tag}): {n_flags} of {flags.numel()} "
              f"tiles flagged", flush=True)
        # Scores reach 1e6 here, where fp32 rounds them by ~0.1: rows whose
        # two best keys are that close move with the summation order, so
        # the limit is the repair's own function, kernel 1 bit for bit on
        # every flagged tile, with the mean error against the plain version
        same = n_flags == flags.numel() and torch.equal(o, o1) and torch.equal(lse, lse1)
        err = (o.float() - ro).abs()
        mx, mean = float(err.max()), float(err.mean())
        good = bool(torch.isfinite(o.float()).all()) and mean < 2e-3 and same
        fin = torch.isfinite(rl)
        lse_rel = float(((lse - rl).abs() / rl.abs().clamp(min=1.0))[fin].max())
        good &= lse_rel < 1e-3 and torch.equal(torch.isneginf(lse), torch.isneginf(rl))
        print(f"  repaired O equal to kernel 1's O and LSE: {same}; against the plain "
              f"version: max_abs_err {mx:.3e}, mean {mean:.3e} (< 2e-3), lse relative "
              f"err {lse_rel:.3e} (< 1e-3) {'ok' if good else 'FAIL'}", flush=True)
        d_raw = (raw.float() - ro).abs()
        off = not bool(torch.isfinite(raw.float()).all()) or float(
            d_raw.nan_to_num(1e9).max()) >= 2e-2
        print(f"  unchecked: max_abs_err {float(d_raw.nan_to_num(1e9).max()):.3e}, "
              f"outside the limits: {off}", flush=True)
        ok &= good and off
        del q, k, v, o, lse, o1, lse1, ro, rl, raw

    # kernel 4, the bound engine. On the std-1e3 inputs the logits reach ~1e5
    # and fp32 dot products round by more than some rows' top-two gap, so an
    # fp32 reference is less exact than the kernel: that case is held to an
    # fp64 reference (scripts/probe_adversarial_prefill.py), within max 1e-1
    # (over 8 draws there the kernels were 4.9e-3 to 6.9e-2 from it, the
    # fp32 plain version up to 2.96e-1) and mean 2e-3.
    rec = records["bound"]
    for tag, d, mode, adversarial in (("prepass, std 1e3", 128, "prepass", True),
                                      ("prepass, benign", 128, "prepass", False),
                                      ("default at d 64, benign", 64, None, False),
                                      ("unchecked, benign", 128, "unchecked", False)):
        scale = d ** -0.5
        q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
        if adversarial:
            q, k = (q.float() * 1e3).to(bf), (k.float() * 1e3).to(bf)
        o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                           bound_softmax=mode)
        if adversarial:
            ro, rl = _causal_reference64(q, k, v, scale)
        else:
            ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), scale, -1, 0,
                                            0.0, True)
        bits = prefill._risky_bits(q, k, scale * prefill._LOG2E)
        n_bits = int(bits.sum())
        print(f"bound {tag}: b={b} hq={hq} hkv={hkv} s={s} d={d} bf16, {n_bits} of "
              f"{bits.numel()} tiles risky{', against fp64' if adversarial else ''}",
              flush=True)
        mx, good = _err(o, ro, tol_max=1e-1 if adversarial else 2e-2, what="O")
        fin = torch.isfinite(rl)
        lse_rel = float(((lse - rl).abs() / rl.abs().clamp(min=1.0))[fin].max())
        good &= lse_rel < 1e-3 and (n_bits == bits.numel() if adversarial else n_bits == 0)
        ok &= good
        if not adversarial:  # the record holds the kernel against its plain version
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        table = None if mode == "unchecked" else bits
        out = torch.empty_like(q)
        ms = _time_ms(lambda: prefill._zs_launch("bound", q, k, v, out, None, table,
                                                 scale, -1, 0))
        bits_ms = _time_ms(lambda: prefill._risky_bits(q, k, scale * prefill._LOG2E))
        plain_ms = _time_ms(lambda: prefill._zero_shift_plain(q, k, v, scale, -1, 0),
                            iters=3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        bound_ms, by = _bound(2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
                              + (0 if table is None else bits.numel() * 4),
                              4 * b * hq * s * (s + 1) // 2 * d)
        print(f"  ms {ms:.4f} (+ risky bits by torch ops {bits_ms:.4f}) lse relative err "
              f"{lse_rel:.3e} plain_ms {plain_ms:.4f} library_ms(sdpa) {lib_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({by})", flush=True)
        if tag == "prepass, benign":
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                       library_ms=lib_ms)

    # fp16 with a strong key: the default takes kernel 1 and stays exact
    q = (rn(1, 32, 256, 128).float() * 0.1 + 1.0).half()
    k, v = rn(1, 8, 256, 128).half(), rn(1, 8, 256, 128).half()
    k[:, :, 0] = 2.0  # every row's natural logit against key 0 is about 22
    o = prefill.prefill_attention(q, k, v, causal=True)
    ro = prefill._prefill_plain(q.float(), k.float(), v.float(), 128 ** -0.5, -1, 0,
                                0.0, False)
    print("fp16 with a strong key (natural logit ~22), default engine:", flush=True)
    ok &= _err(o, ro, what="O")[1]
    return ok


def wmatmul_kernels(records, gen):
    """Kernel 10 (csrc/wmatmul.cu) against its plain version in fp32 on the
    same inputs: at w_gate for m = 1, 17, 64, 255, 256 and 3601 (every row
    count of a block) with fp16 x and with fp32 out; then, timed, m = 16 (a
    decode step) at the 8B projections wq, wk, w_gate, w_down and the
    lm_head (wq, wk and w_down split K over a cluster), and m = 3601 (a
    prefill wave) at w_gate. Limit: max |a - r| <= 2^-8 max |r| (the kernel rounds its fp32
    accumulator once). The library call is torch.matmul against the
    dequantized bf16 weight (cuBLAS), a yardstick only."""
    import torch

    from mfa_tpu_torch.kernels import wmatmul
    from mfa_tpu_torch.models.wquant import dequantize_weight, quantize_weight

    ok = True
    rec = records["wmatmul"]

    def check(name, x, w, out_dtype):
        m, K = x.shape
        N = w.qw.shape[1]
        out = wmatmul.int8_matmul(x, w.qw, w.scale, out_dtype=out_dtype)
        ref = wmatmul._int8_matmul_plain(x.float(), w.qw, w.scale, torch.float32)
        d = (out.float() - ref).abs()
        lim = 2 ** -8 * float(ref.abs().max())
        mx = float(d.max())
        good = bool(torch.isfinite(out.float()).all()) and mx <= lim
        splits, per = wmatmul.split_k(m, K, N)
        print(f"wmatmul {name}: m={m} K={K} N={N} {str(x.dtype)[6:]} x int8 -> "
              f"{str(out_dtype)[6:]}, {wmatmul.block_m(m)} rows a block, {splits} K "
              f"split(s): max_abs_err {mx:.3e} (<= {lim:.3e}) mean {float(d.mean()):.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        return good

    # every row count of a block (16 to 256), fp16 x and fp32 out
    for m in (1, 17, 64, 255, 256, 3601):
        K, N = 4096, 14336
        w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5)
        x = torch.randn(m, K, generator=gen, device="cuda")
        ok &= check("w_gate", x.to(torch.float16), w, torch.float16)
        ok &= check("w_gate", x.to(torch.bfloat16), w, torch.float32)
        del w, x
    for name, m, K, N in (("wq", 16, 4096, 4096), ("wk", 16, 4096, 1024),
                          ("w_gate", 16, 4096, 14336), ("w_down", 16, 14336, 4096),
                          ("lm_head", 16, 4096, 128256), ("w_gate", 3601, 4096, 14336)):
        x = torch.randn(m, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5)
        ok &= check(name, x, w, torch.bfloat16)
        ms = _time_ms(lambda: wmatmul.int8_matmul(x, w.qw, w.scale))
        plain_ms = _time_ms(lambda: wmatmul._int8_matmul_plain(x, w.qw, w.scale,
                                                               torch.bfloat16), iters=5)
        wd = dequantize_weight(w, torch.bfloat16)
        lib_ms = _time_ms(lambda: torch.matmul(x, wd))
        bound_ms, by = _bound(K * N + 4 * N + 2 * m * K + 2 * m * N, 2 * m * K * N)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms(torch.matmul, bf16 "
              f"weight) {lib_ms:.4f} bound_ms {bound_ms:.4f} ({by}); int8 weight "
              f"stream {K * N / ms / 1e6:.1f} GB/s, {2 * m * K * N / ms / 1e9:.1f} "
              f"TFLOP/s", flush=True)
        if name == "w_gate" and m == 16:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                       library_ms=lib_ms)
        del x, w, wd
    torch.cuda.empty_cache()
    return ok


def moe_kernels(records, gen):
    """Kernel 10's expert-bank launch (csrc/wmatmul.cu mfa_int8_bank_matmul,
    launch name wmatmul_bank) against its plain version in fp32 on the same
    inputs, limit 2^-8 of the largest output (kernel 10's): the dense form
    at Mixtral-8x7B's decode step (m 16, 8 experts: gate / up 4096 -> 14336
    over shared rows, down 14336 -> 4096 over each expert's rows), the
    grouped form at a wave's 3601 tokens x top 2 = 7202 expert-sorted rows
    with a skewed routing (one empty expert, one of a single row) and at a
    4 x 512 chunk batch (4096 rows), and K / N tails; each timed beside its
    bound and the library: torch.matmul on the bf16-dequantized bank
    (batched: torch.bmm's kernel) for the dense form, one torch.matmul an
    expert over host-known bounds for the grouped form."""
    import torch

    from mfa_tpu_torch.kernels import wmatmul
    from mfa_tpu_torch.models.wquant import dequantize_weight, quantize_weight

    ok = True
    rec = records["wmatmul_bank"]

    def bank(E, K, N):
        return quantize_weight(torch.randn(E, K, N, generator=gen, device="cuda")
                               * K ** -0.5)

    def check(name, x, w, offs=None, max_rows=None, timed=True):
        E, K, N = w.qw.shape
        out = wmatmul.int8_bank_matmul(x, w.qw, w.scale, offs=offs, max_rows=max_rows)
        ref = wmatmul._bank_plain(x.float(), w.qw, w.scale, offs, torch.float32)
        d = (out.float() - ref).abs()
        lim = 2 ** -8 * float(ref.abs().max())
        mx = float(d.max())
        good = bool(torch.isfinite(out.float()).all()) and mx <= lim
        rows = x.shape[-2] if offs is None else x.shape[0]
        print(f"wmatmul_bank {name}: {'dense' if offs is None else 'grouped'} E={E} "
              f"rows={rows} K={K} N={N}: max_abs_err {mx:.3e} (<= {lim:.3e}) mean "
              f"{float(d.mean()):.3e} {'ok' if good else 'FAIL'}", flush=True)
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        if not timed:
            return good, None
        ms = _time_ms(lambda: wmatmul.int8_bank_matmul(x, w.qw, w.scale, offs=offs,
                                                       max_rows=max_rows))
        plain_ms = _time_ms(lambda: wmatmul._bank_plain(x, w.qw, w.scale, offs,
                                                        torch.bfloat16), iters=3)
        wd = dequantize_weight(w, torch.bfloat16)
        if offs is None:
            lib_ms = _time_ms(lambda: torch.matmul(x, wd))
            flops = 2 * E * x.shape[-2] * K * N
            nbytes = E * K * N + 4 * E * N + x.numel() * 2 + E * x.shape[-2] * N * 2
        else:
            b = offs.tolist()
            lib_ms = _time_ms(lambda: [torch.matmul(x[b[e]:b[e + 1]], wd[e])
                                       for e in range(E)])
            flops = 2 * rows * K * N
            nbytes = E * K * N + 4 * E * N + rows * (K + N) * 2 + 4 * (E + 1)
        bound_ms, by = _bound(nbytes, flops)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms (torch.matmul, bf16 "
              f"bank) {lib_ms:.4f} bound_ms {bound_ms:.4f} ({by}), share of bound "
              f"{bound_ms / ms:.3f}; int8 bank stream {E * K * N / ms / 1e6:.1f} GB/s, "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        del wd
        return good, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                          library_ms=lib_ms)

    def offsets(sizes):
        return torch.tensor([0, *torch.tensor(sizes).cumsum(0).tolist()],
                            dtype=torch.int32, device="cuda")

    bf = torch.bfloat16
    # Mixtral decode step: gate / up (shared x), then down (each expert's x)
    w = bank(8, 4096, 14336)
    x = torch.randn(16, 4096, generator=gen, device="cuda").to(bf)
    good, times = check("decode gate/up", x, w)
    ok &= good
    rec.update(times)
    # the wave: 7202 rows, expert 2 empty, expert 5 one row
    sizes = (1500, 1100, 0, 1303, 1, 1298, 1000, 1000)
    xs = torch.randn(sum(sizes), 4096, generator=gen, device="cuda").to(bf)
    good, _ = check("wave gate/up", xs, w, offsets(sizes), max(sizes))
    ok &= good
    # a chunk batch: 4 x 512 tokens, 4096 rows
    sizes = (700, 430, 512, 388, 505, 611, 450, 500)
    xs = torch.randn(sum(sizes), 4096, generator=gen, device="cuda").to(bf)
    good, _ = check("chunk batch gate/up", xs, w, offsets(sizes), max(sizes))
    ok &= good
    del w, xs
    w = bank(8, 14336, 4096)
    xe = torch.randn(8, 16, 14336, generator=gen, device="cuda").to(bf)
    good, _ = check("decode down", xe, w)
    ok &= good
    sizes = (1500, 1100, 0, 1303, 1, 1298, 1000, 1000)
    xs = torch.randn(sum(sizes), 14336, generator=gen, device="cuda").to(bf)
    good, _ = check("wave down", xs, w, offsets(sizes), max(sizes))
    ok &= good
    del w, xe, xs
    # tails: K and N off the 64 / 128 tiles, fp16 rows, a tile straddling groups
    w = bank(4, 1040, 400)
    x = torch.randn(4, 37, 1040, generator=gen, device="cuda").to(torch.float16)
    good, _ = check("tails", x, w, timed=False)
    ok &= good
    sizes = (40, 1, 0, 55)
    xs = torch.randn(sum(sizes), 1040, generator=gen, device="cuda").to(torch.float16)
    good, _ = check("tails", xs, w, offsets(sizes), max(sizes), timed=False)
    ok &= good
    del w, x, xs
    torch.cuda.empty_cache()
    return ok


def varlen_kernels(records, rn):
    """Kernel 7 (packed varlen) against its plain version; SDPA times the
    equal-length cases, where packed varlen is batched causal attention,
    and there kernel 7 must equal kernel 1 (the same tile over the same
    tiles in the same order) bit for bit, O and LSE."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import prefill, varlen

    dev = "cuda"
    lens_a = [200, 1100, 512, 300, 700, 384, 450, 450]  # total 4096
    #        tag, lens_q, lens_k, causal, window, (hq, hkv, d)
    cases = (("8 packed causal", lens_a, lens_a, True, (-1, -1), (32, 8, 128)),
             ("8 packed, lens_k != lens_q, band (128, 64)", lens_a,
              [256, 1000, 600, 300, 640, 400, 500, 396], False, (128, 64), (32, 8, 128)),
             ("one zero-length sequence, causal", [300, 0, 517, 64],
              [300, 0, 517, 64], True, (-1, -1), (32, 8, 128)),
             ("equal lengths 8 x 512, causal", [512] * 8, [512] * 8, True,
              (-1, -1), (32, 8, 128)),
             ("d 256, equal lengths 4 x 2048, causal", [2048] * 4, [2048] * 4, True,
              (-1, -1), (8, 4, 256)),
             ("d 256, ragged, window (1023, -1), causal", [300, 1800, 77, 1000],
              [300, 1800, 77, 1000], True, (1023, -1), (8, 4, 256)))
    ok = True
    rec = records["varlen"]
    for tag, lq, lk, causal, window, (hq, hkv, d) in cases:
        scale = d ** -0.5
        q = rn(sum(lq), hq, d)
        k, v = rn(sum(lk), hkv, d), rn(sum(lk), hkv, d)
        cu_q = torch.tensor([0] + lq, device=dev).cumsum(0).int()
        cu_k = torch.tensor([0] + lk, device=dev).cumsum(0).int()
        wl, wr = window[0], 0 if causal else window[1]

        def run(q=q, k=k, v=v, cu_q=cu_q, cu_k=cu_k, lq=lq, lk=lk,
                causal=causal, window=window, lse=False):
            return varlen.varlen_attention(q, k, v, cu_q, cu_k, max(lq),
                                           max(lk), causal=causal,
                                           window_size=window, return_lse=lse)

        o, lse = run(lse=True)
        ro, rl = varlen._varlen_plain(q.float(), k.float(), v.float(), cu_q,
                                      cu_k, scale, wl, wr, 0.0, True)
        print(f"varlen {tag}: lens_q {lq} lens_k {lk} hq={hq} hkv={hkv} "
              f"d={d} bf16", flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        ms = _time_ms(run)
        plain_ms = _time_ms(lambda: varlen._varlen_plain(
            q, k, v, cu_q, cu_k, scale, wl, wr, 0.0, False), iters=3)
        pairs = sum(_visible_pairs(a, b, 0, wl, wr) for a, b in zip(lq, lk))
        bound_ms, by = _bound(2 * (2 * sum(lq) * hq * d + 2 * sum(lk) * hkv * d),
                              4 * hq * pairs * d)
        lib = ""
        if len(set(lq)) == 1 and lq == lk:
            n, s = len(lq), lq[0]

            def batched(t):  # [n * s, h, d] -> [n, h, s, d]
                return t.view(n, s, t.shape[1], d).transpose(1, 2).contiguous()

            qb, kb, vb = batched(q), batched(k), batched(v)
            o1, l1 = prefill.prefill_attention(qb, kb, vb, causal=True, return_lse=True,
                                               bound_softmax=False)
            same = torch.equal(batched(o), o1) and torch.equal(
                lse.view(hq, n, s).transpose(0, 1), l1)
            print(f"  equal to kernel 1 on [{n}, {hq}, {s}, {d}] bit for bit (O and "
                  f"LSE): {same}", flush=True)
            ok &= same
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qb, kb, vb, is_causal=True, enable_gqa=True))
            lib = f" library_ms(sdpa is_causal, batched {n} x {s}) {lib_ms:.4f}"
            if d == 128:
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                           library_ms=lib_ms)
            del qb, kb, vb, o1, l1
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
              f"({by}){lib}", flush=True)
    return ok


def paged_prefill_kernels(records, rn, gen):
    """Kernel 8 (paged prefill) against its plain version: the engine's
    chunk batch (int8 pages) and the varlen paged route's shape (bf16);
    then Gemma3-4B's chunk batch at head_dim 256 (_paged_prefill_batch)."""
    import torch

    from mfa_tpu_torch.kernels import paged_prefill
    from mfa_tpu_torch.kernels.quant import quantize_rows

    dev, hq, hkv, d, page = "cuda", 32, 8, 128, 64
    scale = d ** -0.5
    cases = (("engine chunk batch: 4 x 512, q_start 0/1024/2048/3072, int8 "
              "pages", True, [0, 1024, 2048, 3072], 512, None),
             ("varlen paged route: q_start 0, lens 512/1024/300/700, bf16 "
              "pages", False, [0, 0, 0, 0], 1024, [512, 1024, 300, 700]))
    ok = True
    rec = records["paged_prefill"]
    for tag, quant, q_start, sq, q_lens in cases:
        b = len(q_start)
        q_lens = q_lens or [sq] * b
        lens = [s + n for s, n in zip(q_start, q_lens)]
        pps = max(lens) // page + 1
        P = b * pps + 1
        q = rn(b, sq, hq, d)
        kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
        if quant:
            (kp, ks), (vp, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
        else:
            kp, vp, ks, vs = kf, vf, None, None
        table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
                 ).reshape(b, pps).to(torch.int32)  # non-contiguous pages
        L = torch.tensor(lens, dtype=torch.int32, device=dev)
        QS = torch.tensor(q_start, dtype=torch.int32, device=dev)
        QL = torch.tensor(q_lens, dtype=torch.int32, device=dev)

        def run(lse=False):
            return paged_prefill.paged_prefill_attention(
                q, kp, vp, L, QS, table, q_lens=QL, k_scales=ks, v_scales=vs,
                causal=True, return_lse=lse)

        o, lse = run(True)
        ro, rl = paged_prefill._paged_prefill_plain(
            q.float(), kp, vp, ks, vs, L, QS, QL, table, scale, -1, 0, 0.0)
        print(f"paged_prefill {tag}: hq={hq} hkv={hkv} d={d} page={page}",
              flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        ms = _time_ms(run)
        plain_ms = _time_ms(lambda: paged_prefill._paged_prefill_plain(
            q, kp, vp, ks, vs, L, QS, QL, table, scale, -1, 0, 0.0), iters=3)
        # each row's KV pages once (int8: payload + fp32 scales), q in, o out
        kv_rows = sum(-(-n // page) * page for n in lens) * hkv
        nbytes = 2 * kv_rows * d * kp.element_size() + (8 * kv_rows if quant else 0) \
            + b * pps * 4 + 2 * b * sq * hq * d * 2
        pairs = sum(_visible_pairs(n, n_k, s, -1, 0)
                    for s, n, n_k in zip(q_start, q_lens, lens))
        bound_ms, by = _bound(nbytes, 4 * hq * pairs * d)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a "
              f"bound_ms {bound_ms:.4f} ({by})", flush=True)
        if quant:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by, library_ms=None)
    # Gemma3-4B's chunk batch: hq8 hkv4 d256, int8 pages causal and with the
    # sliding layers' window 1023, and bf16, fp8 and int4 pages
    return ok and _paged_prefill_batch(
        records, rn, gen, "Gemma3-4B chunk batch", 8, 4, 256,
        (("int8", -1, 0.0), ("int8", 1023, 0.0), (None, -1, 0.0), ("fp8", -1, 0.0),
         ("int4", -1, 0.0)))


def _paged_prefill_batch(records, rn, gen, tag, hq, hkv, d, cases,
                         q_start=(1536,) * 4, q_lens=(512, 512, 512, 500)):
    """Kernel 8 at a chunk batch (default: 4 x 512 rows at q_start 1536, the
    last chunk 500 rows), pages of 64, for each case (format, window,
    softcap); rows past each length in a sequence's last page hold NaN
    (16-bit pages) or NaN scales (and fp8 the NaN code 0x7F), and rows past
    q_lens must come out O = 0, LSE = -inf. Held to the plain version on
    the pages before the poisoning (max 2e-2, mean 2e-3, LSE within 1e-3
    with the same -inf rows) and timed beside the bound (4 hq d flops per
    visible pair)."""
    import torch

    from mfa_tpu_torch.kernels import paged, paged_prefill

    page, sq = 64, max(q_lens)
    q_start, q_lens = list(q_start), list(q_lens)
    lens = [s_ + n for s_, n in zip(q_start, q_lens)]
    b, pps = len(lens), max(lens) // page + 1
    P = b * pps + 1
    q = rn(b, sq, hq, d)
    kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
    table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
             ).reshape(b, pps).to(torch.int32)
    L, QS, QL = (torch.tensor(x, dtype=torch.int32, device="cuda")
                 for x in (lens, q_start, q_lens))
    stale = torch.zeros(hkv, P, page, dtype=torch.bool, device="cuda")
    for i, n in enumerate(lens):
        if n % page:
            stale[:, int(table[i, n // page]), n % page:] = True
    dead = torch.arange(sq, device="cuda")[None] >= QL[:, None]  # [b, sq]
    ok = True
    for quant, wl, cap in cases:
        if quant is None:
            kp, vp, ks, vs = kf.clone(), vf.clone(), None, None
            clean = (kf, vf, None, None)
            kp[stale], vp[stale] = float("nan"), float("nan")
        else:
            kp, vp, ks, vs = _kv_pages(kf, vf, quant)
            clean = tuple(t.clone() for t in (kp, vp, ks, vs))
            _poison_stale(kp, ks, quant, stale)
            _poison_stale(vp, vs, quant, stale)

        def run(lse=False, kp=kp, vp=vp, ks=ks, vs=vs, quant=quant, wl=wl, cap=cap):
            return paged_prefill.paged_prefill_attention(
                q, kp, vp, L, QS, table, q_lens=QL, k_scales=ks, v_scales=vs,
                causal=True, window_left=wl, logit_softcap=cap, quant_dtype=quant,
                return_lse=lse)

        o, lse = run(True)
        ro, rl = paged_prefill._paged_prefill_plain(
            q.float(), *clean, L, QS, QL, table, d ** -0.5, wl, 0, cap,
            quant_dtype=quant)
        fmt = quant or "bf16"
        print(f"paged_prefill {fmt} pages, {tag}: {b} x {sq} rows at "
              f"q_start {q_start}, q_lens {q_lens}, hq={hq} hkv={hkv} (group "
              f"{hq // hkv}) d={d} page={page}"
              f"{f', window {wl}' if wl >= 0 else ''}"
              f"{f', softcap {cap}' if cap else ''}; rows past lens: NaN "
              f"{'values' if quant is None else 'scales'}"
              f"{', 0x7F payload' if quant == 'fp8' else ''}", flush=True)
        mx, good = _err(o, ro, what="O")
        good = good and _lse_err(lse, rl, "")
        zero = bool((o[dead] == 0).all()) and bool(torch.isneginf(lse.transpose(1, 2)[dead]).all())
        print(f"  rows past q_lens: O = 0 and LSE = -inf {zero}", flush=True)
        ok &= good and zero
        rec = records[paged.launch_name("paged_prefill", quant)]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), mx)
        ms = _time_ms(run)
        plain_ms = _time_ms(lambda: paged_prefill._paged_prefill_plain(
            q, *clean, L, QS, QL, table, d ** -0.5, wl, 0, cap, quant_dtype=quant),
            iters=3)
        kv_rows = sum(lens) * hkv
        nbytes = 2 * kv_rows * _row_bytes(quant, d) + b * pps * 4 + 2 * b * sq * hq * d * 2
        pairs = sum(_visible_pairs(n, n_k, s_, wl, 0)
                    for s_, n, n_k in zip(q_start, q_lens, lens))
        bound_ms, by = _bound(nbytes, 4 * hq * pairs * d)
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a bound_ms "
              f"{bound_ms:.4f} ({by}) bound share {bound_ms / ms:.3f}", flush=True)
    del q, kf, vf, kp, vp, o, ro
    torch.cuda.empty_cache()
    return ok


def family_kernels(records, rn, gen):
    """The dense families' shapes. Kernel 8 at Qwen2-7B's chunk batch (4 x
    512 at q_start 1536, hq 28 / hkv 4: 7 q heads a kv head, which leaves a
    dead tail row in each 64-row warpgroup; d 128, int8 pages of 64), timed
    beside group 8 (hq 32 / hkv 4) on the same positions; groups 5 and 6 at
    2 x 256 on bf16, fp8 and int4 pages; Gemma2-9B's (hq 16 / hkv 8, d 256,
    softcap 50, window 4095 and none, int8 pages). Kernel 6 at Gemma2-9B's
    decode step (16 rows of 2500-4100 tokens, softcap 50, window 4095 and
    none) and Qwen2-7B's (group 7); kernel 1 at the Gemma2-9B wave (4 x 256,
    softcap 50: the classic engine, which softcap selects); kernels 2 + 3 at
    Qwen2-7B's wave (4 x 256, group 7). Every output within max 2e-2 / mean
    2e-3 of its plain version, LSE within 1e-3 with the same -inf rows."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import _build, paged, prefill

    ok = _paged_prefill_batch(records, rn, gen, "Qwen2-7B chunk batch", 28, 4, 128,
                              (("int8", -1, 0.0),))
    ok &= _paged_prefill_batch(records, rn, gen, "group 8 at Qwen2-7B's positions",
                               32, 4, 128, (("int8", -1, 0.0),))
    for hq, hkv in ((20, 4), (12, 2)):
        ok &= _paged_prefill_batch(records, rn, gen, f"group {hq // hkv}", hq, hkv, 128,
                                   ((None, -1, 0.0), ("fp8", -1, 0.0), ("int4", 100, 0.0)),
                                   q_start=(512, 64), q_lens=(256, 200))
    ok &= _paged_prefill_batch(records, rn, gen, "Gemma2-9B chunk batch", 16, 8, 256,
                               (("int8", -1, 50.0), ("int8", 4095, 50.0)))
    # kernel 6 at the decode steps of Gemma2-9B and Qwen2-7B (int8 pages of 64)
    page = 64
    lens_l = [2500 + 100 * i for i in range(16)]
    b, pps = len(lens_l), max(lens_l) // page + 1
    L = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    for model, hq, hkv, d, cases in (("Gemma2-9B", 16, 8, 256, ((4095, 50.0), (-1, 50.0))),
                                     ("Qwen2-7B", 28, 4, 128, ((-1, 0.0),))):
        P = b * pps + 1
        q = rn(b, hq, d)
        kp, vp, ks, vs = _kv_pages(rn(hkv, P, page, d), rn(hkv, P, page, d), "int8")
        bt = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
              ).reshape(b, pps).to(torch.int32)
        for wl, cap in cases:
            def run(lse=False, q=q, kp=kp, vp=vp, ks=ks, vs=vs, bt=bt, wl=wl, cap=cap):
                return paged.paged_attention(q, kp, vp, L, bt, k_scales=ks, v_scales=vs,
                                             window_left=wl, logit_softcap=cap,
                                             pos_offset=1, return_lse=lse)

            o, lse = run(True)
            ro, rl = paged._paged_plain(q.float(), kp, vp, ks, vs, L, bt, d ** -0.5,
                                        wl, cap, 1)
            print(f"paged int8 pages, {model} decode step: b={b} hq={hq} hkv={hkv} "
                  f"d={d} lens {min(lens_l)}..{max(lens_l)}"
                  f"{f', window {wl}' if wl >= 0 else ''}"
                  f"{f', softcap {cap}' if cap else ''}", flush=True)
            mx, good = _err(o, ro, what="O")
            ok &= good and _lse_err(lse, rl, "")
            records["paged"]["max_abs_err"] = max(records["paged"]["max_abs_err"], mx)
            ms = _time_ms(run)
            plain_ms = _time_ms(lambda: paged._paged_plain(
                q, kp, vp, ks, vs, L, bt, d ** -0.5, wl, cap, 1), iters=3)
            rows = sum(min(n - 1, wl + 1) if wl >= 0 else n - 1 for n in lens_l) * hkv
            nbytes = 2 * rows * _row_bytes("int8", d) + b * pps * 4 + 2 * b * hq * d * 2
            bound_ms, by = _bound(nbytes, 4 * hq // hkv * rows * d)
            print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms n/a bound_ms "
                  f"{bound_ms:.4f} ({by})", flush=True)
    # kernel 1 at the Gemma2-9B wave, kernels 2 + 3 at the Qwen2-7B wave
    b, s = 4, 256
    for model, hq, hkv, d, cases in (("Gemma2-9B", 16, 8, 256, ((4095, 50.0), (-1, 50.0))),
                                     ("Qwen2-7B", 28, 4, 128, ((-1, 0.0),))):
        q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
        for wl, cap in cases:
            _build.reset_launches()
            o, lse = prefill.prefill_attention(q, k, v, causal=True, window_size=(wl, -1),
                                               logit_softcap=cap, return_lse=True)
            got = dict(_build.launches)
            ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5,
                                            wl, 0, cap, True)
            names = ("prefill",) if cap else ("flagged", "repair")
            print(f"prefill wave, {model}: b={b} hq={hq} hkv={hkv} s={s} d={d}"
                  f"{f', window {wl}' if wl >= 0 else ''}"
                  f"{f', softcap {cap}' if cap else ''}: launches {got}", flush=True)
            mx, good = _err(o, ro, what="O")
            ok &= good and _lse_err(lse, rl, "") and _wave_launches(got, 1, bool(cap))
            for n in names:
                records[n]["max_abs_err"] = max(records[n]["max_abs_err"], mx)
            ms = _time_ms(lambda: prefill.prefill_attention(
                q, k, v, causal=True, window_size=(wl, -1), logit_softcap=cap))
            plain_ms = _time_ms(lambda: prefill._prefill_plain(
                q, k, v, d ** -0.5, wl, 0, cap, False), iters=3)
            bound_ms, by = _bound(2 * (2 * b * hq * s * d + 2 * b * hkv * s * d),
                                  4 * b * hq * _visible_pairs(s, s, 0, wl, 0) * d)
            lib = "n/a"  # SDPA takes no softcap: a library time for the uncapped wave
            if not cap:
                lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
                lib = f"{lib_ms:.4f} (sdpa)"
            print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} bound_ms "
                  f"{bound_ms:.4f} ({by})", flush=True)
    torch.cuda.empty_cache()
    return ok


def _bwd_close(got, ref, what):
    """Each of dq, dk, dv within max |a - r| <= 2e-2 max |r| and mean |a - r|
    <= 2e-2 mean |r|, and finite: only P and dS round to bf16 before their
    products, and the fused kernel's dQ additions across blocks change the
    summation order. Returns (largest max abs error, ok)."""
    import torch

    worst, ok = 0.0, True
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        if g is None:
            continue
        d = (g.float() - r.float()).abs()
        mx, mean = float(d.max()), float(d.mean())
        rmax, rmean = float(r.float().abs().max()), float(r.float().abs().mean())
        good = bool(torch.isfinite(g.float()).all()) and mx <= 2e-2 * rmax \
            and mean <= 2e-2 * rmean
        print(f"  {what} {name}: max_abs_err {mx:.3e} (<= {2e-2 * rmax:.3e}) "
              f"mean {mean:.3e} (<= {2e-2 * rmean:.3e}) {'ok' if good else 'FAIL'}",
              flush=True)
        worst, ok = max(worst, mx), ok and good
    return worst, ok


def backward_kernels(records, rn):
    """Kernels 11-14: the five backward launches against their plain
    version (fp32 on the same bf16 inputs, dO ~ N(0, 1)), fused against
    split, and each launch timed alone; at head_dim 128 and at Gemma3-4B's
    train shape (b4 hq8 hkv4 s2048 d256, causal and with the sliding
    layers' window (1023, 0)), where the split runs twice to the same bits
    and kernel 14 on 4 x 2048 equal lengths gives kernels 12 + 13's bits.
    The bound counts 10 * hq * d flops
    per visible pair for the whole backward (5 products), 8 for the dK/dV
    launch, 6 for the dQ launch; bytes read q, k, v, O (or delta), dO, LSE
    once and write the launch's gradients once. SDPA's backward alone (a
    boolean band mask for a window; on equal lengths, batched, beside
    kernel 14) is the library time."""
    import torch

    from mfa_tpu_torch.kernels import backward, prefill, varlen

    dev, bf = "cuda", torch.bfloat16
    ok = True
    #        tag, b, hq, hkv, sq, sk, d, window (left, right), record
    dense = (("training shape, causal", 4, 32, 8, 2048, 2048, 128, (-1, 0), True),
             ("d 64, causal", 2, 32, 8, 1024, 1024, 64, (-1, 0), False),
             ("sq 128 < sk 512, causal", 1, 32, 8, 128, 512, 128, (-1, 0), False),
             ("sq 300, sk 8, window (4, -1) causal: dead rows", 1, 32, 8, 300, 8,
              128, (4, 0), False),
             ("Gemma3-4B train shape, causal", 4, 8, 4, 2048, 2048, 256, (-1, 0),
              False),
             ("Gemma3-4B train shape, window (1023, 0)", 4, 8, 4, 2048, 2048, 256,
              (1023, 0), False))
    for tag, b, hq, hkv, sq, sk, d, (wl, wr), record in dense:
        scale = d ** -0.5
        q, k, v = rn(b, hq, sq, d), rn(b, hkv, sk, d), rn(b, hkv, sk, d)
        do = rn(b, hq, sq, d)
        o, lse = prefill.prefill_attention(q, k, v, window_size=(wl, wr),
                                           return_lse=True)
        print(f"backward {tag}: b={b} hq={hq} hkv={hkv} sq={sq} sk={sk} d={d} "
              f"bf16", flush=True)
        ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                  do.float(), scale, wl, wr, 0.0)
        kw = dict(window_size=(wl, wr))
        fused = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=True, **kw)
        split = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
        e_f, g1 = _bwd_close(fused, ref, "fused")
        e_kv, g2 = _bwd_close((None,) + split[1:], ref, "split dkv")
        e_q, g3 = _bwd_close(split[:1] + (None, None), ref, "split dq")
        _, g4 = _bwd_close(fused, split, "fused vs split")
        ok &= g1 and g2 and g3 and g4
        dead = torch.isneginf(lse)
        if dead.any():  # rows that saw no column: zero gradients, exactly
            zero = all(bool((g[dead] == 0).all()) for g in (fused[0], split[0]))
            print(f"  {int(dead.sum())} dead rows: dq exactly 0 in both {zero}",
                  flush=True)
            ok &= zero
        for n, e in (("bwd_fused", e_f), ("bwd_dkv", e_kv), ("bwd_dq", e_q)):
            records[n]["max_abs_err"] = max(records[n].get("max_abs_err", 0.0), e)
        args = backward._dense_cuda_inputs(q, k, v, o, lse, do) + (scale, wl, wr, 0.0)
        launch = {"bwd_fused": backward._launch_fused,
                  "bwd_dkv": backward._launch_dkv, "bwd_dq": backward._launch_dq}
        ms = {n: _time_ms(lambda fn=fn: fn(*args), iters=5)
              for n, fn in launch.items()}
        plain_ms = _time_ms(lambda: backward._bwd_plain(
            q, k, v, o, lse, do, scale, wl, wr, 0.0), iters=2)
        pairs = b * hq * _visible_pairs(sq, sk, 0, wl, wr)
        qb, kb = b * hq * sq * d * 2, b * hkv * sk * d * 2
        row_b = b * hq * sq * 4
        bounds = {"bwd_fused": _bound(4 * qb + 4 * kb + row_b, 10 * pairs * d),
                  "bwd_dkv": _bound(2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d),
                  "bwd_dq": _bound(2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)}
        lib = ""
        lib_ms = None
        if wr == 0 and sq == sk:
            lib_ms = _sdpa_bwd_ms(q, k, v, do, None if wl < 0 else _band_mask(sq, wl, dev))
            split_ms = ms["bwd_dkv"] + ms["bwd_dq"]
            lib = (f" library_ms(sdpa backward alone) {lib_ms:.4f}; fused / sdpa "
                   f"{ms['bwd_fused'] / lib_ms:.2f}x, split 12 + 13 / sdpa "
                   f"{split_ms / lib_ms:.2f}x")
        if d == 256:  # the split's two launches give the same bits twice
            same = all(torch.equal(a_, b_) for a_, b_ in zip(split, backward.flash_attention_bwd(
                q, k, v, o, lse, do, fused=False, **kw)))
            print(f"  split twice: the same bits {same}", flush=True)
            ok &= same
        print(f"  fused ms {ms['bwd_fused']:.4f} split ms {ms['bwd_dkv']:.4f} + "
              f"{ms['bwd_dq']:.4f} = {ms['bwd_dkv'] + ms['bwd_dq']:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {bounds['bwd_fused'][0]:.4f} "
              f"({bounds['bwd_fused'][1]}; dkv {bounds['bwd_dkv'][0]:.4f}, dq "
              f"{bounds['bwd_dq'][0]:.4f}){lib}", flush=True)
        if record:
            for n in ms:
                records[n].update(ms=ms[n], plain_ms=plain_ms, bound_ms=bounds[n][0],
                                  bound_by=bounds[n][1],
                                  library_ms=lib_ms if n == "bwd_fused" else None)
        del ref, fused, split, args
        torch.cuda.empty_cache()

    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5
    lens_a = [200, 1100, 512, 300, 700, 384, 450, 450]
    cases = (("8 packed causal", lens_a, lens_a, (-1, 0), 0.0),
             ("8 packed, lens_k != lens_q, band (128, 64)", lens_a,
              [256, 1000, 600, 300, 640, 400, 500, 396], (128, 64), 0.0),
             ("one zero-length sequence, causal", [300, 0, 517, 64],
              [300, 0, 517, 64], (-1, 0), 0.0),
             ("8 packed causal, softcap 30", lens_a, lens_a, (-1, 0), 30.0),
             ("8 x 512 equal lengths, causal", [512] * 8, [512] * 8, (-1, 0), 0.0))
    for i, (tag, lq, lk, (wl, wr), cap) in enumerate(cases):
        q = rn(sum(lq), hq, d)
        k, v = rn(sum(lk), hkv, d), rn(sum(lk), hkv, d)
        do = rn(sum(lq), hq, d)
        cu_q = torch.tensor([0] + lq, device=dev).cumsum(0).int()
        cu_k = torch.tensor([0] + lk, device=dev).cumsum(0).int()
        o, lse = varlen.varlen_attention(q, k, v, cu_q, cu_k, max(lq), max(lk),
                                         window_size=(wl, wr), logit_softcap=cap,
                                         return_lse=True)
        print(f"varlen backward {tag}: lens_q {lq} lens_k {lk} hq={hq} hkv={hkv} "
              f"d={d} bf16", flush=True)
        got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu_q, cu_k,
                                            window_size=(wl, wr), logit_softcap=cap)
        ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                                         lse, do.float(), cu_q, cu_k, scale, wl, wr,
                                         cap)
        e_q, g1 = _bwd_close(got[:1] + (None, None), ref, "varlen dq")
        e_kv, g2 = _bwd_close((None,) + got[1:], ref, "varlen dkv")
        ok &= g1 and g2
        records["varlen_bwd_dq"]["max_abs_err"] = max(
            records["varlen_bwd_dq"].get("max_abs_err", 0.0), e_q)
        records["varlen_bwd_dkv"]["max_abs_err"] = max(
            records["varlen_bwd_dkv"].get("max_abs_err", 0.0), e_kv)
        args = backward._varlen_cuda_inputs(q, k, v, o, lse, do, cu_q, cu_k)
        tail = (cu_q, cu_k)
        ms_kv = _time_ms(lambda: backward._launch_varlen_dkv(
            *args, *tail, max(lk), scale, wl, wr, cap), iters=5)
        ms_q = _time_ms(lambda: backward._launch_varlen_dq(
            *args, *tail, max(lq), scale, wl, wr, cap), iters=5)
        plain_ms = _time_ms(lambda: backward._varlen_bwd_plain(
            q, k, v, o, lse, do, cu_q, cu_k, scale, wl, wr, cap), iters=2)
        pairs = hq * sum(_visible_pairs(a, b_, 0, wl, wr) for a, b_ in zip(lq, lk))
        qb, kb, row_b = sum(lq) * hq * d * 2, sum(lk) * hkv * d * 2, sum(lq) * hq * 4
        b_kv = _bound(2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d)
        b_q = _bound(2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)
        b_all = _bound(4 * qb + 4 * kb + row_b, 10 * pairs * d)
        lib = "library_ms none (ragged)"
        if len(set(lq)) == 1 and lq == lk and not cap:
            # equal lengths: SDPA's batched backward computes the same function
            n_s, s_ = len(lq), lq[0]

            def batched(t):  # [n * s, h, d] -> [n, h, s, d]
                return t.view(n_s, s_, t.shape[1], d).transpose(1, 2).contiguous()

            lib_ms = _sdpa_bwd_ms(batched(q), batched(k), batched(v), batched(do))
            lib = (f"library_ms(sdpa batched backward) {lib_ms:.4f}; pair / sdpa "
                   f"{(ms_kv + ms_q) / lib_ms:.2f}x")
        print(f"  dkv ms {ms_kv:.4f} + dq ms {ms_q:.4f} = {ms_kv + ms_q:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {b_all[0]:.4f} ({b_all[1]}; dkv "
              f"{b_kv[0]:.4f}, dq {b_q[0]:.4f}) {lib}", flush=True)
        if i == 0:
            records["varlen_bwd_dkv"].update(ms=ms_kv, plain_ms=plain_ms,
                                             bound_ms=b_kv[0], bound_by=b_kv[1],
                                             library_ms=None)
            records["varlen_bwd_dq"].update(ms=ms_q, plain_ms=plain_ms,
                                            bound_ms=b_q[0], bound_by=b_q[1],
                                            library_ms=None)
    return ok and _varlen_bwd_gemma3(records, rn)


def _band_mask(s, wl, dev):
    """[s, s] bool: row r sees columns r - wl .. r (SDPA's mask for a
    causal window)."""
    import torch

    r = torch.arange(s, device=dev)
    return (r[None] <= r[:, None]) & (r[None] >= r[:, None] - wl)


def _varlen_bwd_gemma3(records, rn):
    """Kernel 14 at Gemma3-4B's heads on 4 x 2048 equal lengths with the
    sliding window (1023, 0): within _bwd_close of the plain version, and
    bit for bit kernels 12 + 13 on the same data batched; timed beside its
    bound."""
    import torch

    from mfa_tpu_torch.kernels import backward, varlen

    n, s, hq, hkv, d, wl = 4, 2048, 8, 4, 256, 1023
    scale = d ** -0.5
    q, do = rn(n * s, hq, d), rn(n * s, hq, d)
    k, v = rn(n * s, hkv, d), rn(n * s, hkv, d)
    cu = torch.arange(0, n * s + 1, s, device="cuda", dtype=torch.int32)
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, s, s, window_size=(wl, 0),
                                     return_lse=True)
    got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu,
                                        window_size=(wl, 0))
    ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), cu, cu, scale, wl, 0, 0.0)
    print(f"varlen backward Gemma3-4B heads: {n} x {s} equal lengths, window ({wl}, 0), "
          f"hq={hq} hkv={hkv} d={d} bf16", flush=True)
    e_q, g1 = _bwd_close(got[:1] + (None, None), ref, "varlen dq")
    e_kv, g2 = _bwd_close((None,) + got[1:], ref, "varlen dkv")

    def batched(t):  # [n * s, h, d] -> [n, h, s, d]
        return t.view(n, s, t.shape[1], d).transpose(1, 2).contiguous()

    args = backward._varlen_cuda_inputs(q, k, v, o, lse, do, cu, cu)
    rows = tuple(t.view(t.shape[0], n, s).transpose(0, 1).contiguous() for t in args[4:])
    dense = tuple(batched(t) for t in args[:4]) + rows + (scale, wl, 0, 0.0)
    dk1, dv1 = backward._launch_dkv(*dense)
    dq1 = backward._launch_dq(*dense)
    same = torch.equal(batched(got[0]), dq1) and torch.equal(batched(got[1]), dk1) \
        and torch.equal(batched(got[2]), dv1)
    print(f"  kernel 14 bit for bit kernels 12 + 13 on the batched data: {same}",
          flush=True)
    for name, e in (("varlen_bwd_dq", e_q), ("varlen_bwd_dkv", e_kv)):
        records[name]["max_abs_err"] = max(records[name].get("max_abs_err", 0.0), e)
    tail = (cu, cu, s, scale, wl, 0, 0.0)
    ms_kv = _time_ms(lambda: backward._launch_varlen_dkv(*args, *tail), iters=5)
    ms_q = _time_ms(lambda: backward._launch_varlen_dq(*args, *tail), iters=5)
    plain_ms = _time_ms(lambda: backward._varlen_bwd_plain(
        q, k, v, o, lse, do, cu, cu, scale, wl, 0, 0.0), iters=2)
    pairs = n * hq * _visible_pairs(s, s, 0, wl, 0)
    qb, kb, row_b = n * s * hq * d * 2, n * s * hkv * d * 2, n * s * hq * 4
    b_kv = _bound(2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d)
    b_q = _bound(2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)
    # equal lengths: SDPA's batched backward with the band mask computes the
    # same function
    lib_ms = _sdpa_bwd_ms(batched(q), batched(k), batched(v), batched(do),
                          _band_mask(s, wl, "cuda"))
    print(f"  dkv ms {ms_kv:.4f} (bound {b_kv[0]:.4f}, {b_kv[1]}) + dq ms {ms_q:.4f} "
          f"(bound {b_q[0]:.4f}, {b_q[1]}) plain_ms {plain_ms:.4f} library_ms(sdpa "
          f"batched backward + band mask) {lib_ms:.4f}; pair / sdpa "
          f"{(ms_kv + ms_q) / lib_ms:.2f}x", flush=True)
    del q, k, v, do, o, got, ref, args, dense
    torch.cuda.empty_cache()
    return g1 and g2 and same


def library_surface(counts):
    """Main path, part 1: the reference library's own entry points."""
    import torch

    import mfa_tpu_torch
    from mfa_tpu_torch.kernels import _build, autodiff, backward, prefill

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    _build.reset_launches()
    q, k, v = rn(16, 256, 32, 128), rn(16, 256, 8, 128), rn(16, 256, 8, 128)
    o1 = mfa_tpu_torch.flash_attn_func(q, k, v, causal=True)  # kernels 2 + 3
    # kernel 1: softcap and fp16 keep the classic engine; kernel 4: the
    # default at head_dim 64
    o1c = mfa_tpu_torch.flash_attn_func(q, k, v, causal=True, softcap=30.0)
    o1h = mfa_tpu_torch.flash_attn_func(q.half(), k.half(), v.half(), causal=True)
    o1d = mfa_tpu_torch.flash_attn_func(q[..., :64], k[..., :64], v[..., :64],
                                        causal=True)
    qd = rn(16, 1, 32, 128)
    kc, vc = rn(16, 8192, 8, 128), rn(16, 8192, 8, 128)
    o2 = mfa_tpu_torch.flash_attn_with_kvcache(qd, kc, vc, cache_seqlens=8192)
    kp, vp = rn(256, 64, 8, 128), rn(256, 64, 8, 128)
    table = torch.arange(1, 1 + 16 * 4, device="cuda",
                         dtype=torch.int32).reshape(16, 4)
    o3 = mfa_tpu_torch.flash_attn_with_kvcache(qd, kp, vp, cache_seqlens=200,
                                               block_table=table)
    # packed varlen (8 sequences, 4096 tokens) and its paged route over the
    # pool above (4 sequences, pages through a table)
    lens = [200, 1100, 512, 300, 700, 384, 450, 450]
    cu = torch.tensor([0] + lens, device="cuda").cumsum(0).int()
    qv, kv, vv = rn(4096, 32, 128), rn(4096, 8, 128), rn(4096, 8, 128)
    o4 = mfa_tpu_torch.flash_attn_varlen_func(qv, kv, vv, cu, cu, max(lens),
                                              max(lens), causal=True)
    plens = [100, 256, 37, 180]
    cu_p = torch.tensor([0] + plens, device="cuda").cumsum(0).int()
    qp = rn(sum(plens), 32, 128)
    o5 = mfa_tpu_torch.flash_attn_varlen_func(qp, kp, vp, cu_p, cu_p,
                                              max(plens), max(plens),
                                              causal=True,
                                              block_table=table[:4])
    # the gradient functions: [b, s, h, d] with a backward (fused kernel),
    # flash_attention_bwd on the split, packed varlen with a backward
    leaves = [t.detach().requires_grad_() for t in (q, k, v, qv, kv, vv)]
    o6 = autodiff.flash_attn_func_grad(*leaves[:3], causal=True)
    o7 = autodiff.flash_attn_varlen_func_grad(*leaves[3:], cu, cu, max(lens),
                                              max(lens), causal=True)
    grads = torch.autograd.grad((o6.float() * o1.float()).sum()
                                + (o7.float() * o4.float()).sum(), leaves)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        ot, lse = prefill.prefill_attention(qt, kt, vt, causal=True,
                                            return_lse=True)
        grads += backward.flash_attention_bwd(qt, kt, vt, ot, lse, ot,
                                              causal=True, fused=False)
    # the band options on every entry point: ALiBi (flash_attn_func, the
    # kvcache and varlen entry points and the gradient functions), sinks
    # (varlen packed and paged, kvcache contiguous and paged) and the
    # offset (prefill_attention and its backward)
    slopes = _alibi_slopes(32)
    band = [mfa_tpu_torch.flash_attn_func(q, k, v, causal=True, alibi_slopes=slopes),
            mfa_tpu_torch.flash_attn_with_kvcache(qd, kc, vc, cache_seqlens=8192,
                                                  window_size=(4095, -1),
                                                  sink_tokens=4, alibi_slopes=slopes),
            mfa_tpu_torch.flash_attn_with_kvcache(qd, kp, vp, cache_seqlens=200,
                                                  block_table=table,
                                                  window_size=(63, -1), sink_tokens=4,
                                                  alibi_slopes=slopes),
            mfa_tpu_torch.flash_attn_varlen_func(qv, kv, vv, cu, cu, max(lens),
                                                 max(lens), causal=True,
                                                 window_size=(255, -1), sink_tokens=4,
                                                 alibi_slopes=slopes),
            mfa_tpu_torch.flash_attn_varlen_func(qp, kp, vp, cu_p, cu_p, max(plens),
                                                 max(plens), causal=True,
                                                 block_table=table[:4],
                                                 window_size=(63, -1), sink_tokens=4,
                                                 alibi_slopes=slopes)]
    leaves_a = [t.detach().requires_grad_() for t in (q, k, v, qv, kv, vv)]
    oa = autodiff.flash_attn_func_grad(*leaves_a[:3], causal=True, alibi_slopes=slopes)
    ova = autodiff.flash_attn_varlen_func_grad(*leaves_a[3:], cu, cu, max(lens),
                                               max(lens), causal=True,
                                               alibi_slopes=slopes)
    grads += torch.autograd.grad((oa.float() * o1.float()).sum()
                                 + (ova.float() * o4.float()).sum(), leaves_a)
    with torch.no_grad():
        oo, lso = prefill.prefill_attention(qt, kt, vt, causal=True,
                                            kv_position_offset=64, return_lse=True)
        grads += backward.flash_attention_bwd(qt, kt, vt, oo, lso, oo, causal=True,
                                              kv_position_offset=64)
    band += [oa, ova, oo]
    torch.cuda.synchronize()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    print(f"library surface launches {got} (with ALiBi, sinks and the offset)",
          flush=True)
    outs = (o1, o1c, o1h, o1d, o2, o3, o4, o5, o6, o7) + grads + tuple(band)
    ok = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    ok &= o1.shape == q.shape and o2.shape == qd.shape and o3.shape == qd.shape
    ok &= o4.shape == qv.shape and o5.shape == qp.shape
    ok &= all(g.shape == t.shape for g, t in zip(
        grads, leaves + [qt, kt, vt] + leaves_a + [qt, kt, vt]))
    ok &= all(got.get(n, 0) >= 1 for n in (
        "prefill", "flagged", "repair", "bound", "decode", "paged",
        "varlen", "paged_prefill", "bwd_fused", "bwd_dkv", "bwd_dq",
        "varlen_bwd_dkv", "varlen_bwd_dq"))
    return ok


def engine_phase(counts, ident, state):
    """Main path, part 2: the serving engine at Llama-3-8B width. Leaves
    the weights in `state` for part 3."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve import graphs
    from mfa_tpu_torch.serve.engine import Engine

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    state.update(params=params, cfg=cfg)
    torch.cuda.synchronize()
    print(f"engine: Llama-3-8B width, {cfg.n_layers} layers, vocab "
          f"{cfg.vocab_size}, bf16 weights from seed {SEED} "
          f"({time.perf_counter() - t0:.1f} s to build)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    n_req, gen_tokens, page = 16, 32, 64
    eng = Engine(params, cfg, num_pages=128, page_size=page, max_seqs=16,
                 pages_per_seq=8, quant_dtype="int8", device="cuda")
    free0 = eng.sched.allocator.free_pages
    rng = np.random.RandomState(SEED)
    reqs = [eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))), gen_tokens)
            for n in rng.randint(200, 257, n_req)]
    _build.reset_launches()
    stats = eng.run()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state["step_tokens"] = [list(r.generated) for r in reqs]
    ok = all(len(r.generated) == gen_tokens for r in reqs)
    ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
    ok &= eng.sched.allocator.free_pages == free0
    ok &= _wave_launches(got, cfg.n_layers * stats.prefill_batches)
    ok &= got.get("paged", 0) == cfg.n_layers * stats.steps
    ok &= stats.captures >= 1 and stats.readbacks == stats.steps
    step_tokens = stats.decode_tokens - n_req  # first tokens come from prefill
    state["decode_tps"] = step_tokens / stats.decode_s
    print(f"engine launches {got}: flagged = repair = {cfg.n_layers} layers x "
          f"{stats.prefill_batches} waves, paged = {cfg.n_layers} layers x "
          f"{stats.steps} decode steps", flush=True)
    print(f"engine: {n_req} requests finished with {gen_tokens} tokens: "
          f"{all(len(r.generated) == gen_tokens for r in reqs)}; free pages "
          f"{eng.sched.allocator.free_pages} of {free0} returned", flush=True)
    print(f"engine: prefill {stats.prefill_tokens / stats.prefill_s:.1f} tok/s "
          f"({stats.prefill_tokens} tokens in {stats.prefill_s:.3f} s), decode "
          f"{_decode_rates(stats, step_tokens)}, peak memory {peak_gb:.2f} GB "
          f"[{ident}]", flush=True)
    del eng
    # the same traffic with every decode step issued eagerly (graphs off:
    # a measurement switch, not an engine option)
    graphs._ENABLED = False
    try:
        eager = Engine(params, cfg, num_pages=128, page_size=page, max_seqs=16,
                       pages_per_seq=8, quant_dtype="int8", device="cuda")
        rng = np.random.RandomState(SEED)
        ereqs = [eager.submit(list(rng.randint(0, cfg.vocab_size, int(n))),
                              gen_tokens) for n in rng.randint(200, 257, n_req)]
        est = eager.run()
    finally:
        graphs._ENABLED = True
    same = [r.generated for r in ereqs] == state["step_tokens"]
    ok &= same and est.captures == 0
    print(f"engine, decode steps eager (graphs off): decode "
          f"{step_tokens / est.decode_s:.1f} tok/s ({est.steps} steps, "
          f"{est.decode_s:.3f} s); tokens identical to the graphed run: {same} "
          f"[{ident}]", flush=True)
    del eager
    torch.cuda.empty_cache()
    return ok


def _kv_bytes_per_token(cache) -> float:
    """Bytes of the KV pool (pages and scales, every layer) per token it
    holds."""
    total = sum(t.numel() * t.element_size() for t in (
        cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales) if t is not None)
    return total / (cache.num_pages * cache.page_size)


def kvq_engine_phase(counts, ident, state):
    """Main path, part 2b: part 2's weights (in `state`) and traffic (16
    requests of 200-256 prompt tokens, 32 new tokens, pages of 64) on int8
    KV once more (warm: part 2's run paid the first captures and
    allocations), then on fp8 (e4m3) and int4 KV pages: every prompt wave
    writes quantized pages (kernels 2 + 3 for the attention), every decode
    step runs kernel 6 on those pages from the decode graphs. Every request
    finishes with finite logprobs, every page returns, the paged launches
    (paged, paged_fp8, paged_int4) = layers x steps, graphs are captured.
    Prints the rates, the KV pool's bytes per token and the peak memory
    beside this int8 run's, and the share of tokens equal to part 2's (not
    a check for fp8 and int4: another quantization may pick other greedy
    tokens on random weights)."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build, paged
    from mfa_tpu_torch.serve.engine import Engine

    params, cfg = state["params"], state["cfg"]
    n_req, gen_tokens, L = 16, 32, cfg.n_layers
    ok, base = True, {}
    for quant in ("int8",) + KV_FORMATS:
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                     pages_per_seq=8, quant_dtype=quant, device="cuda")
        free0 = eng.sched.allocator.free_pages
        rng = np.random.RandomState(SEED)
        reqs = [eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))), gen_tokens)
                for n in rng.randint(200, 257, n_req)]
        _build.reset_launches()
        stats = eng.run()
        got = dict(_build.launches)
        counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        name = paged.launch_name("paged", quant)
        good = all(len(r.generated) == gen_tokens for r in reqs)
        good &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
        good &= eng.sched.allocator.free_pages == free0
        good &= _wave_launches(got, L * stats.prefill_batches)
        good &= got.get(name, 0) == L * stats.steps
        good &= sum(n for k_, n in got.items() if k_.startswith("paged")) == L * stats.steps
        good &= stats.captures >= 1 and stats.readbacks == stats.steps
        ok &= good
        step_tokens = stats.decode_tokens - n_req
        same = sum(a == b for r, ref in zip(reqs, state["step_tokens"])
                   for a, b in zip(r.generated, ref))
        kvb = _kv_bytes_per_token(eng.cache)
        if quant == "int8":  # the same kernels as part 2: the same tokens
            good &= same == n_req * gen_tokens
            ok &= good
            base = dict(prefill_tps=stats.prefill_tokens / stats.prefill_s,
                        decode_tps=step_tokens / stats.decode_s, peak_gb=peak_gb,
                        kv_bytes_per_token=kvb)
        print(f"{quant} KV engine launches {got}: {name} = {L} layers x {stats.steps} "
              f"decode steps, flagged = repair = {L} x {stats.prefill_batches} waves; "
              f"{n_req} requests finished with {gen_tokens} tokens: "
              f"{all(len(r.generated) == gen_tokens for r in reqs)}; free pages "
              f"{eng.sched.allocator.free_pages} of {free0} returned; "
              f"{'ok' if good else 'FAIL'}", flush=True)
        print(f"{quant} KV engine: prefill {stats.prefill_tokens / stats.prefill_s:.1f} "
              f"tok/s (int8 KV {base['prefill_tps']:.1f}), decode "
              f"{_decode_rates(stats, step_tokens)} (int8 KV "
              f"{base['decode_tps']:.1f} tok/s), KV pool {kvb:.0f} bytes/token (int8 "
              f"{base['kv_bytes_per_token']:.0f}), peak memory {peak_gb:.2f} GB (int8 "
              f"{base['peak_gb']:.2f}); tokens equal to part 2's {same} of "
              f"{n_req * gen_tokens} [{ident}]", flush=True)
        del eng
    torch.cuda.empty_cache()
    return ok


def _decode_rates(stats, step_tokens) -> str:
    """Decode tok/s over the decode seconds with and without the graphs'
    capture seconds, and the readbacks."""
    return (f"{step_tokens / stats.decode_s:.1f} tok/s ({step_tokens} tokens in "
            f"{stats.steps} steps, {stats.decode_s:.3f} s; "
            f"{step_tokens / (stats.decode_s - stats.capture_s):.1f} tok/s "
            f"without the {stats.captures} graph captures' capture_s "
            f"{stats.capture_s:.3f} s; {stats.readbacks} readbacks)")


def burst_engine_phase(counts, ident, state):
    """Main path, part 3b: part 2's engine and traffic (the weights in
    `state`) with run(burst=8, pipeline=False), then run(burst=8): decode
    in bursts of up to 8 graph replays with one token readback each, the
    second with up to two bursts in flight. Both must give part 2's tokens,
    return every page and leave nothing in flight."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.serve.engine import Engine

    params, cfg = state["params"], state["cfg"]
    n_req, gen_tokens, L = 16, 32, cfg.n_layers
    ok = True
    for pipeline in (False, True):
        eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                     pages_per_seq=8, quant_dtype="int8", device="cuda")
        free0 = eng.sched.allocator.free_pages
        rng = np.random.RandomState(SEED)
        reqs = [eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))),
                           gen_tokens) for n in rng.randint(200, 257, n_req)]
        _build.reset_launches()
        t0 = time.perf_counter()
        stats = eng.run(burst=8, pipeline=pipeline)
        wall = time.perf_counter() - t0
        got = dict(_build.launches)
        counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
        same = [r.generated for r in reqs] == state["step_tokens"]
        ok &= same
        ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
        ok &= eng.sched.allocator.free_pages == free0
        ok &= all(r.inflight == 0 for r in reqs) and not eng._pending_bursts
        ok &= _wave_launches(got, L * stats.prefill_batches)
        ok &= got.get("paged", 0) == L * stats.steps
        ok &= stats.readbacks < stats.steps
        step_tokens = stats.decode_tokens - n_req
        state[f"burst_tps_{pipeline}"] = step_tokens / stats.decode_s
        print(f"burst engine (burst 8, pipeline={pipeline}) launches {got}: "
              f"paged = {L} layers x {stats.steps} decode steps", flush=True)
        print(f"burst engine (burst 8, pipeline={pipeline}): tokens identical to "
              f"the stepwise engine: {same}; free pages "
              f"{eng.sched.allocator.free_pages} of {free0} returned; decode "
              f"{_decode_rates(stats, step_tokens)}; {wall:.3f} s wall "
              f"[{ident}]", flush=True)
        del eng
    torch.cuda.empty_cache()
    return ok


def pressure_engine_phase(counts, ident):
    """Eviction and preemption on the card: Llama-3-8B's width (hq 32, hkv 8,
    d 128, vocab 128256) cut to 4 layers, random bf16 weights from a seed,
    int8 KV pages of 64, the prefix cache on, a pool of 40 pages. A
    1100-token prompt runs first and leaves 17 idle prefix pages; then 6
    prompts of 300-600 tokens with 160 new tokens each need more pages than
    are free, so admission evicts idle prefix pages and decode preempts the
    youngest requests, which re-prefill later. Stepwise, then with
    run(burst=8) (the pipelined loop drains and falls back to step_burst,
    which preempts). Held as the CPU tests hold it
    (tests/test_torch_chunked_prefill.py, test_torch_engine.py,
    test_torch_engine_burst.py): every request finishes with its length, at
    least one preemption and one eviction, free pages plus prefix pages =
    the pool. Printed, not held: for each request, the first generated
    token that differs from an engine with a pool of 512 pages, which
    neither evicts nor preempts (the batch shapes differ between the two,
    and so does bf16 rounding)."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=4)
    params = llama.init_params(cfg, seed=SEED + 62, device="cuda")
    rng = np.random.RandomState(SEED + 62)
    first = list(rng.randint(0, cfg.vocab_size, 1100))
    wave = [list(rng.randint(0, cfg.vocab_size, int(n)))
            for n in rng.randint(300, 601, 6)]
    gen_first, gen_wave = 8, 160

    def serve(num_pages, run_kw):
        eng = Engine(params, cfg, num_pages=num_pages, page_size=64, max_seqs=8,
                     pages_per_seq=20, quant_dtype="int8", prefix_cache=True,
                     device="cuda")
        evicted = []
        evict = eng.sched.prefix.evict

        def counted(n, allocator):
            evicted.append(evict(n, allocator))
            return evicted[-1]

        eng.sched.prefix.evict = counted
        _build.reset_launches()
        reqs = [eng.submit(first, gen_first)]
        eng.run(**run_kw)
        idle = len(eng.sched.prefix.idle)
        reqs += [eng.submit(p, gen_wave) for p in wave]
        stats = eng.run(**run_kw)
        got = dict(_build.launches)
        counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
        pool = eng.sched.allocator.free_pages + len(eng.sched.prefix.pages)
        out = dict(tokens=[list(r.generated) for r in reqs], stats=stats,
                   evicted=sum(evicted), idle=idle, pool=pool, launches=got,
                   finished=all(len(r.generated) == r.max_new_tokens for r in reqs),
                   finite=all(all(math.isfinite(x) for x in r.logprobs) for r in reqs),
                   drained=not eng.sched.active and not eng._pending_bursts)
        del eng
        torch.cuda.empty_cache()
        return out

    ok = True
    free = serve(512, {})
    ok &= free["stats"].preemptions == 0 and free["evicted"] == 0 and free["finished"]
    for tag, run_kw in (("stepwise", {}), ("run(burst=8)", dict(burst=8))):
        got = serve(40, run_kw)
        st = got["stats"]
        good = got["finished"] and got["finite"] and got["drained"] \
            and st.preemptions > 0 and got["evicted"] > 0 and got["pool"] == 39 \
            and got["launches"].get("paged", 0) > 0
        ok &= good
        parts = _first_divergence(got["tokens"], free["tokens"])
        print(f"engine 8B width, 4 layers, pool of 40 int8 pages of 64, {tag}: "
              f"{len(got['tokens'])} requests finished with their lengths "
              f"{got['finished']}, {st.preemptions} preemptions, {got['evicted']} "
              f"idle prefix pages evicted (of {got['idle']} idle after the first "
              f"prompt), free + prefix pages {got['pool']} (pool 39), "
              f"{st.steps} decode steps; launches {got['launches']} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        print(f"  first token that parts from the unpressured engine's (pool "
              f"512: {free['stats'].preemptions} preemptions), per request: "
              f"{parts} of {[len(t) for t in free['tokens']]} [{ident}]", flush=True)
    del params
    torch.cuda.empty_cache()
    return ok


SAMPLING_MIX = (None, dict(temperature=0.8, top_p=0.9),
                dict(temperature=1.0, min_p=0.05), dict(repetition_penalty=1.3))


def _traffic(cfg, n_req=16):
    """Part 2's prompts: 16 of 200-256 tokens from the seed."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    return [list(rng.randint(0, cfg.vocab_size, int(n)))
            for n in rng.randint(200, 257, n_req)]


def sampling_engine_phase(counts, ident, state):
    """Main path, part 3c: part 2's weights and traffic (16 requests of
    200-256 prompt tokens, 32 new tokens, int8 KV, pages of 64) with
    sampling: the engine's top-k 50 and a per-request mix, rows 0-3 greedy,
    4-7 temperature 0.8 / top-p 0.9, 8-11 temperature 1.0 / min-p 0.05,
    12-15 greedy with repetition penalty 1.3 (presence rows on the device).
    Graphed, with run() (seed SEED), run(burst=8) (seed SEED), run() again
    (seed SEED) and run(burst=8) with seed SEED + 1. Every request finishes
    with finite logprobs and its pages back, graphs are captured, the plain
    greedy rows equal part 2's tokens in every run (rows of one bucket do
    not mix in any product), the second run() equals the first in every
    row, and the other seed changes at least one sampled row."""
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.serve.engine import Engine
    from mfa_tpu_torch.serve.sampling import SamplingParams

    params, cfg = state["params"], state["cfg"]
    n_req, gen_tokens, L = 16, 32, cfg.n_layers
    prompts = _traffic(cfg, n_req)

    def run(seed, burst):
        eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                     pages_per_seq=8, quant_dtype="int8", device="cuda",
                     sampling=SamplingParams(top_k=50), seed=seed)
        free0 = eng.sched.allocator.free_pages
        reqs = [eng.submit(p, gen_tokens, sampling=(
            SamplingParams(**SAMPLING_MIX[i // 4]) if SAMPLING_MIX[i // 4] else None))
            for i, p in enumerate(prompts)]
        _build.reset_launches()
        stats = eng.run(burst=burst)
        got = dict(_build.launches)
        counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
        good = all(len(r.generated) == gen_tokens for r in reqs)
        good &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
        good &= eng.sched.allocator.free_pages == free0
        good &= _wave_launches(got, L * stats.prefill_batches)
        good &= got.get("paged", 0) == L * stats.steps
        good &= stats.captures >= 1
        greedy_same = [r.generated for r in reqs[:4]] == state["step_tokens"][:4]
        good &= greedy_same
        step_tokens = stats.decode_tokens - n_req
        rate = step_tokens / stats.decode_s
        print(f"sampling engine (seed {seed}, burst {burst}) launches {got}: paged = "
              f"{L} layers x {stats.steps} decode steps; {n_req} requests finished "
              f"with {gen_tokens} tokens, finite logprobs, free pages "
              f"{eng.sched.allocator.free_pages} of {free0}; greedy rows equal to "
              f"part 2's: {greedy_same}; {stats.captures} graphs captured; "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ref = state["decode_tps"] if burst == 1 else state.get("burst_tps_True", 0.0)
        print(f"sampling engine (seed {seed}, burst {burst}): decode "
              f"{_decode_rates(stats, step_tokens)}; greedy engine of part "
              f"{'2' if burst == 1 else '3b (burst 8, pipelined)'} {ref:.1f} tok/s "
              f"({rate / ref:.3f}x) [{ident}]", flush=True)
        del eng
        return [r.generated for r in reqs], good

    a, ok = run(SEED, 1)
    b, good = run(SEED, 8)
    ok &= good
    a2, good = run(SEED, 1)
    ok &= good and a2 == a
    c, good = run(SEED + 1, 8)
    ok &= good
    sampled = list(range(4, 12))
    differs = any(b[i] != c[i] for i in sampled)
    ok &= differs
    print(f"sampling engine: the same seed again token-identical in every row: "
          f"{a2 == a}; run() and run(burst=8) with one seed identical (one draw a "
          f"step either way): {a == b}; seed {SEED + 1} changes a sampled row: "
          f"{differs}", flush=True)
    torch.cuda.empty_cache()
    return ok


def _post_json(base, body, timeout=600):
    """POST a completion -> (HTTP status, JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + "/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_sse(base, body, timeout=600):
    """POST a streamed completion -> dict(tokens, lps, events, errors,
    ttft_s: client seconds from the send to the first event, done: the
    stream ended with data: [DONE])."""
    import urllib.request

    req = urllib.request.Request(base + "/v1/completions",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    out = dict(tokens=[], lps=[], events=0, errors=[], ttft_s=None, done=False)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if out["ttft_s"] is None:
                out["ttft_s"] = time.perf_counter() - t0
            payload = line[len("data: "):]
            if payload == "[DONE]":
                out["done"] = True
                break
            evt = json.loads(payload)
            if "error" in evt:
                out["errors"].append(evt["error"]["message"])
                continue
            out["tokens"] += evt["choices"][0]["token_ids"]
            out["lps"] += evt["choices"][0]["logprobs"]["token_logprobs"]
            out["events"] += 1
    return out


def _run_clients(fns):
    """Run the callables on threads released together -> their results in
    order, and the wall seconds from the release to the last one's end."""
    import threading

    results = [None] * len(fns)
    gate = threading.Barrier(len(fns) + 1)

    def run(i):
        gate.wait()
        try:
            results[i] = fns[i]()
        except Exception as e:  # reported as this client's result
            results[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client thread did not finish within 600 s")
    return results, wall


def _ends_at(gen, seq):
    """The prefix of gen up to the first occurrence of seq."""
    for i in range(len(seq), len(gen) + 1):
        if gen[i - len(seq):i] == seq:
            return gen[:i]
    return gen


def server_phase(counts, ident, state):
    """Main path, part 3e: the HTTP front end (serve/server.py, make_server
    with its defaults burst=8, pipeline=True) over part 2's engine: the 8B
    weights in `state`, int8 KV pages of 64, max_seqs 16. serve_forever
    runs on a thread, the engine on the server's loop thread, clients on
    threads of their own (urllib; no client touches the card, so no CUDA
    call from another thread meets a graph capture). (a) One request alone
    (part 2's first prompt, 32 new tokens), plain and then streamed: both
    equal a direct engine's greedy tokens for that prompt alone. (b) Part
    2's 16 prompts from 16 clients at once, 8 streamed, 4 of the plain ones
    with logprobs: each 32 tokens, finish_reason "length", one logprob <= 0
    a token; how many equal part 2's tokens is printed (concurrent arrival
    changes waves and batch buckets, so bf16 near-ties may differ). The 16
    are sent twice: cold (the burst captures the batch buckets' graphs on
    its way) and warm (the graphs are there). (c) A
    stop sequence ends its request with "stop"; malformed bodies get 400.
    (d) step_pipelined raises once mid-decode with 4 requests in flight:
    the plain clients get the 500 body, the streamed ones the SSE error
    event, the engine recovers once (Engine.recover, its first run on the
    card), abandons them and returns every page; then the lone request
    again equals the direct engine's tokens. TTFT p50 / p95 on the client
    clock and end-to-end tok/s of the 16, cold and warm, part 2's decode
    rates beside them. The engine runs on the native allocator; last, the
    scheduler's host bookkeeping at these shapes on it and on the Python
    PageAllocator (_scheduler_host_us), beside part 2's decode step."""
    import threading

    import numpy as np
    import torch

    from mfa_tpu_torch.cache.paged_cache import PageAllocator
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.serve.engine import Engine
    from mfa_tpu_torch.serve.server import make_server
    from mfa_tpu_torch.utils import native

    params, cfg = state["params"], state["cfg"]
    n_req, gen_tokens, L = 16, 32, cfg.n_layers
    kw = dict(num_pages=128, page_size=64, max_seqs=16, pages_per_seq=8,
              quant_dtype="int8", device="cuda")
    traffic = [[int(t) for t in p] for p in _traffic(cfg)]
    lone = traffic[0]
    # the direct engine's tokens for the lone prompt, before the server runs
    direct = Engine(params, cfg, **kw)
    r0 = direct.submit(lone, gen_tokens)
    direct.run(burst=8)
    want = list(r0.generated)
    del direct, r0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    eng = Engine(params, cfg, **kw)
    free0 = eng.sched.allocator.free_pages
    httpd = make_server(eng, port=0)
    loop = httpd.loop
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    ok = type(eng.sched.allocator) is native.NativeAllocator
    _build.reset_launches()
    try:
        # (a) one request alone, plain then streamed
        code, body = _post_json(base, {"prompt": lone, "max_tokens": gen_tokens})
        lone_plain = body["choices"][0]["token_ids"] if code == 200 else None
        sse = _post_sse(base, {"prompt": lone, "max_tokens": gen_tokens})
        lone_ok = lone_plain == want and sse["tokens"] == want and sse["done"]
        ok &= lone_ok
        print(f"server: lone request plain {'equals' if lone_plain == want else 'DIFFERS from'}"
              f" the direct engine's {gen_tokens} tokens, streamed "
              f"{'equals' if sse['tokens'] == want else 'DIFFERS'} ({sse['events']} "
              f"events, TTFT {sse['ttft_s'] * 1e3:.1f} ms)", flush=True)

        # (b) 16 clients at once, twice: the first burst captures the batch
        # buckets' graphs on its way (cold), the second finds them (warm)
        def client(i):
            body = {"prompt": traffic[i], "max_tokens": gen_tokens}
            if i % 2 == 0:
                return _post_sse(base, body)
            if i < 8:
                body["logprobs"] = 1
            return _post_json(base, body)

        bursts = {}
        for label in ("cold", "warm"):
            s0 = dataclasses.replace(eng.stats)
            results, wall = _run_clients([lambda i=i: client(i)
                                          for i in range(n_req)])
            s1 = eng.stats
            agree, ttfts, good = 0, [], True
            for i, res in enumerate(results):
                if isinstance(res, Exception):
                    print(f"server: client {i} raised {res!r}", flush=True)
                    good = False
                    continue
                if i % 2 == 0:
                    toks, lps = res["tokens"], res["lps"]
                    good &= res["done"] and not res["errors"] and res["events"] >= 1
                    ttfts.append(res["ttft_s"])
                else:
                    code, body = res
                    if code != 200:
                        print(f"server: client {i} got {code}: {body}", flush=True)
                        good = False
                        continue
                    ch = body["choices"][0]
                    toks = ch["token_ids"]
                    good &= ch["finish_reason"] == "length"
                    good &= body["usage"]["completion_tokens"] == gen_tokens
                    lps = ch["logprobs"]["token_logprobs"] if i < 8 else None
                    good &= (i < 8) == ("logprobs" in ch)
                good &= len(toks) == gen_tokens
                if lps is not None:
                    good &= len(lps) == len(toks) and all(
                        math.isfinite(x) and x <= 0.0 for x in lps)
                agree += toks == state["step_tokens"][i]
            ok &= good and len(ttfts) == n_req // 2
            if len(ttfts) == n_req // 2:
                bursts[label] = (
                    *(float(np.percentile(ttfts, q)) * 1e3 for q in (50, 95)),
                    n_req * gen_tokens / wall,
                    n_req * gen_tokens / (wall - (s1.capture_s - s0.capture_s)))
            print(f"server: {label} burst of {n_req} concurrent clients (8 "
                  f"streamed, 4 with logprobs): all well-formed with {gen_tokens} "
                  f"tokens: {good}; {agree} of {n_req} equal the engine phase's "
                  f"tokens; TTFTs (ms) {sorted(round(t * 1e3, 1) for t in ttfts)}; "
                  f"{n_req * gen_tokens} tokens in {wall:.3f} s; the engine "
                  f"meanwhile: {s1.prefill_batches - s0.prefill_batches} waves in "
                  f"{s1.prefill_s - s0.prefill_s:.3f} s, {s1.steps - s0.steps} decode "
                  f"steps in {s1.readbacks - s0.readbacks} readbacks, "
                  f"{s1.decode_s - s0.decode_s:.3f} s, {s1.captures - s0.captures} "
                  f"graph captures ({s1.capture_s - s0.capture_s:.3f} s)", flush=True)

        # (c) a stop sequence and malformed bodies
        stop = want[4:6]
        code, body = _post_json(base, {"prompt": lone, "max_tokens": gen_tokens,
                                       "stop": stop})
        stop_ok = code == 200 and body["choices"][0]["finish_reason"] == "stop" \
            and body["choices"][0]["token_ids"] == _ends_at(want, stop)
        bad = [_post_json(base, b)[0] for b in (
            {"prompt": [], "max_tokens": 4},
            {"prompt": lone, "max_tokens": 4, "temperature": "hot"})]
        ok &= stop_ok and bad == [400, 400]
        print(f"server: stop sequence ends with 'stop' at the direct tokens' "
              f"match: {stop_ok}; malformed bodies answered {bad}", flush=True)

        # (d) one injected engine failure mid-decode, 4 requests in flight
        orig, seen = eng.step_pipelined, []

        def flaky(n):
            if len(seen) < 3:
                if len(loop._streams) < 4:
                    time.sleep(0.02)  # the four clients arrive
                else:
                    seen.append(n)  # two real steps with all four in flight
                if len(seen) == 3:
                    raise RuntimeError("injected engine failure")
            return orig(n)

        eng.step_pipelined = flaky
        try:
            failing = [traffic[i] for i in range(1, 5)]
            res, _ = _run_clients(
                [lambda p=p: _post_sse(base, {"prompt": p, "max_tokens": 64})
                 for p in failing[:2]] +
                [lambda p=p: _post_json(base, {"prompt": p, "max_tokens": 64})
                 for p in failing[2:]])
        finally:
            eng.step_pipelined = orig
        msg = "engine failure: injected engine failure"
        fail_ok = all(not isinstance(x, Exception) for x in res)
        fail_ok = fail_ok and all(x["errors"] == [msg] and x["done"] for x in res[:2])
        fail_ok = fail_ok and all(x[0] == 500 and x[1]["error"]["message"] == msg
                                  for x in res[2:])
        rec_ok = eng.stats.recoveries == 1 and not eng._all_reqs \
            and not eng._stream_pos and not eng.sched.active \
            and eng.sched.allocator.free_pages == free0
        code, body = _post_json(base, {"prompt": lone, "max_tokens": gen_tokens})
        after = code == 200 and body["choices"][0]["token_ids"] == want
        ok &= fail_ok and rec_ok and after
        print(f"server: injected failure reported to its 4 clients (2 SSE error "
              f"events, 2 x 500): {fail_ok}; recoveries {eng.stats.recoveries}, "
              f"bookkeeping empty and {eng.sched.allocator.free_pages} of {free0} "
              f"pages free: {rec_ok}; the lone request afterwards equals the "
              f"direct engine's tokens: {after}", flush=True)
    finally:
        httpd.shutdown()
        loop.close()
        httpd.server_close()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    stats = eng.stats
    ok &= not loop._thread.is_alive()
    ok &= _wave_launches(got, L * stats.prefill_batches)
    ok &= got.get("paged", 0) >= L * stats.steps > 0
    print(f"server launches {got}: flagged = repair = {L} layers x "
          f"{stats.prefill_batches} waves, paged >= {L} x {stats.steps} decode "
          f"steps (bursts dropped by the recovery count launches, not steps)",
          flush=True)
    for label, (p50, p95, tps, tps_nocap) in bursts.items():
        print(f"server ({label}): TTFT p50 {p50:.1f} ms p95 {p95:.1f} ms (client "
              f"clock, send to first SSE event, 8 streamed of the 16); {n_req} x "
              f"{gen_tokens} tokens through HTTP: {tps:.1f} tok/s end to end, "
              f"{tps_nocap:.1f} tok/s without the burst's graph captures; the "
              f"engine phase's decode {state.get('decode_tps', math.nan):.1f} tok/s "
              f"stepwise, {state.get('burst_tps_True', math.nan):.1f} tok/s in "
              f"pipelined bursts of 8 [{ident}]", flush=True)
    del eng, httpd, loop
    torch.cuda.empty_cache()

    # the scheduler's host bookkeeping at this serve's shapes, on the native
    # allocator and on the Python one
    lens = [len(p) for p in traffic]
    host = {}
    for cls in (native.NativeAllocator, PageAllocator) * 2:
        host.setdefault(cls.__name__, []).append(
            _scheduler_host_us(cls, lens, gen_tokens))
    per = {k: [min(x[i] for x in v) for i in range(3)] for k, v in host.items()}
    step_us = n_req / state["decode_tps"] * 1e6
    print(f"server: the scheduler's host bookkeeping ({n_req} prompts of "
          f"{min(lens)}-{max(lens)} tokens, pages of 64, {gen_tokens} decode steps; "
          f"best of 2 runs of 20 rounds): "
          + "; ".join(f"{k} admit {a:.2f} us, a decode step's page mapping "
                      f"{d:.2f} us, finish {f:.2f} us" for k, (a, d, f) in per.items())
          + f"; the engine phase's decode step {step_us:.1f} us, the native "
          f"mapping {per['NativeAllocator'][1] / step_us * 100:.4f}% of it "
          f"[{ident}]", flush=True)
    return ok


def llama32_1b_draft_config(cfg):
    """Llama-3.2-1B's widths from its public config.json
    (meta-llama/Llama-3.2-1B): dim 2048, 16 layers, 32 q / 8 kv heads of 64,
    ffn 8192, vocab 128256, rope theta 500000 with llama3 scaling (factor 32,
    low / high frequency factors 1 / 4, original context 8192). Built here;
    no preset is added to the package."""
    return dataclasses.replace(cfg, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                               ffn_dim=8192, rope_theta=500000.0,
                               rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192))


def speculative_engine_phase(counts, ident, state):
    """Main path, part 3d: speculative decoding with part 2's target (the
    8B weights in `state`) and traffic, int8 KV, spec_tokens 4. The draft
    has Llama-3.2-1B's widths (llama32_1b_draft_config) and random bf16
    weights from the seed; its lm_head is its own (the port ties no
    embedding, and neither does mfa_tpu). Greedy run: every request
    finishes with 32 tokens, the pages come back and both caches' tables
    and lengths are clear, spec_proposed > 0, paged_span launches = 32
    target layers x verify iterations (and the draft's paged launches 16 x
    4 x iterations), the speculative graphs are captured; prints the
    acceptance and the share of tokens equal to part 2's (no gate: bf16
    verify and bf16 decode may pick other tokens at near-ties). Then the
    8B model as its own draft (its acceptance printed), a sampled run
    (temperature 0.8, top-p 0.9, host-stepped: finishes, finite
    logprobs), and verify_vs_decode: at 2 layers of 8B width, on int8 and
    bf16 KV, verify_step over 4 tokens against 4 decode_steps from the
    same cache state (logits max 0.25 / mean 0.02)."""
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine
    from mfa_tpu_torch.serve.sampling import SamplingParams

    params, cfg = state["params"], state["cfg"]
    n_req, gen_tokens, L, k = 16, 32, cfg.n_layers, 4
    dcfg = llama32_1b_draft_config(cfg)
    t0 = time.perf_counter()
    dparams = llama.init_params(dcfg, seed=SEED + 5, device="cuda")
    torch.cuda.synchronize()
    print(f"speculative engine: draft of Llama-3.2-1B's widths (dim {dcfg.dim}, "
          f"{dcfg.n_layers} layers, {dcfg.n_heads}/{dcfg.n_kv_heads} heads of "
          f"{dcfg.head_dim}, ffn {dcfg.ffn_dim}, vocab {dcfg.vocab_size}, llama3 rope "
          f"scaling), random bf16 weights from seed {SEED + 5}, its own lm_head "
          f"(untied) ({time.perf_counter() - t0:.1f} s to build)", flush=True)
    prompts = _traffic(cfg, n_req)
    ok = True

    def run(draft, draft_cfg, tag, sampling=None, check=True):
        eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                     pages_per_seq=8, quant_dtype="int8", device="cuda",
                     draft_params=draft, draft_cfg=draft_cfg, spec_tokens=k,
                     sampling=sampling, seed=SEED)
        free0 = eng.sched.allocator.free_pages
        reqs = [eng.submit(p, gen_tokens) for p in prompts]
        _build.reset_launches()
        t1 = time.perf_counter()
        stats = eng.run()
        wall = time.perf_counter() - t1
        eng._flush_released()
        got = dict(_build.launches)
        counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
        good = all(len(r.generated) == gen_tokens for r in reqs)
        good &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
        good &= eng.sched.allocator.free_pages == free0
        for c in (eng.cache, eng.draft_cache):
            good &= not bool(c.lengths.any()) and not bool(c.block_tables.any())
        good &= stats.spec_proposed > 0
        if check:  # greedy: every step a graphed run of iterations
            good &= got.get("paged_span", 0) == L * stats.steps
            good &= got.get("paged", 0) == draft_cfg.n_layers * k * stats.steps
            good &= stats.captures >= 1
        same = sum(a == b for r, ref in zip(reqs, state["step_tokens"])
                   for a, b in zip(r.generated, ref))
        step_tokens = stats.decode_tokens - n_req
        print(f"speculative engine, {tag}: launches {got}; {stats.steps} verify "
              f"iterations (paged_span = {L} x iterations), {stats.readbacks} "
              f"readbacks, {stats.captures} graphs captured; {n_req} requests "
              f"finished with {gen_tokens} tokens, finite logprobs, free pages "
              f"{eng.sched.allocator.free_pages} of {free0}, both caches clear; "
              f"{'ok' if good else 'FAIL'}", flush=True)
        print(f"speculative engine, {tag}: acceptance {stats.spec_acceptance:.4f} "
              f"({stats.spec_accepted} of {stats.spec_proposed} proposed), "
              f"{step_tokens / max(stats.steps, 1):.2f} tokens a row-iteration "
              f"set ({step_tokens} decode tokens), decode "
              f"{step_tokens / stats.decode_s:.1f} tok/s ({stats.decode_s:.3f} s, "
              f"capture_s {stats.capture_s:.3f}; run {wall:.3f} s); tokens equal "
              f"to part 2's {same} of {n_req * gen_tokens} (not a check) "
              f"[{ident}]", flush=True)
        del eng
        return good

    ok &= run(dparams, dcfg, "greedy, Llama-3.2-1B-shaped draft")
    ok &= run(params, cfg, "greedy, self-draft (the 8B as its own draft)")
    ok &= run(dparams, dcfg, "sampled (temperature 0.8, top-p 0.9), host-stepped",
              SamplingParams(temperature=0.8, top_p=0.9), check=False)
    del dparams
    torch.cuda.empty_cache()
    ok &= _verify_vs_decode(params, cfg)
    return ok


def _verify_vs_decode(params, cfg):
    """verify_step over 4 tokens against 4 decode_steps from the same cache
    state, the target cut to 2 layers, int8 and bf16 KV."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = dict(params, layers=params["layers"][:2])
    rng = np.random.RandomState(SEED + 7)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (200, 91, 256)]
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, (3, 4)), device="cuda")
    pages = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12, 13]]
    ok = True
    for quant in ("int8", None):
        caches = []
        for _ in range(2):
            c = llama.build_kv_caches(cfg2, 16, 64, 3, 5, quant, device="cuda")
            c, _ = llama.prefill_batch(p2, cfg2, c, [0, 1, 2], pages, prompts)
            caches.append(c)
        _, v_logits = llama.verify_step(p2, cfg2, caches[0], [0, 1, 2], toks)
        seq = [llama.decode_step(p2, cfg2, caches[1], [0, 1, 2], toks[:, i])[1]
               for i in range(4)]
        d = (v_logits - torch.stack(seq, 1)).abs()
        good = bool(torch.isfinite(v_logits).all()) and float(d.max()) < 0.25 \
            and float(d.mean()) < 0.02
        good &= torch.equal(caches[0].lengths, caches[1].lengths)
        print(f"verify_vs_decode ({quant or 'bf16'} KV, 2 layers at 8B width, 3 rows "
              f"x 4 tokens): logits max_abs {float(d.max()):.3e} (< 0.25) mean_abs "
              f"{float(d.mean()):.3e} (< 0.02), argmax agree "
              f"{float((v_logits.argmax(-1) == torch.stack(seq, 1).argmax(-1)).float().mean()):.3f} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


def chunked_engine_phase(counts, ident, state, quant="int8", model="8B",
                         long_prompts=(2500, 4001), pages=(512, 64), page=64):
    """Main path, part 3: the same weights behind an engine with chunked
    prefill (chunks of 512) and the prefix cache, on `quant` KV pages
    (int8, and once more each on int4 and fp8). (a) 4 long prompts take
    the chunked path; (b) a request with a 1024-token system prompt runs
    until its prefill completes, then 8 more with the same system prompt
    hit its 16 cached pages and prefill only their suffix; (c) 4 short
    prompts take whole-prompt prefill (kernels 2 + 3; in fp32 weights their
    fp32 launches, and kernels 6 and 8 with fp32 q). The 8B's, and with
    model "Gemma3-4B" the same traffic on Gemma3-4B's text stack (kernel 8
    at head_dim 256 on its sliding and global layers), or on Qwen2-7B
    (group 7) and Gemma2-9B (softcap: its waves take kernel 1). The long
    prompts draw their lengths from range(*long_prompts); pages is (pool
    size, pages a sequence) in pages of `page` rows (64). A run at pages of
    64 keeps its tokens; a run at another page size, its pool and pages a
    sequence scaled so as to hold the same tokens, must give the same
    tokens (the same chunks, hits, split plan and tiles)."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build, paged
    from mfa_tpu_torch.serve.engine import Engine

    params, cfg = state.pop("params"), state.pop("cfg")
    torch.cuda.reset_peak_memory_stats()
    gen_tokens = 32
    k6 = paged.launch_name("paged", quant, 1, cfg.dtype)
    k8 = paged.launch_name("paged_prefill", quant, 1, cfg.dtype)
    sfx = "_fp32" if cfg.dtype == torch.float32 else ""
    eng = Engine(params, cfg, num_pages=pages[0], page_size=page, max_seqs=16,
                 pages_per_seq=pages[1], quant_dtype=quant, prefill_chunk=512,
                 prefix_cache=True, device="cuda")
    free0 = eng.sched.allocator.free_pages
    rng = np.random.RandomState(SEED)

    def toks(n):
        return [int(t) for t in rng.randint(0, cfg.vocab_size, int(n))]

    system = toks(1024)
    longs = [toks(n) for n in rng.randint(*long_prompts, 4)]
    first = system + toks(64)
    hits = [system + toks(n) for n in rng.randint(64, 193, 8)]
    shorts = [toks(n) for n in rng.randint(100, 257, 4)]
    _build.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, gen_tokens) for p in longs + [first] + shorts]
    steps_to_first = 0
    while not reqs[4].generated:
        eng.step()
        steps_to_first += 1
    reqs += [eng.submit(p, gen_tokens) for p in hits]
    stats = eng.run()
    wall = time.perf_counter() - t0
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    retained = len(eng.sched.prefix.pages)
    ok = len(reqs) == 17
    ok &= all(len(r.generated) == gen_tokens for r in reqs)
    ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
    ok &= stats.prefill_tokens <= prompt_tokens - 8 * 1024
    ok &= eng.sched.allocator.free_pages + retained == free0
    ok &= got.get(k8, 0) == cfg.n_layers * stats.chunk_batches
    ok &= _wave_launches(got, cfg.n_layers * stats.prefill_batches, bool(cfg.attn_softcap),
                         cfg.head_dim, sfx)
    ok &= got.get(k6, 0) == cfg.n_layers * stats.steps
    passes = stats.chunk_batches + stats.prefill_batches + stats.steps
    if cfg.n_experts:  # every MoE layer: three expert launches a pass
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        ok &= got.get("wmatmul_bank", 0) == 3 * n_moe * passes
    step_tokens = stats.decode_tokens - len(reqs)  # first tokens come from prefill
    tag = f"chunked engine {model} ({quant} KV)"
    tokens, seen = [list(r.generated) for r in reqs], state.setdefault("chunked_tokens", {})
    if page == 64:
        seen[(model, quant)] = tokens
    else:
        tag += f", pages of {page} rows"
        same = tokens == seen.get((model, quant))
        print(f"{tag}: tokens of the {len(reqs)} requests equal those at pages of 64: "
              f"{same}", flush=True)
        ok &= same
    wave = ("prefill" if cfg.attn_softcap else "bound" if cfg.head_dim % 128
            else "flagged = repair")
    print(f"{tag} launches {got}: {k8} = {cfg.n_layers} "
          f"layers x {stats.chunk_batches} chunk batches, {wave} = "
          f"{cfg.n_layers} x {stats.prefill_batches} waves, {k6} = "
          f"{cfg.n_layers} x {stats.steps} decode steps", flush=True)
    print(f"{tag}: {len(reqs)} requests finished with {gen_tokens} "
          f"tokens: {all(len(r.generated) == gen_tokens for r in reqs)}; "
          f"system prompt done after {steps_to_first} steps; prefilled "
          f"{stats.prefill_tokens} of {prompt_tokens} prompt tokens (<= "
          f"{prompt_tokens - 8 * 1024}); free pages {eng.sched.allocator.free_pages}"
          f" + {retained} held by the prefix cache of {free0}", flush=True)
    print(f"{tag}: prefill {stats.prefill_tokens / stats.prefill_s:.1f} "
          f"tok/s ({stats.prefill_tokens} tokens in {stats.prefill_s:.3f} s, "
          f"{stats.chunk_batches} chunk batches + {stats.prefill_batches} "
          f"whole waves), decode {_decode_rates(stats, step_tokens)}, "
          f"{wall:.3f} s wall, peak memory {peak_gb:.2f} GB [{ident}]",
          flush=True)
    del eng
    state.update(params=params, cfg=cfg)
    torch.cuda.empty_cache()
    return ok


def _family_params(cfg, seed, device="cuda"):
    """Random bf16 weights from a seed (llama.init_params), with Qwen2's
    q/k/v biases drawn too (init_params leaves them zero, as mfa_tpu's
    does), so that a dropped bias would show."""
    import torch

    from mfa_tpu_torch.models import llama

    params = llama.init_params(cfg, seed=seed, device=device)
    if cfg.qkv_bias:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        for lp in params["layers"]:
            for k in ("bq", "bk", "bv"):
                lp[k].normal_(0.0, 0.5, generator=gen)
    return params


FAMILY_CONFIGS = ("Qwen2-7B", "Gemma2-9B")


def _family_config(model):
    from mfa_tpu_torch.models import llama

    return {"Qwen2-7B": llama.LlamaConfig.qwen2_7b,
            "Gemma2-9B": llama.LlamaConfig.gemma2_9b}[model]()


def family_engine_phase(counts, ident, state, model):
    """Main path, the dense families: Qwen2-7B (28 layers, q/k/v bias, 7 q
    heads a kv head) or Gemma2-9B (42 layers, head_dim 256, softcaps 50 and
    30, a 4096 window on the even layers) at full width and depth, random
    bf16 weights from a seed, behind chunked_engine_phase's chunked +
    prefix engine and traffic on int8 KV. Earlier phases' weights are freed
    first (15.2 and 18.5 GB of weights)."""
    import torch

    state.clear()
    torch.cuda.empty_cache()
    cfg = _family_config(model)
    state.update(params=_family_params(cfg, SEED + 5), cfg=cfg)
    try:
        return chunked_engine_phase(counts, ident, state, "int8", model)
    finally:
        state.clear()
        torch.cuda.empty_cache()


def _hf_checkpoint(path, params, cfg, model_type="qwen2"):
    """Write params as a Hugging Face checkpoint directory: one safetensors
    shard a layer plus one for the embedding, final norm and lm_head (HF
    names, [out, in] projections, each tensor in its own dtype), the
    model.safetensors.index.json weight map and config.json. Returns the
    bytes of tensor payload written."""
    import json
    import os

    from mfa_tpu_torch.models.safetensors_io import write_safetensors

    n = cfg.n_layers + 1
    shards = [{"model.embed_tokens.weight": params["embed"],
               "model.norm.weight": params["final_norm"],
               "lm_head.weight": params["lm_head"].t()}]
    names = dict(wq="self_attn.q_proj.weight", wk="self_attn.k_proj.weight",
                 wv="self_attn.v_proj.weight", wo="self_attn.o_proj.weight",
                 w_gate="mlp.gate_proj.weight", w_up="mlp.up_proj.weight",
                 w_down="mlp.down_proj.weight", bq="self_attn.q_proj.bias",
                 bk="self_attn.k_proj.bias", bv="self_attn.v_proj.bias",
                 attn_norm="input_layernorm.weight",
                 mlp_norm="post_attention_layernorm.weight")
    for i, lp in enumerate(params["layers"]):
        shards.append({f"model.layers.{i}.{names[k]}": (v.t() if v.dim() == 2 else v)
                       for k, v in lp.items()})
    weight_map, nbytes = {}, 0
    for j, shard in enumerate(shards):
        fname = f"model-{j + 1:05d}-of-{n:05d}.safetensors"
        write_safetensors(os.path.join(path, fname), shard)
        weight_map.update({k: fname for k in shard})
        nbytes += sum(t.numel() * t.element_size() for t in shard.values())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": nbytes}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(model_type=model_type, architectures=["Qwen2ForCausalLM"],
                       vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
                       intermediate_size=cfg.ffn_dim, num_hidden_layers=cfg.n_layers,
                       num_attention_heads=cfg.n_heads,
                       num_key_value_heads=cfg.n_kv_heads, rms_norm_eps=cfg.norm_eps,
                       rope_theta=cfg.rope_theta, hidden_act="silu",
                       max_position_embeddings=131072, sliding_window=131072,
                       use_sliding_window=False, tie_word_embeddings=False,
                       torch_dtype="bfloat16"), f)
    return nbytes


def checkpoint_phase(counts, ident):
    """Main path, checkpoints: a full-width 2-layer Qwen2-7B (seeded random
    bf16 weights, random q/k/v biases) written as a Hugging Face checkpoint
    (3 safetensors shards, the index and config.json, in a temporary
    directory), loaded back with from_safetensors in bf16 (bit-equal to
    what was written, and the config equal) and with quantize="int8" (each
    projection equal to quantize_weight of it, the rest bit-equal), then
    both loads served: greedy tokens equal to an engine on the in-memory
    weights (int8: the in-memory weights quantized the same way, every
    projection through kernel 10). Prints the load rate."""
    import dataclasses as dc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import convert, llama, wquant
    from mfa_tpu_torch.serve.engine import Engine

    cfg = dc.replace(_family_config("Qwen2-7B"), n_layers=2)
    params = _family_params(cfg, SEED + 6)
    tmp = tempfile.mkdtemp(prefix="qwen2_7b_ckpt_")
    ok = True
    try:
        t0 = time.perf_counter()
        nbytes = _hf_checkpoint(tmp, params, cfg)
        write_s = time.perf_counter() - t0
        loads = {}
        for quant in (None, "int8"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loads[quant] = convert.from_safetensors(tmp, quantize=quant, device="cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"checkpoint Qwen2-7B (2 layers, full width): from_safetensors"
                  f"(quantize={quant!r}) read {nbytes / 1e9:.3f} GB in {dt:.3f} s: "
                  f"{nbytes / 1e9 / dt:.3f} GB/s to the card (written in "
                  f"{write_s:.3f} s) [{ident}]", flush=True)

        def leaves(tree):
            from mfa_tpu_torch.utils.checkpoint import _flatten
            return _flatten(tree)

        (got, gcfg), (gotq, _) = loads[None], loads["int8"]
        same = gcfg == cfg and [p for p, _ in leaves(got)] == [p for p, _ in leaves(params)]
        same &= all(a.dtype == b.dtype and torch.equal(a, b)
                    for (_, a), (_, b) in zip(leaves(got), leaves(params)))
        proj = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
        refq = dict(params, layers=[{k: wquant.quantize_weight(v) if k in proj else v
                                     for k, v in lp.items()} for lp in params["layers"]])
        sameq = [p for p, _ in leaves(gotq)] == [p for p, _ in leaves(refq)]
        sameq &= all(a.dtype == b.dtype and torch.equal(a, b)
                     for (_, a), (_, b) in zip(leaves(gotq), leaves(refq)))
        print(f"checkpoint: bf16 load bit-equal to the written weights and config "
              f"{same}; int8 load equal to quantize_weight of each projection {sameq}",
              flush=True)
        ok &= same and sameq
        rng = np.random.RandomState(SEED + 6)
        prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
                   for n in (100, 180, 250, 300)]
        tokens = {}
        for tag, p in (("in memory", params), ("bf16 load", got),
                       ("int8 in memory", refq), ("int8 load", gotq)):
            eng = Engine(p, cfg, num_pages=64, page_size=64, max_seqs=4,
                         pages_per_seq=8, quant_dtype="int8", device="cuda")
            _build.reset_launches()
            reqs = [eng.submit(pr, 16) for pr in prompts]
            eng.run()
            got_l = dict(_build.launches)
            counts.update({k_: counts.get(k_, 0) + n for k_, n in got_l.items()})
            tokens[tag] = [r.generated for r in reqs]
            print(f"checkpoint engine ({tag}): 4 requests x 16 tokens, launches "
                  f"{got_l}", flush=True)
            if tag.startswith("int8"):
                ok &= got_l.get("wmatmul", 0) > 0
            del eng
        eq = tokens["bf16 load"] == tokens["in memory"]
        eqq = tokens["int8 load"] == tokens["int8 in memory"]
        ok &= eq and eqq and all(len(t) == 16 for t in tokens["in memory"])
        print(f"checkpoint: greedy tokens of the bf16 load equal the in-memory "
              f"engine's {eq}; of the int8 load equal the in-memory int8 engine's "
              f"{eqq}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del params
        loads = None
        torch.cuda.empty_cache()
    return ok


def train_phase(counts, ident, state, model="Llama-3-8B", shape=(4, 2048), keep=False):
    """Main path, part 4: three SGD train steps of the full Llama-3-8B
    (32 layers, the engines' random bf16 weights, their KV pools freed) on
    b x (s + 1) tokens from numpy.random.RandomState(SEED) (shape = (b, s):
    the 8B's 4 x 2048 is benchmark/train.py's batch and sequence), remat on. Each layer's attention runs kernels 2 + 3
    in the forward and again in the remat recompute, and the fused backward
    kernel. SGD, not AdamW: AdamW's two moments would add 32-64 GB to the
    16 GB of weights and 16 GB of gradients on an 80 GB card. With model
    "Gemma3-4B", the same on the full Gemma3-4B text stack (34 layers,
    head_dim 256; its sliding layers' backward cuts the band at 1024
    columns): the fused kernel at d 256, 34 launches a step. An fp32 config
    (model "Llama-3-8B fp32": 32.1 GB of weights and 32.1 GB of gradients)
    runs the fp32 kernels (launch names <name>_fp32) and its share is taken
    against 165 TFLOP/s (fp32-accurate products) instead of 989. keep: the
    trained weights go back into state for the next phase."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.utils import timing

    params, cfg = state.pop("params"), state.pop("cfg")
    lr, (b, s) = 1.0, shape
    f32 = cfg.dtype == torch.float32
    sfx, peak = ("_fp32", PEAK_F32_FLOPS) if f32 else ("", timing.PEAK_BF16_FLOPS)
    rng = np.random.RandomState(SEED)
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size, (b, s + 1)),
                             device="cuda")
    before = {n: params["layers"][i][n].clone()
              for i, n in ((0, "wq"), (cfg.n_layers - 1, "w_down"))}
    torch.cuda.reset_peak_memory_stats()
    losses, times, ok = [], [], True
    for step in range(3):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = llama.train_step(params, tokens, cfg, lr=lr, remat=True)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = dict(_build.launches)
        counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
        good = got.get("bwd_fused" + sfx, 0) == cfg.n_layers \
            and _wave_launches(got, 2 * cfg.n_layers, head_dim=cfg.head_dim, suffix=sfx)
        if f32:  # no 16-bit launch
            good &= not any(n in got for n in FP32_KERNELS + FP32_BWD)
        fwd = "bound" if cfg.head_dim % 128 else "flagged = repair"
        print(f"train step {step + 1}: loss {losses[-1]:.6f}, {times[-1] * 1e3:.1f} "
              f"ms, launches {got} (bwd_fused = {cfg.n_layers} layers, {fwd} = "
              f"2 x {cfg.n_layers}: forward + remat recompute) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    changed = {n: not torch.equal(t, params["layers"][i][n])
               for (n, t), i in zip(before.items(), (0, cfg.n_layers - 1))}
    ok &= all(math.isfinite(x) for x in losses) and losses[2] < losses[0]
    ok &= all(changed.values())
    n_mat = sum(p.numel() for p in llama.param_tensors(params) if p.dim() == 2) \
        - params["embed"].numel()
    # each layer's own visible pairs: a sliding layer sees at most its window
    pairs = sum(b * _visible_pairs(s, s, 0, wl, 0, cfg.attn_sinks)
                for wl, _ in llama._layer_plan(cfg))
    model_flops = 6 * n_mat * b * s + 12 * cfg.n_heads * cfg.head_dim * pairs
    step_s = sum(times[1:]) / 2
    print(f"train: {model}, {cfg.n_layers} layers, b {b} x {s} tokens, remat, "
          f"SGD lr {lr}: losses {losses} (falling: {losses[2] < losses[0]}), "
          f"weights changed {changed}", flush=True)
    print(f"train: step {step_s * 1e3:.1f} ms (mean of steps 2-3; step 1 "
          f"{times[0] * 1e3:.1f} ms), {b * s / step_s:.1f} train tokens/s, peak "
          f"memory {peak_gb:.2f} GB; model-FLOPs share {model_flops / step_s / peak:.4f} "
          f"= (6 N T + 12 hq d P) / step time / {peak / 1e12:.0f} TFLOP/s with N = {n_mat} "
          f"weights in matmuls (layers + lm_head, not the embedding table), T = "
          f"{b * s} tokens, P = {pairs} visible pairs summed over the "
          f"{cfg.n_layers} layers, remat recompute not counted [{ident}]", flush=True)
    ok &= peak_gb < 80
    for p in llama.param_tensors(params):
        p.grad = None
        p.requires_grad_(not keep)  # kept weights serve next: no autograd graph
    if keep:
        state.update(params=params, cfg=cfg)
    del params, before
    torch.cuda.empty_cache()
    return ok


def _gemma3_prompts(rng, n_img_short=4, n_img_long=2, n_text=4):
    """Image prompts (text, 256 <image> tokens per image, text; the first
    with two images; the long ones' run after 1100 text tokens, past the
    1024 window) and text-only prompts, as token lists, and each image
    prompt's image count."""
    def text(lo, hi):
        return [int(t) for t in rng.randint(0, IMAGE_TOKEN, rng.randint(lo, hi + 1))]

    img = [IMAGE_TOKEN] * 256
    prompts, n_images = [], []
    for i in range(n_img_short):
        p = text(100, 300) + img + text(50, 200)
        if i == 0:
            p += img + text(20, 60)
        prompts.append(p)
        n_images.append(2 if i == 0 else 1)
    for _ in range(n_img_long):
        prompts.append(text(1100, 1150) + img + text(20, 100))
        n_images.append(1)
    texts = [text(300, 1800) for _ in range(n_text)]
    return prompts, n_images, texts


def engine_gemma3_phase(counts, ident, state):
    """Main path, part 5: Gemma3-4B multimodal serving at full width and
    depth (the 8B weights are freed by then): 34 text layers and the
    27-layer tower, random bf16 weights from SEED, int8 paged KV with
    64-token pages, 6 image prompts (7 random 896 x 896 images) and 4 text
    prompts of 300-1800 tokens, 32 new tokens each. Launches: kernel 9 34
    per image wave, kernels 2 + 3 34 each per text wave, the paged kernel 34 per
    decode step. The text weights stay in `state` for the Gemma3 chunked
    engines and train steps."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama, vision
    from mfa_tpu_torch.serve.engine import Engine

    cfg, vcfg = llama.LlamaConfig.gemma3_4b(), vision.SiglipVisionConfig()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    vparams = vision.init_vision_params(vcfg, cfg.dim, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_text = sum(p.numel() for p in llama.param_tensors(params))
    n_vis = sum(t.numel() for lp in vparams["layers"] for t in lp.values()) + sum(
        t.numel() for k_, t in vparams.items() if k_ != "layers")
    print(f"engine: Gemma3-4B, {cfg.n_layers} layers (window {cfg.sliding_window}, "
          f"global layers {[i for i, f in enumerate(cfg.layer_pattern) if not f]}), "
          f"head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, {n_text} text weights + "
          f"{n_vis} tower weights in bf16 from seed {SEED} "
          f"({time.perf_counter() - t0:.1f} s to build)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    gen_tokens = 32
    eng = Engine(params, cfg, num_pages=512, page_size=64, max_seqs=16,
                 pages_per_seq=40, quant_dtype="int8", device="cuda",
                 vision=(vparams, vcfg, IMAGE_TOKEN))
    free0 = eng.sched.allocator.free_pages
    rng = np.random.RandomState(SEED)
    prompts, n_images, texts = _gemma3_prompts(rng)
    pixels = [rng.standard_normal((n, 3, vcfg.image_size, vcfg.image_size)
                                  ).astype(np.float32) for n in n_images]
    _build.reset_launches()
    reqs = [eng.submit(p, gen_tokens, images=px) for p, px in zip(prompts, pixels)]
    reqs += [eng.submit(p, gen_tokens) for p in texts]
    stats = eng.run()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.n_layers
    text_waves = stats.prefill_batches - stats.image_batches
    ok = all(len(r.generated) == gen_tokens for r in reqs)
    ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
    ok &= eng.sched.allocator.free_pages == free0
    ok &= stats.image_batches >= 1 and text_waves >= 1
    ok &= got.get("blockmask", 0) == L * stats.image_batches
    ok &= _wave_launches(got, L * text_waves)
    ok &= got.get("paged", 0) == L * stats.steps
    ok &= not got.get("paged_prefill", 0)
    print(f"gemma3 engine launches {got}: blockmask = {L} layers x "
          f"{stats.image_batches} image waves, flagged = repair = {L} x {text_waves} text "
          f"waves, paged = {L} x {stats.steps} decode steps", flush=True)
    # the tower alone, warm, on one image and on the wave's seven
    one = torch.as_tensor(pixels[0][:1], device="cuda")
    every = torch.cat([torch.as_tensor(p, device="cuda") for p in pixels])
    tower_1 = _time_ms(lambda: vision.gemma3_image_features(vparams, one, vcfg),
                       iters=3)
    tower_all = _time_ms(lambda: vision.gemma3_image_features(vparams, every, vcfg),
                         iters=2)
    img_tok, text_tok = stats.image_prefill_tokens, stats.prefill_tokens - \
        stats.image_prefill_tokens
    text_s = stats.prefill_s - stats.image_prefill_s
    step_tokens = stats.decode_tokens - len(reqs)
    print(f"gemma3 engine: {len(reqs)} requests ({len(prompts)} with "
          f"{sum(n_images)} images, {len(texts)} text) finished with {gen_tokens} "
          f"tokens: {all(len(r.generated) == gen_tokens for r in reqs)}; free pages "
          f"{eng.sched.allocator.free_pages} of {free0} returned", flush=True)
    print(f"gemma3 engine: vision tower + projector {tower_1:.3f} ms for one image, "
          f"{tower_all / len(every):.3f} ms per image for the wave's {len(every)}; "
          f"image wave prefill {img_tok / stats.image_prefill_s:.1f} tok/s ({img_tok} "
          f"tokens in {stats.image_prefill_s:.3f} s, tower included), text wave "
          f"prefill {text_tok / text_s:.1f} tok/s ({text_tok} tokens in "
          f"{text_s:.3f} s), decode {_decode_rates(stats, step_tokens)}, "
          f"peak memory {peak_gb:.2f} GB [{ident}]", flush=True)
    del eng, vparams, every
    state.update(params=params, cfg=cfg)
    torch.cuda.empty_cache()
    return ok


def cpu_vs_cuda_gemma3_phase():
    """Phase 4, Gemma3: 2 text layers (one sliding, one global) at
    Gemma3-4B widths and a 2-layer tower at 224 px (16 x 16 patches, 256
    soft tokens), kernels on the card vs plain versions on the CPU, same
    weights: a wave of two image prompts (one run after 1100 text tokens,
    past the window) and the next decode step; then chunked prefill on
    int8 KV (kernel 8 at d 256): a 1200-token text prompt in chunks of 512,
    its last chunk past the sliding window, and a prefix hit on its first
    16 pages prefilling a 100-token suffix."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama, vision

    cfg = dataclasses.replace(llama.LlamaConfig.gemma3_4b(), n_layers=2,
                              layer_pattern=(True, False))
    vcfg = dataclasses.replace(vision.SiglipVisionConfig(), n_layers=2, image_size=224)
    p_gpu = llama.init_params(cfg, seed=SEED + 3, device="cuda")
    v_gpu = vision.init_vision_params(vcfg, cfg.dim, seed=SEED + 3, device="cuda")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k_: to_cpu(v_) for k_, v_ in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v_) for v_ in tree]
        return tree.cpu()

    rng = np.random.RandomState(SEED + 3)
    prompts, n_images, _ = _gemma3_prompts(rng, 1, 1, 0)
    pixels = [rng.standard_normal((n, 3, 224, 224)).astype(np.float32) for n in n_images]
    # each prompt's pages plus one for the decoded token
    needs = [-(-len(p) // 64) + 1 for p in prompts]
    pages = [list(range(1 + sum(needs[:i]), 1 + sum(needs[:i + 1])))
             for i in range(len(needs))]
    long = [int(t) for t in rng.randint(0, IMAGE_TOKEN, 1200)]
    hit = long[:1024] + [int(t) for t in rng.randint(0, IMAGE_TOKEN, 100)]
    pages0 = list(range(1, 20))
    pages1 = pages0[:16] + [20, 21]  # the hit shares the first 16 pages
    out = {}
    for dev, params, vparams in (("cuda", p_gpu, v_gpu),
                                 ("cpu", to_cpu(p_gpu), to_cpu(v_gpu))):
        cache = llama.build_kv_caches(cfg, sum(needs) + 1, 64, 2, 32, "int8",
                                      device=dev)
        cache, lg1 = llama.prefill_batch(params, cfg, cache, [0, 1], pages, prompts,
                                         vision=(vparams, vcfg, IMAGE_TOKEN),
                                         pixel_lists=pixels)
        toks = out["toks"] if "toks" in out else lg1.argmax(-1).cpu()
        out["toks"] = toks
        cache, lg2 = llama.decode_step(params, cfg, cache, [0, 1], toks)
        cc = llama.build_kv_caches(cfg, 22, 64, 2, 19, "int8", device=dev)
        for off in (0, 512, 1024):
            cc, lg3 = llama.prefill_chunk_batch(params, cfg, cc, [0], [pages0],
                                                [long[off:off + 512]], [off], [1200], 512)
        cc, lg4 = llama.prefill_chunk_batch(params, cfg, cc, [1], [pages1], [hit[1024:]],
                                            [1024], [1124], 512)
        out[dev] = tuple(x.float().cpu() for x in (lg1, lg2, lg3, lg4))
    ok = True
    for i, name in enumerate(("image prefill_batch", "decode_step",
                              "prefill_chunk_batch, 3rd chunk of 1200 (int8 KV)",
                              "prefix-hit suffix chunk (int8 KV)")):
        a, r = out["cuda"][i], out["cpu"][i]
        d = (a - r).abs()
        tol_max, tol_mean = 0.25, 0.02  # as for the 8B model above
        good = bool(torch.isfinite(a).all()) and float(d.max()) < tol_max \
            and float(d.mean()) < tol_mean
        print(f"gemma3 cuda vs cpu {name} logits [{tuple(a.shape)}], prompts "
              f"{[len(p) for p in prompts]}: max_abs {float(d.max()):.3e} (< {tol_max})"
              f" mean_abs {float(d.mean()):.3e} (< {tol_mean}), |ref| max "
              f"{float(r.abs().max()):.2f}, argmax agree "
              f"{bool(torch.equal(a.argmax(-1), r.argmax(-1)))} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


def _kv_stage_logits(llama, cfg, params, dev, quant, out, prompts, pages, long, hit,
                     page=64):
    """cpu_vs_cuda_phase's stages on `dev` over `quant` KV pages -> the
    logits of a prompt wave, a decode step, the second of two 128-token
    chunks and a prefix-hit suffix chunk (the decode step takes the tokens
    of out["toks"], set by the first device's wave). Pages of 64 rows take
    the table entries given; other page sizes number their pages in order,
    the hit sharing the long prompt's whole pages of its first 128 tokens
    (chunks are whole pages: 132 + 124 tokens at page 12)."""
    if page == 64:
        pps, chunk_pps, long_pages, hit_pages, shared = 4, 8, [6, 7, 8, 9], [6, 7, 10], 128
    else:
        need = [-(-(len(t) + 1) // page) for t in prompts]
        pages = [list(range(1, 1 + need[0])), list(range(1 + need[0], 1 + sum(need)))]
        shared = 128 // page * page
        n_long, n_hit = -(-256 // page), -(-188 // page)
        long_pages = list(range(1, 1 + n_long))
        hit_pages = long_pages[:shared // page] + list(
            range(1 + n_long, 1 + n_long + n_hit - shared // page))
        pps, chunk_pps = max(need), max(n_long, n_hit)
    n_pages = 1 + max(sum(len(x) for x in pages), len(long_pages) + len(hit_pages))
    cache = llama.build_kv_caches(cfg, max(16, n_pages), page, 2, pps, quant, device=dev)
    cache, lg1 = llama.prefill_batch(params, cfg, cache, [0, 1], pages, prompts)
    out.setdefault("toks", lg1.argmax(-1).cpu())
    cache, lg2 = llama.decode_step(params, cfg, cache, [0, 1], out["toks"])
    cc = llama.build_kv_caches(cfg, max(16, n_pages), page, 2, chunk_pps, quant, device=dev)
    lc = -(-128 // page) * page  # chunks are whole pages: 128 tokens, 132 at page 12
    for off in (0, lc):
        cc, lg3 = llama.prefill_chunk_batch(params, cfg, cc, [0], [long_pages],
                                            [long[off:off + lc]], [off], [256], lc)
    cc, lg4 = llama.prefill_chunk_batch(params, cfg, cc, [1], [hit_pages],
                                        [hit[shared:]], [shared], [188],
                                        -(-(188 - shared) // page) * page)
    return tuple(x.float().cpu() for x in (lg1, lg2, lg3, lg4))


def _device_pair_logits(llama, cfg, p_gpu, p_cpu, quant, prompts, pages, long, hit,
                        page=64):
    """_kv_stage_logits on the card, then on the CPU -> {"cuda": ..., "cpu":
    ...}. int4's step is 1/7 of a row's absmax: a K or V value on a
    rounding edge, a bf16 ulp apart on the two devices, lands a whole step
    apart, and independent runs differ by more than the limits (PERF.md
    §6). So on int4 KV the CPU takes the payloads and scales the card's
    quantize gave, call for call: both read the same pages and the check
    holds the kernels to their plain versions."""
    store_rows = llama.payload_rows
    out, written = {}, []
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        if quant == "int4":
            def store(qd, dtype, x, dev=dev):
                if dev == "cuda":
                    written.append(store_rows(qd, dtype, x))
                    return written[-1]
                pay, sc = written.pop(0)
                return pay.cpu(), sc.cpu()

            llama.payload_rows = store
        try:
            out[dev] = _kv_stage_logits(llama, cfg, params, dev, quant, out, prompts,
                                        pages, long, hit, page)
        finally:
            llama.payload_rows = store_rows
    return out


def cpu_vs_cuda_phase():
    """Phase 4: 2 layers at the 8B widths, kernels on the card vs plain
    versions on the CPU, same weights and prompts: whole-prompt prefill, a
    decode step, a 256-token prompt in 2 chunks of 128, and a prefix hit
    (its first 2 pages shared) prefilling only a 60-token suffix chunk, on
    int8, fp8 and int4 KV pages of 64 rows; then the same on pages of 12
    rows (boxes of 4 rows; chunks of 132 and 124 tokens; the hit shares 10
    pages, 120 tokens, and prefills a 68-token suffix)."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    p_gpu = llama.init_params(cfg, seed=SEED + 2, device="cuda")
    p_cpu = dict(layers=[{k: v.cpu() for k, v in lp.items()}
                         for lp in p_gpu["layers"]],
                 **{k: p_gpu[k].cpu() for k in ("embed", "final_norm", "lm_head")})
    rng = np.random.RandomState(SEED + 2)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (37, 90)]
    pages = [[1, 2], [3, 4, 5]]
    long = list(rng.randint(0, cfg.vocab_size, 256))
    hit = long[:128] + list(rng.randint(0, cfg.vocab_size, 60))
    ok = True
    for quant, page in [(q, 64) for q in ("int8",) + KV_FORMATS] + [
            (q, 12) for q in ("int8",) + KV_FORMATS]:
        out = _device_pair_logits(llama, cfg, p_gpu, p_cpu, quant, prompts, pages,
                                  long, hit, page)
        tag = f"{quant} KV" + (", the card's payloads" if quant == "int4" else "")
        tag += "" if page == 64 else f", pages of {page} rows"
        for i, name in enumerate(("prefill_batch", "decode_step",
                                  "prefill_chunk_batch 2 x 128",
                                  "prefix-hit suffix chunk")):
            a, r = out["cuda"][i], out["cpu"][i]
            d = (a - r).abs()
            # bf16 activations rounded in other summation orders on the two
            # devices, through 2 layers and the 4096 x 128256 lm_head; the
            # logits have unit scale (random weights, std 1)
            tol_max, tol_mean = 0.25, 0.02
            good = bool(torch.isfinite(a).all()) and float(d.max()) < tol_max \
                and float(d.mean()) < tol_mean
            print(f"cuda vs cpu {name} ({tag}) logits [{tuple(a.shape)}]: max_abs "
                  f"{float(d.max()):.3e} (< {tol_max}) mean_abs {float(d.mean()):.3e} "
                  f"(< {tol_mean}), |ref| max {float(r.abs().max()):.2f}, argmax "
                  f"agree {bool(torch.equal(a.argmax(-1), r.argmax(-1)))} "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            ok &= good
    ok &= _sampled_step_logits(llama, cfg, p_gpu, p_cpu, prompts, pages)
    # one SGD train step on b 1 x 65 tokens, same weights on both devices
    toks = rng.randint(0, cfg.vocab_size, (1, 65))
    res = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        params, loss = llama.train_step(params, toks, cfg, lr=1.0)
        res[dev] = (float(loss), [p.grad.float().cpu()
                                  for p in llama.param_tensors(params)])
    d_loss = abs(res["cuda"][0] - res["cpu"][0])
    good = d_loss <= 5e-2
    worst_cos, worst_ratio = 1.0, 0.0
    for a, r in zip(res["cuda"][1], res["cpu"][1]):
        na, nr = float(a.norm()), float(r.norm())
        if na == 0.0 and nr == 0.0:
            continue
        cos = float((a * r).sum()) / max(na * nr, 1e-30)
        worst_cos = min(worst_cos, cos)
        worst_ratio = max(worst_ratio, abs(na / max(nr, 1e-30) - 1.0))
    good &= worst_cos >= 0.99 and worst_ratio <= 0.05
    print(f"cuda vs cpu train_step (2 layers, 1 x 65 tokens, SGD): loss "
          f"{res['cuda'][0]:.5f} vs {res['cpu'][0]:.5f} (|diff| {d_loss:.2e} <= "
          f"5e-2); over {len(res['cpu'][1])} weight tensors the least gradient "
          f"cosine {worst_cos:.5f} (>= 0.99), the largest norm ratio - 1 "
          f"{worst_ratio:.4f} (<= 0.05) {'ok' if good else 'FAIL'}", flush=True)
    return ok and good


def cpu_vs_cuda_families_phase():
    """Phase 4 for the dense families: Qwen2-7B and Gemma2-9B at full width
    cut to 2 layers (Gemma2: one sliding layer, one global), seeded random
    weights (Qwen2's biases drawn), kernels on the card vs plain versions on
    the CPU over int8 KV pages: a prompt wave, a decode step, a 256-token
    prompt in 2 chunks of 128 and a prefix-hit suffix chunk
    (_kv_stage_logits), logits within max 0.25 / mean 0.02."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama

    ok = True
    for model in FAMILY_CONFIGS:
        cfg = dataclasses.replace(_family_config(model), n_layers=2)
        p_gpu = _family_params(cfg, SEED + 7)
        p_cpu = dict(layers=[{k: v.cpu() for k, v in lp.items()}
                             for lp in p_gpu["layers"]],
                     **{k: p_gpu[k].cpu() for k in ("embed", "final_norm", "lm_head")})
        rng = np.random.RandomState(SEED + 7)
        prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (37, 90)]
        long = list(rng.randint(0, cfg.vocab_size, 256))
        hit = long[:128] + list(rng.randint(0, cfg.vocab_size, 60))
        out = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            out[dev] = _kv_stage_logits(llama, cfg, params, dev, "int8", out, prompts,
                                        [[1, 2], [3, 4, 5]], long, hit)
        for i, name in enumerate(("prefill_batch", "decode_step",
                                  "prefill_chunk_batch 2 x 128",
                                  "prefix-hit suffix chunk")):
            a, r = out["cuda"][i], out["cpu"][i]
            d = (a - r).abs()
            good = bool(torch.isfinite(a).all()) and float(d.max()) < 0.25 \
                and float(d.mean()) < 0.02
            print(f"cuda vs cpu {model} (2 layers) {name} (int8 KV) logits "
                  f"[{tuple(a.shape)}]: max_abs {float(d.max()):.3e} (< 0.25) mean_abs "
                  f"{float(d.mean()):.3e} (< 0.02), |ref| max {float(r.abs().max()):.2f}, "
                  f"argmax agree {bool(torch.equal(a.argmax(-1), r.argmax(-1)))} "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            ok &= good
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    return ok


def _sampled_step_logits(llama, cfg, p_gpu, p_cpu, prompts, pages):
    """cuda_vs_cpu's sampled row: the mixed batch's first decode step (one
    greedy row and one at temperature 0.8 / top-p 0.9 with a repetition
    penalty, the engine's top-k 50, presence rows of the prompts) on int8
    KV, card against CPU: the step's logits within the limits of the other
    rows. Tokens are not compared: the noise differs between devices."""
    import torch

    from mfa_tpu_torch.serve.sampling import SamplingParams

    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = llama.build_kv_caches(cfg, 16, 64, 2, 4, "int8", device=dev)
        cache, lg = llama.prefill_batch(params, cfg, cache, [0, 1], pages, prompts)
        pres = torch.zeros(2, cfg.vocab_size, dtype=torch.bool, device=dev)
        for i, p in enumerate(prompts):
            pres[i, torch.as_tensor(p, device=dev)] = True
        vecs = torch.tensor([[0.0, 0.8], [1.0, 0.9], [0.0, 0.0], [1.0, 1.3]],
                            device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        first = out.setdefault("toks", lg.argmax(-1).cpu())
        _, ids, lps, logits = llama.decode_burst(
            params, cfg, cache, [0, 1], first, 1, SamplingParams(top_k=50), gen,
            pres, vecs, return_logits=True)
        out[dev] = (logits[0].float().cpu(), ids.cpu(), lps.cpu())
    a, r = out["cuda"][0], out["cpu"][0]
    d = (a - r).abs()
    good = bool(torch.isfinite(a).all()) and float(d.max()) < 0.25 \
        and float(d.mean()) < 0.02
    good &= bool(torch.isfinite(out["cuda"][2]).all())
    good &= bool(((out["cuda"][1] >= 0) & (out["cuda"][1] < cfg.vocab_size)).all())
    print(f"cuda vs cpu sampled engine step (int8 KV; rows greedy and temperature "
          f"0.8 / top-p 0.9 / penalty 1.3, top-k 50) logits [{tuple(a.shape)}]: "
          f"max_abs {float(d.max()):.3e} (< 0.25) mean_abs {float(d.mean()):.3e} "
          f"(< 0.02); greedy row's token equal {bool(out['cuda'][1][0, 0] == out['cpu'][1][0, 0])} "
          f"(not a check) {'ok' if good else 'FAIL'}", flush=True)
    return good


def engine_int8w_phase(counts, ident):
    """Main path, part 6: Llama-3-8B at full width and depth with int8
    weights (init_params(quantize="int8"): every projection and the lm_head
    a QWeight, quantized layer by layer as it is built; the embedding per
    row) and int8 paged KV, the traffic of part 2: 16 requests of 200-256
    prompt tokens, 32 new tokens each. Every projection runs kernel 10 (7
    per layer and the lm_head, per wave and per decode step), every wave
    kernels 2 + 3, every decode step the paged kernel."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.models.wquant import params_nbytes
    from mfa_tpu_torch.serve.engine import Engine

    cfg = llama.LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda", quantize="int8")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    nbytes = params_nbytes(params)
    print(f"engine int8 weights: Llama-3-8B width, {cfg.n_layers} layers, {nbytes / 1e9:.3f}"
          f" GB of weights (bf16: 16.06 GB), built and quantized from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s, init peak memory {init_peak:.2f} GB",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    n_req, gen_tokens, page = 16, 32, 64
    eng = Engine(params, cfg, num_pages=128, page_size=page, max_seqs=16,
                 pages_per_seq=8, quant_dtype="int8", device="cuda")
    free0 = eng.sched.allocator.free_pages
    rng = np.random.RandomState(SEED)
    reqs = [eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))), gen_tokens)
            for n in rng.randint(200, 257, n_req)]
    _build.reset_launches()
    stats = eng.run()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.n_layers
    passes = stats.prefill_batches + stats.steps
    ok = all(len(r.generated) == gen_tokens for r in reqs)
    ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
    ok &= eng.sched.allocator.free_pages == free0
    ok &= _wave_launches(got, L * stats.prefill_batches)
    ok &= got.get("paged", 0) == L * stats.steps
    ok &= got.get("wmatmul", 0) == (7 * L + 1) * passes
    step_tokens = stats.decode_tokens - n_req
    print(f"engine int8 weights launches {got}: wmatmul = (7 x {L} projections + "
          f"lm_head) x ({stats.prefill_batches} waves + {stats.steps} decode steps), "
          f"flagged = repair = {L} x {stats.prefill_batches}, paged = {L} x "
          f"{stats.steps}", flush=True)
    print(f"engine int8 weights: {n_req} requests finished with {gen_tokens} tokens: "
          f"{all(len(r.generated) == gen_tokens for r in reqs)}; free pages "
          f"{eng.sched.allocator.free_pages} of {free0} returned", flush=True)
    print(f"engine int8 weights: prefill {stats.prefill_tokens / stats.prefill_s:.1f} "
          f"tok/s ({stats.prefill_tokens} tokens in {stats.prefill_s:.3f} s), decode "
          f"{_decode_rates(stats, step_tokens)}, weights {nbytes / 1e9:.3f} GB, "
          f"peak memory {peak_gb:.2f} GB [{ident}]", flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return ok


def _bf16_nbytes(params) -> int:
    """Bytes the weights would hold in bf16 (fp32 norms and router as they
    are): a QWeight counts 2 bytes an entry."""
    from mfa_tpu_torch.models.wquant import QWeight

    if isinstance(params, dict):
        return sum(_bf16_nbytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(_bf16_nbytes(v) for v in params)
    if isinstance(params, QWeight):
        return params.qw.numel() * 2
    return params.numel() * params.element_size()


class _RouteTally:
    """Wraps llama._moe_route while installed: sums, on the device, the rows
    routed to each expert per call of more than _MOE_DENSE_MAX_T rows
    (prefill waves and chunk batches; never inside a graph capture), and
    with keep=True keeps every call's expert ids."""

    def __init__(self, llama, keep=False):
        self.llama, self.keep = llama, keep
        self.counts, self.ids = [], []

    def __enter__(self):
        import torch

        orig = self.orig = self.llama._moe_route
        llama = self.llama

        def counting(t, w_router, k, norm_topk):
            w_top, idx = orig(t, w_router, k, norm_topk)
            if self.keep:
                self.ids.append(idx.sort(dim=-1).values.cpu())
            elif (t.shape[0] > llama._MOE_DENSE_MAX_T
                  and not torch.cuda.is_current_stream_capturing()):
                flat = idx.reshape(-1)
                self.counts.append(torch.zeros(w_router.shape[1], dtype=torch.long,
                                               device=t.device).scatter_add_(
                    0, flat, torch.ones_like(flat)))
            return w_top, idx

        llama._moe_route = counting
        return self

    def __exit__(self, *exc):
        self.llama._moe_route = self.orig


def engine_mixtral_phase(counts, ident, state):
    """Main path, Mixtral-8x7B at full width and depth (32 layers, 8 experts,
    top 2, ffn 14336) with int8 weights and expert banks
    (init_params(quantize="int8"): each bank quantized one expert slice at a
    time) and int8 KV pages of 64; the earlier phases' weights freed first.
    (a) the 8B engine's traffic, 16 requests of 200-256 prompt tokens and
    32 new tokens, decode graphed in bursts of 8 (run(burst=8)), then the
    same traffic stepwise with the graphs off: the same tokens. Each decode
    step is 32 layers x 3 expert launches (the dense form), each wave the
    grouped form. (b) the chunked + prefix engine and its traffic
    (chunked_engine_phase): 17 requests, prompts up to 4000 tokens, chunks
    of 512, 8 hits on a 1024-token system prompt."""
    import gc

    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.models.wquant import params_nbytes
    from mfa_tpu_torch.serve import graphs
    from mfa_tpu_torch.serve.engine import Engine

    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.LlamaConfig.mixtral_8x7b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED + 6, device="cuda", quantize="int8")
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9
    nbytes, bf16_bytes = params_nbytes(params), _bf16_nbytes(params)
    banks = sum(params_nbytes([lp[k] for k in ("we_gate", "we_up", "we_down")])
                for lp in params["layers"])
    ok = nbytes <= 0.52 * bf16_bytes
    print(f"engine Mixtral-8x7B: {cfg.n_layers} layers, {cfg.n_experts} experts top "
          f"{cfg.n_active_experts}, int8 weights {nbytes / 1e9:.3f} GB ({banks / 1e9:.3f} "
          f"GB of expert banks) against {bf16_bytes / 1e9:.3f} GB in bf16 (ratio "
          f"{nbytes / bf16_bytes:.4f} <= 0.52), built and quantized from seed {SEED + 6} "
          f"in {init_s:.1f} s, init peak memory {init_peak:.2f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    n_req, gen_tokens, L = 16, 32, cfg.n_layers
    kw = dict(num_pages=128, page_size=64, max_seqs=16, pages_per_seq=8,
              quant_dtype="int8", device="cuda")

    def traffic(eng):
        rng = np.random.RandomState(SEED)
        return [eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))), gen_tokens)
                for n in rng.randint(200, 257, n_req)]

    eng = Engine(params, cfg, **kw)
    free0 = eng.sched.allocator.free_pages
    reqs = traffic(eng)
    _build.reset_launches()
    with _RouteTally(llama) as tally:
        t0 = time.perf_counter()
        stats = eng.run(burst=8)
        wall = time.perf_counter() - t0
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graphed = [list(r.generated) for r in reqs]
    passes = stats.prefill_batches + stats.steps
    ok &= all(len(r.generated) == gen_tokens for r in reqs)
    ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
    ok &= eng.sched.allocator.free_pages == free0 and stats.captures >= 1
    ok &= _wave_launches(got, L * stats.prefill_batches)
    ok &= got.get("paged", 0) == L * stats.steps
    ok &= got.get("wmatmul_bank", 0) == 3 * L * passes
    ok &= got.get("wmatmul", 0) == (4 * L + 1) * passes
    ok &= peak_gb < 80
    per = torch.stack(tally.counts).float() if tally.counts else torch.zeros(1, 8)
    step_tokens = stats.decode_tokens - n_req
    print(f"engine Mixtral-8x7B launches {got}: wmatmul_bank = 3 x {L} layers x "
          f"({stats.prefill_batches} waves + {stats.steps} decode steps) = "
          f"{3 * L} a decode step, wmatmul = (4 x {L} + lm_head) x the same, "
          f"paged = {L} x {stats.steps}", flush=True)
    print(f"engine Mixtral-8x7B: rows an expert takes in a wave's layer ({len(tally.counts)}"
          f" layer passes of {int(per[0].sum()) if tally.counts else 0} rows, top "
          f"{cfg.n_active_experts} of the padded wave): mean {float(per.mean()):.1f}, max "
          f"{float(per.max()):.0f}, min {float(per.min()):.0f}", flush=True)
    print(f"engine Mixtral-8x7B (run(burst=8)): {n_req} requests finished with "
          f"{gen_tokens} tokens: {all(len(r.generated) == gen_tokens for r in reqs)}; "
          f"free pages {eng.sched.allocator.free_pages} of {free0} returned; prefill "
          f"{stats.prefill_tokens / stats.prefill_s:.1f} tok/s ({stats.prefill_tokens} "
          f"tokens in {stats.prefill_s:.3f} s), decode {_decode_rates(stats, step_tokens)}"
          f", {wall:.3f} s wall, weights {nbytes / 1e9:.3f} GB, peak memory "
          f"{peak_gb:.2f} GB [{ident}]", flush=True)
    del eng
    graphs._ENABLED = False  # a measurement switch: every decode step eager
    try:
        eager = Engine(params, cfg, **kw)
        ereqs = traffic(eager)
        est = eager.run()
    finally:
        graphs._ENABLED = True
    same = [r.generated for r in ereqs] == graphed
    ok &= same and est.captures == 0
    print(f"engine Mixtral-8x7B, decode steps eager (graphs off): decode "
          f"{step_tokens / est.decode_s:.1f} tok/s ({est.steps} steps, {est.decode_s:.3f}"
          f" s); tokens identical to the graphed run: {same} [{ident}]", flush=True)
    del eager
    torch.cuda.empty_cache()
    state.update(params=params, cfg=cfg)
    try:
        ok &= chunked_engine_phase(counts, ident, state, "int8", "Mixtral-8x7B")
    finally:
        state.clear()
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return ok


def _int8_weights_match_cpu(llama, cfg, seed, p_gpu):
    """The card's int8 weights of layer 0 (init_params(quantize="int8"))
    against quantize_weight on the CPU of the same bf16 draw (layer 0 of a
    one-layer init from the seed; for an expert bank, its expert 0), byte
    for byte, payloads and scales: both quantize by mfa_tpu's jitted rule,
    absmax * f32(1 / 127) -> ok."""
    import torch

    from mfa_tpu_torch.models.wquant import QWeight, quantize_weight

    lp = llama.init_params(dataclasses.replace(cfg, n_layers=1), seed=seed,
                           device="cuda")["layers"][0]
    n_q = n_s = tot_q = tot_s = 0
    for key, card in p_gpu["layers"][0].items():
        if not isinstance(card, QWeight):
            continue
        w = lp[key]
        if w.ndim == 3:  # an expert bank: its first expert
            w, card = w[0], QWeight(card.qw[0], card.scale[0], card.axis)
        host = quantize_weight(w.cpu(), axis=card.axis)
        n_q += int((host.qw != card.qw.cpu()).sum())
        n_s += int((host.scale != card.scale.cpu()).sum())
        tot_q, tot_s = tot_q + host.qw.numel(), tot_s + host.scale.numel()
    del lp
    torch.cuda.empty_cache()
    ok = n_q == 0 and n_s == 0
    print(f"int8 weights of layer 0, card vs CPU quantize_weight of the same draw: "
          f"{n_q} of {tot_q} payload bytes and {n_s} of {tot_s} scales differ "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def cpu_vs_cuda_moe_phase():
    """Phase 4, MoE: (a) Mixtral-8x7B at full width cut to 2 layers, int8
    weights and banks, on the card (kernels), on the CPU (plain versions)
    and on the CPU in fp32 activations (the same int8 weights, the
    embedding dequantized: the reference both bf16 runs are held to): a
    forward of 2 x 100 tokens (the grouped form), a prefill wave of 37 and
    90 tokens and the next decode step (the dense form). Reported: the share
    of (layer, row) pairs whose top-2 expert set agrees on the card and the
    CPU (at least 0.9); over the rows routed alike in every layer by all
    three runs, the card-vs-CPU logits error (max < 0.25 everywhere, mean <
    0.02 over the forward's rows, the 2-layer limits), the spread of the
    forward's per-row means, and each bf16 run's mean distance from the fp32
    reference: the card's at most 1.25x the CPU's; layer 0's int8 weights
    (expert 0 of each bank) equal to the CPU's quantization of the same
    draw, byte for byte. (b) 4 layers at
    Mixtral's width with bf16 banks (11.3 GB) behind the engine on the
    card: the bf16 dense form (graphed decode) and grouped form (one
    torch.matmul an expert, the waves); greedy tokens equal to the same
    engine's with the graphs off."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.models.wquant import dequantize_weight
    from mfa_tpu_torch.serve import graphs
    from mfa_tpu_torch.serve.engine import Engine

    cfg = dataclasses.replace(llama.LlamaConfig.mixtral_8x7b(), n_layers=2)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p_gpu = llama.init_params(cfg, seed=SEED + 7, device="cuda", quantize="int8")
    weights_ok = _int8_weights_match_cpu(llama, cfg, SEED + 7, p_gpu)
    p_cpu = dict(layers=[{k: v.to("cpu") for k, v in lp.items()} for lp in p_gpu["layers"]],
                 **{k: p_gpu[k].to("cpu") for k in ("embed", "final_norm", "lm_head")})
    p_ref = dict(p_cpu, embed=dequantize_weight(p_cpu["embed"], torch.float32))
    rng = np.random.RandomState(SEED + 7)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 100)))
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (37, 90)]
    out, ids = {}, {}
    for run, dev, params, c in (("cuda", "cuda", p_gpu, cfg), ("cpu", "cpu", p_cpu, cfg),
                                ("fp32", "cpu", p_ref, cfg32)):
        with _RouteTally(llama, keep=True) as tally, torch.no_grad():
            fw = llama.forward(params, toks.to(dev), c)
            cache = llama.build_kv_caches(c, 16, 64, 2, 4, "int8", device=dev)
            cache, lg1 = llama.prefill_batch(params, c, cache, [0, 1],
                                             [[1, 2], [3, 4, 5]], prompts)
            nxt = out["next"] if "next" in out else lg1.argmax(-1).cpu()
            out["next"] = nxt
            cache, lg2 = llama.decode_step(params, c, cache, [0, 1], nxt)
        out[run] = [x.float().cpu() for x in (fw.reshape(-1, fw.shape[-1]), lg1, lg2)]
        ids[run] = tally.ids
    # calls in order: forward's 2 layers (200 rows), prefill's 2 (2 x 128
    # padded rows), decode's 2 (2 rows)
    agree = [torch.all(a == b, dim=-1) for a, b in zip(ids["cuda"], ids["cpu"])]
    alike = [a & torch.all(b == r, dim=-1)
             for a, b, r in zip(agree, ids["cuda"], ids["fp32"])]
    share = float(torch.cat(agree).float().mean())
    ok = share >= 0.9 and weights_ok
    last = torch.tensor([36, 89])
    rows_ok = [alike[0] & alike[1],
               (alike[2] & alike[3]).reshape(2, -1)[torch.arange(2), last],
               alike[4] & alike[5]]
    print(f"moe cuda vs cpu: top-2 expert sets agree on {share:.4f} of "
          f"{sum(a.numel() for a in agree)} (layer, row) pairs (>= 0.9)", flush=True)
    for i, name in enumerate(("forward", "prefill_batch", "decode_step")):
        a, r, ref, keep = out["cuda"][i], out["cpu"][i], out["fp32"][i], rows_ok[i]
        good = bool(torch.isfinite(a).all()) and bool(keep.any())
        msg = "no row routed alike in every layer by all three runs"
        if keep.any():
            d = (a[keep] - r[keep]).abs()
            row_mean = d.mean(dim=-1)
            to_ref = float((a[keep] - ref[keep]).abs().mean())
            cpu_to_ref = float((r[keep] - ref[keep]).abs().mean())
            good &= float(d.max()) < 0.25 and to_ref <= 1.25 * cpu_to_ref
            if name == "forward":
                good &= float(d.mean()) < 0.02
            msg = (f"max_abs {float(d.max()):.3e} (< 0.25) mean_abs {float(d.mean()):.3e}"
                   f"{' (< 0.02)' if name == 'forward' else ''}, per-row mean "
                   f"{float(row_mean.min()):.3e}-{float(row_mean.max()):.3e} (median "
                   f"{float(row_mean.median()):.3e}); mean distance from the fp32 "
                   f"reference: card {to_ref:.3e}, cpu bf16 {cpu_to_ref:.3e} (card <= "
                   f"1.25x cpu), |ref| max {float(ref[keep].abs().max()):.2f}")
        print(f"moe cuda vs cpu {name} logits [{tuple(a.shape)}], {int(keep.sum())} of "
              f"{keep.numel()} rows routed alike: {msg} {'ok' if good else 'FAIL'}",
              flush=True)
        ok &= good
    del p_gpu, p_cpu, p_ref
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(llama.LlamaConfig.mixtral_8x7b(), n_layers=4)
    params = llama.init_params(cfg, seed=SEED + 8, device="cuda")
    kw = dict(num_pages=64, page_size=64, max_seqs=8, pages_per_seq=8,
              quant_dtype="int8", device="cuda")
    runs = []
    for enabled in (True, False):
        graphs._ENABLED = enabled
        try:
            eng = Engine(params, cfg, **kw)
            rng = np.random.RandomState(SEED + 8)
            reqs = [eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))), 8)
                    for n in rng.randint(20, 200, 8)]
            stats = eng.run()
        finally:
            graphs._ENABLED = True
        runs.append(([r.generated for r in reqs], stats.captures))
        del eng
    same = runs[0][0] == runs[1][0]
    ok &= same and runs[0][1] >= 1 and runs[1][1] == 0
    print(f"moe bf16 banks, 4 layers at Mixtral width: greedy tokens graphed "
          f"({runs[0][1]} captures) equal graphs off: {same}", flush=True)
    del params
    torch.cuda.empty_cache()
    return ok


def cpu_vs_cuda_int8w_phase():
    """Phase 4, int8 weights: the 8B model cut to 2 layers with
    init_params(quantize="int8"), kernel 10 on the card against its plain
    version on the CPU with the same weights: whole-prompt prefill and the
    next decode step's logits within max 0.25 / mean 0.02 (as the bf16
    model above), argmax equal; and layer 0's int8 weights equal to the
    CPU's quantization of the same draw, byte for byte."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    p_gpu = llama.init_params(cfg, seed=SEED + 4, device="cuda", quantize="int8")
    weights_ok = _int8_weights_match_cpu(llama, cfg, SEED + 4, p_gpu)
    p_cpu = dict(layers=[{k: v.to("cpu") for k, v in lp.items()} for lp in p_gpu["layers"]],
                 **{k: p_gpu[k].to("cpu") for k in ("embed", "final_norm", "lm_head")})
    rng = np.random.RandomState(SEED + 4)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (37, 90)]
    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = llama.build_kv_caches(cfg, 16, 64, 2, 4, "int8", device=dev)
        cache, lg1 = llama.prefill_batch(params, cfg, cache, [0, 1], [[1, 2], [3, 4, 5]],
                                         prompts)
        toks = out["toks"] if "toks" in out else lg1.argmax(-1).cpu()
        out["toks"] = toks
        cache, lg2 = llama.decode_step(params, cfg, cache, [0, 1], toks)
        out[dev] = tuple(x.float().cpu() for x in (lg1, lg2))
    ok = weights_ok
    for i, name in enumerate(("prefill_batch", "decode_step")):
        a, r = out["cuda"][i], out["cpu"][i]
        d = (a - r).abs()
        agree = bool(torch.equal(a.argmax(-1), r.argmax(-1)))
        good = bool(torch.isfinite(a).all()) and float(d.max()) < 0.25 \
            and float(d.mean()) < 0.02 and agree
        print(f"int8 weights cuda vs cpu {name} logits [{tuple(a.shape)}]: max_abs "
              f"{float(d.max()):.3e} (< 0.25) mean_abs {float(d.mean()):.3e} (< 0.02), "
              f"|ref| max {float(r.abs().max()):.2f}, argmax agree {agree} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


# ---- attention sinks, ALiBi and kv_position_offset ----


def _alibi_slopes(h, dev="cuda"):
    """The ALiBi paper's slopes 2^(-8 (i + 1) / h), one per q head."""
    import torch

    return 2.0 ** (-8.0 * torch.arange(1, h + 1, device=dev, dtype=torch.float32) / h)


def _sdpa_mask(sq, sk, wl, wr, sinks=0, off=0, slopes=None):
    """SDPA's attn_mask for the port's band (prefill._band: row r at
    position r + off, -1 = unbounded): bool [sq, sk], or with ALiBi slopes
    the float bias [1, hq, sq, sk] of prefill.alibi_bias, -inf where
    masked, bf16. Only the library time uses it."""
    import torch

    from mfa_tpu_torch.kernels import prefill

    vis = prefill._band(sq, sk, wl, wr, "cuda", sinks, off)[0]
    if slopes is None:
        return vis
    bias = prefill.alibi_bias(slopes, torch.arange(sq, device="cuda") + off,
                              torch.arange(sk, device="cuda"))
    return bias.masked_fill(~vis, float("-inf")).to(torch.bfloat16)[None]


def _report(tag, ms, plain_ms, lib_ms, nbytes, flops):
    bound_ms, by = _bound(nbytes, flops)
    lib = (f"library_ms {lib_ms:.4f} (kernel / library {ms / lib_ms:.2f}x)"
           if lib_ms else "library_ms none")
    print(f"  {tag}: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}, share "
          f"{bound_ms / ms:.3f}) plain_ms {plain_ms:.4f} {lib}", flush=True)


def sinks_kernels():
    """Phase 2 for the band options: every extended kernel against its plain
    version (the limits of kernel_phase) at the 8B's heads (hq 32, hkv 8,
    d 128, bf16) and at d 256 where the kernel has it, with its time, its
    bound (the visible pairs counted with the sink columns) and SDPA with
    the equivalent bool mask or float ALiBi bias as the library time."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import (_build, backward, decode, paged,
                                       paged_prefill, prefill, varlen)

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    ok = True
    # -- kernels 1-4: sinks, ALiBi, kv_position_offset
    #        tag, b, hq, hkv, sq, sk, d, (wl, wr), sinks, off, alibi, engines
    dense = (("sinks 4, window (4095, 0), b1 s8192", 1, 32, 8, 8192, 8192, 128,
              (4095, 0), 4, 0, False, (None, "prepass", False)),
             ("sinks 4, window (1023, 0), Gemma3-4B heads b4 s2048 d256", 4, 8, 4,
              2048, 2048, 256, (1023, 0), 4, 0, False, (None, False)),
             ("ALiBi, causal, b16 s256", 16, 32, 8, 256, 256, 128, (-1, 0), 0, 0,
              True, (None,)),
             ("ALiBi, causal, b1 s4096", 1, 32, 8, 4096, 4096, 128, (-1, 0), 0, 0,
              True, (None,)),
             ("ALiBi, causal, d 256 b4 s2048", 4, 8, 4, 2048, 2048, 256, (-1, 0), 0,
              0, True, (None,)),
             ("kv_position_offset 1024, causal, b1 sq4096 sk5120", 1, 32, 8, 4096,
              5120, 128, (-1, 0), 0, 1024, False, (None, False)))
    names = {None: "default", "prepass": "bound", False: "kernel 1"}
    for tag, b, hq, hkv, sq, sk, d, (wl, wr), sinks, off, alibi, engines in dense:
        q, k, v = rn(b, hq, sq, d), rn(b, hkv, sk, d), rn(b, hkv, sk, d)
        slopes = _alibi_slopes(hq) if alibi else None
        kw = dict(window_size=(wl, wr), sink_tokens=sinks, kv_position_offset=off,
                  alibi_slopes=slopes)
        pairs = b * _visible_pairs(sq, sk, off, wl, wr, sinks)
        nbytes = 2 * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
        flops = 4 * hq * d * pairs
        ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5,
                                        wl, wr, 0.0, True, sinks, off, slopes)
        plain_ms = _time_ms(lambda: prefill._prefill_plain(
            q.float(), k.float(), v.float(), d ** -0.5, wl, wr, 0.0, False, sinks, off,
            slopes), iters=2)
        mask = _sdpa_mask(sq, sk, wl, wr, sinks, off, slopes)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
        print(f"kernels 1-4 {tag} (hq{hq} hkv{hkv} d{d} bf16; {pairs} visible pairs)",
              flush=True)
        for eng in engines:
            _build.reset_launches()
            o, lse = prefill.prefill_attention(q, k, v, return_lse=True,
                                               bound_softmax=eng, **kw)
            launched = dict(_build.launches)
            _, good = _err(o, ro, what=f"{names[eng]} {sorted(launched)} O")
            ok &= good and _lse_err(lse, rl, names[eng])
            ms = _time_ms(lambda: prefill.prefill_attention(q, k, v, bound_softmax=eng,
                                                            **kw))
            _report(f"{names[eng]} {sorted(launched)}", ms, plain_ms, lib_ms, nbytes,
                    flops)
        del q, k, v, ro, rl, mask
        torch.cuda.empty_cache()

    # -- kernel 7: sinks and ALiBi on the ragged pack
    lens = [200, 1100, 512, 300, 700, 384, 450, 450]
    n = sum(lens)
    q, k, v = rn(n, 32, 128), rn(n, 8, 128), rn(n, 8, 128)
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).int()
    slopes = _alibi_slopes(32)
    kw = dict(causal=True, window_size=(255, -1), sink_tokens=4, alibi_slopes=slopes)
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens),
                                     return_lse=True, **kw)
    ro, rl = varlen._varlen_plain(q.float(), k.float(), v.float(), cu, cu, 128 ** -0.5,
                                  255, 0, 0.0, True, 4, slopes)
    print("kernel 7 ragged pack (8 seqs of 200-1100, 4096 tokens), causal, window "
          "(255, 0), sinks 4, ALiBi", flush=True)
    _, good = _err(o, ro, what="O")
    ok &= good and _lse_err(lse, rl, "")
    pairs = sum(_visible_pairs(s, s, 0, 255, 0, 4) for s in lens)
    _report("varlen", _time_ms(lambda: varlen.varlen_attention(
        q, k, v, cu, cu, max(lens), max(lens), **kw)),
        _time_ms(lambda: varlen._varlen_plain(q.float(), k.float(), v.float(), cu, cu,
                                              128 ** -0.5, 255, 0, 0.0, False, 4,
                                              slopes), iters=2),
        None, 2 * (2 * n * 32 * 128 + 2 * n * 8 * 128), 4 * 32 * 128 * pairs)

    # -- kernel 5: sinks (window 4095) and ALiBi at lens 8192
    b, hq, hkv, S, d = 16, 32, 8, 8192, 128
    q, kc, vc = rn(b, hq, d), rn(b, hkv, S, d), rn(b, hkv, S, d)
    L = torch.full((b,), S, dtype=torch.int32, device=dev)
    for tag, wl, sinks, alibi in (("sinks 4, window 4095", 4095, 4, False),
                                  ("ALiBi, no window", -1, 0, True)):
        slopes = _alibi_slopes(hq) if alibi else None
        kw = dict(window_left=wl, sink_tokens=sinks, alibi_slopes=slopes)
        o, lse = decode.decode_attention(q, kc, vc, L, return_lse=True, **kw)
        ns, tps = decode.split_layout(S, decode.default_splits(b, hkv, S))
        po, pl = decode._decode_partials_plain(q.float(), kc.float(), vc.float(), L,
                                               d ** -0.5, ns, tps, wl, 0.0, sinks, slopes)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        print(f"kernel 5 b{b} hq{hq} hkv{hkv} S{S} d{d}, {tag}, {ns} split(s)", flush=True)
        _, good = _err(o, ro.reshape(b, hq, d), what="O")
        ok &= good and _lse_err(lse, rl.reshape(b, hq), "")
        cols = S if wl < 0 else wl + 1 + sinks
        mask = _sdpa_mask(1, S, wl, -1, sinks, S - 1, slopes)
        _report("decode (one launch)", _time_ms(lambda: decode.decode_attention(
            q, kc, vc, L, **kw)), _time_ms(lambda: decode._decode_partials_plain(
                q, kc, vc, L, d ** -0.5, ns, tps, wl, 0.0, sinks, slopes), iters=3),
            _time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)),
            2 * b * hkv * cols * d * 2 + 2 * b * hq * d * 2, 4 * b * hq * cols * d)
    del q, kc, vc, po, pl, ro
    torch.cuda.empty_cache()

    # -- kernel 6: sinks and ALiBi at lens 8192, int8 / int4 / bf16 pages, spans
    page, pps = 64, 8192 // 64 + 1
    P = b * pps + 1
    kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
             ).reshape(b, pps).int()
    for tag, quant, span, wl, sinks, alibi in (
            ("int8 pages, sinks 4, window 4095", "int8", 1, 4095, 4, False),
            ("int8 pages, ALiBi", "int8", 1, -1, 0, True),
            ("int4 pages, sinks 4, window 4095, ALiBi", "int4", 1, 4095, 4, True),
            ("bf16 pages, sinks 4, window 4095", None, 1, 4095, 4, False),
            ("int8 pages, span 4, sinks 4, window 4095, ALiBi, pos_offset 4", "int8",
             4, 4095, 4, True)):
        kp, vp, ks, vs = _kv_pages(kf, vf, quant) if quant else (kf, vf, None, None)
        slopes = _alibi_slopes(hq) if alibi else None
        q = rn(b, span, hq, d) if span > 1 else rn(b, hq, d)
        po_ = span if span > 1 else 1
        kw = dict(window_left=wl, sink_tokens=sinks, alibi_slopes=slopes,
                  quant_dtype=quant, pos_offset=po_)
        _build.reset_launches()
        o, lse = paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                       return_lse=True, **kw)
        launched = dict(_build.launches)
        ro, rl = paged._paged_plain(q.float(), kp, vp, ks, vs, L, table, d ** -0.5, wl,
                                    0.0, po_, quant, sinks, slopes)
        print(f"kernel 6 b{b} hq{hq} hkv{hkv} lens {S} d{d}, {tag} {launched}",
              flush=True)
        _, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        cols = S if wl < 0 else min(S, wl + 1 + sinks)
        _report(f"paged {tag}", _time_ms(lambda: paged.paged_attention(
            q, kp, vp, L, table, k_scales=ks, v_scales=vs, **kw)),
            _time_ms(lambda: paged._paged_plain(q, kp, vp, ks, vs, L, table, d ** -0.5,
                                                wl, 0.0, po_, quant, sinks, slopes),
                     iters=2),
            None, 2 * b * hkv * cols * _row_bytes(quant, d) + 2 * q.numel() * 2,
            4 * b * span * hq * cols * d)
    del kf, vf, kp, vp
    torch.cuda.empty_cache()

    # -- kernel 8: sinks at the engine chunk batch past 4096
    qs = [4096, 4608, 5120, 5632]
    sq = 512
    pps8 = (max(qs) + sq) // page + 1
    P8 = 4 * pps8 + 1
    kf, vf = rn(hkv, P8, page, d), rn(hkv, P8, page, d)
    kp, vp, ks, vs = _kv_pages(kf, vf, "int8")
    table = (torch.randperm(P8 - 1, generator=gen, device=dev)[: 4 * pps8] + 1
             ).reshape(4, pps8).int()
    q = rn(4, sq, hq, d)
    Lc = torch.tensor([s + sq for s in qs], dtype=torch.int32, device=dev)
    Qs = torch.tensor(qs, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window_left=4095, sink_tokens=4, quant_dtype="int8")
    o, lse = paged_prefill.paged_prefill_attention(q, kp, vp, Lc, Qs, table, k_scales=ks,
                                                   v_scales=vs, return_lse=True, **kw)
    ro, rl = paged_prefill._paged_prefill_plain(q.float(), kp, vp, ks, vs, Lc, Qs, Lc - Qs,
                                                table, d ** -0.5, 4095, 0, 0.0, "int8", 4)
    print("kernel 8 chunk batch 4 x 512 at q_start 4096-5632, int8 pages of 64, "
          "window 4095, sinks 4", flush=True)
    _, good = _err(o, ro, what="O")
    ok &= good and _lse_err(lse, rl, "")
    pairs = sum(_visible_pairs(sq, s + sq, s, 4095, 0, 4) for s in qs)
    cols = sum(min(s + sq, 4096 + sq + 4) for s in qs)
    _report("paged_prefill", _time_ms(lambda: paged_prefill.paged_prefill_attention(
        q, kp, vp, Lc, Qs, table, k_scales=ks, v_scales=vs, **kw)),
        _time_ms(lambda: paged_prefill._paged_prefill_plain(
            q.float(), kp, vp, ks, vs, Lc, Qs, Lc - Qs, table, d ** -0.5, 4095, 0, 0.0,
            "int8", 4), iters=2),
        None, 2 * cols * hkv * (d + 4) + 2 * q.numel() * 2, 4 * hq * d * pairs)
    del kf, vf, kp, vp, q
    torch.cuda.empty_cache()

    # -- kernels 11-14: ALiBi in every launch, sinks in 11, the offset in 11-13
    def bwd_plain(q, k, v, o, lse, do, wl, wr, sinks, off, slopes):
        """backward._bwd_plain one kv head and its q heads at a time (fp32
        products of 4 heads, not 32: s 8192 fits beside the rest)."""
        g = q.shape[1] // k.shape[1]
        parts = [backward._bwd_plain(
            q[:, h * g:(h + 1) * g].float(), k[:, h:h + 1].float(),
            v[:, h:h + 1].float(), o[:, h * g:(h + 1) * g].float(),
            lse[:, h * g:(h + 1) * g], do[:, h * g:(h + 1) * g].float(),
            q.shape[-1] ** -0.5, wl, wr, 0.0, sinks, off,
            None if slopes is None else slopes[h * g:(h + 1) * g])
            for h in range(k.shape[1])]
        return tuple(torch.cat(x, dim=1) for x in zip(*parts))

    #        tag, b, hq, hkv, sq, sk, d, (wl, wr), sinks, off, alibi
    bwd = (("kernel 11, sinks 4, window (4095, 0), b1 s8192 (the Mistral-7B train "
            "step's shape)", 1, 32, 8, 8192, 8192, 128, (4095, 0), 4, 0, False),
           ("kernel 11, sinks 4, window (2047, 0), b1 s4096", 1, 32, 8, 4096, 4096,
            128, (2047, 0), 4, 0, False),
           ("kernel 11, sinks 4, window (1023, 0), d 256 b2 s2048", 2, 8, 4, 2048,
            2048, 256, (1023, 0), 4, 0, False),
           ("kernels 11-13, ALiBi, causal, b4 s2048", 4, 32, 8, 2048, 2048, 128,
            (-1, 0), 0, 0, True),
           ("kernels 11-13, kv_position_offset 1024, causal, sq2048 sk3072", 1, 32, 8,
            2048, 3072, 128, (-1, 0), 0, 1024, False))
    for tag, b, hq, hkv, sq, sk, d, (wl, wr), sinks, off, alibi in bwd:
        q, k, v, do = rn(b, hq, sq, d), rn(b, hkv, sk, d), rn(b, hkv, sk, d), rn(b, hq, sq, d)
        slopes = _alibi_slopes(hq) if alibi else None
        kw = dict(window_size=(wl, wr), sink_tokens=sinks, kv_position_offset=off,
                  alibi_slopes=slopes)
        o, lse = prefill.prefill_attention(q, k, v, return_lse=True, **kw)
        ref = bwd_plain(q, k, v, o, lse, do, wl, wr, sinks, off, slopes)
        pairs = b * _visible_pairs(sq, sk, off, wl, wr, sinks)
        io = 2 * (4 * b * hq * sq * d + 2 * b * hkv * sk * d) + 2 * b * hq * sq * 4
        print(f"backward {tag} (hq{hq} hkv{hkv} d{d}; {pairs} visible pairs)", flush=True)
        splits = (True,) if sinks else (True, False)
        for fused in splits:
            _build.reset_launches()
            got = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=fused, **kw)
            launched = dict(_build.launches)
            _, good = _bwd_close(got, ref, f"{sorted(launched)}")
            ok &= good
        del got, ref
        plain_ms = _time_ms(lambda: bwd_plain(q, k, v, o, lse, do, wl, wr, sinks, off,
                                              slopes), iters=2)
        mask = _sdpa_mask(sq, sk, wl, wr, sinks, off, slopes)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=True)
        lib_ms = _time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                      retain_graph=True))
        args = backward._dense_cuda_inputs(q, k, v, o, lse, do) + (d ** -0.5, wl, wr, 0.0)
        sl2 = prefill.cuda_slopes(slopes, prefill._LOG2E, hq, dev)
        _report("bwd_fused", _time_ms(lambda: backward._launch_fused(*args, sinks, off,
                                                                     sl2)),
                plain_ms, lib_ms, io, 10 * hq * d * pairs)
        if sinks:  # the same launch and band without the sink columns: their cost
            _report("bwd_fused, sinks 0", _time_ms(lambda: backward._launch_fused(
                *args, 0, off, sl2)), plain_ms, None, io,
                10 * hq * d * b * _visible_pairs(sq, sk, off, wl, wr))
        else:
            _report("bwd_dkv", _time_ms(lambda: backward._launch_dkv(*args, off, sl2)),
                    plain_ms, None, io, 8 * hq * d * pairs)
            _report("bwd_dq", _time_ms(lambda: backward._launch_dq(*args, off, sl2)),
                    plain_ms, None, io, 6 * hq * d * pairs)
        del q, k, v, do, o, qg, kg, vg, out, mask, args
        torch.cuda.empty_cache()
    # kernel 14 with ALiBi on the ragged pack
    q, k, v, do = rn(n, 32, 128), rn(n, 8, 128), rn(n, 8, 128), rn(n, 32, 128)
    slopes = _alibi_slopes(32)
    o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens), causal=True,
                                     alibi_slopes=slopes, return_lse=True)
    got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu, causal=True,
                                        alibi_slopes=slopes)
    ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), cu, cu, 128 ** -0.5, -1, 0, 0.0, slopes)
    print("backward kernel 14, ALiBi, causal, the ragged pack", flush=True)
    _, good = _bwd_close(got, ref, "varlen_bwd_dkv + varlen_bwd_dq")
    ok &= good
    pairs = sum(s * (s + 1) // 2 for s in lens)
    _report("varlen_bwd (both launches)", _time_ms(lambda: backward.varlen_attention_bwd(
        q, k, v, o, lse, do, cu, cu, causal=True, alibi_slopes=slopes,
        max_seqlen_q=max(lens), max_seqlen_k=max(lens))),
        _time_ms(lambda: backward._varlen_bwd_plain(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(), cu, cu,
            128 ** -0.5, -1, 0, 0.0, slopes), iters=2),
        None, 2 * (4 * n * 32 * 128 + 2 * n * 8 * 128), 14 * 32 * 128 * pairs)
    torch.cuda.empty_cache()
    return ok


def engine_mistral_sinks_phase(counts, ident, state):
    """Main path, Mistral-7B (mistralai/Mistral-7B-v0.1 config.json: 32
    layers, dim 4096, 32 / 8 heads of 128, ffn 14336, sliding window 4096)
    with 4 StreamingLLM attention sinks (arXiv 2309.17453) at full width and
    depth, random bf16 weights from a seed, bf16 KV pages of 64. 8 requests
    with prompts of 4200-6000 tokens (past the window, where the sinks act)
    and 64 new tokens: run(burst=8) graphed, then graphs off (the same
    tokens), then the same engine with attn_sinks=0 (other tokens on at
    least one request: the sinks act). One 5000-token prompt's last-token
    logits, chunked (512) against whole, within a relative L2 of 0.05
    (bf16 through 32 layers; a chunk runs kernel 8 where the whole prompt
    runs kernels 2 + 3). Then chunked_engine_phase on int8 KV with prompts
    past the window; the weights stay in `state` for the train phase."""
    import gc

    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve import graphs
    from mfa_tpu_torch.serve.engine import Engine

    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.mistral_7b(), attn_sinks=4)
    params = llama.init_params(cfg, seed=SEED + 7, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    n_req, gen_tokens, L = 8, 64, cfg.n_layers
    kw = dict(num_pages=8 * 128 + 8, page_size=64, max_seqs=8, pages_per_seq=128,
              device="cuda")
    rng = np.random.RandomState(SEED)
    prompts = [list(rng.randint(0, cfg.vocab_size, int(n)))
               for n in rng.randint(4200, 6001, n_req)]

    def run(c, burst):
        eng = Engine(params, c, **kw)
        reqs = [eng.submit(p, gen_tokens) for p in prompts]
        _build.reset_launches()
        t0 = time.perf_counter()
        stats = eng.run(burst=burst)
        wall = time.perf_counter() - t0
        good = eng.sched.allocator.free_pages == kw["num_pages"] - 1
        return [list(r.generated) for r in reqs], reqs, stats, wall, good

    graphed, reqs, stats, wall, ok = run(cfg, 8)
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ok &= all(len(g) == gen_tokens for g in graphed) and stats.captures >= 1
    ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
    ok &= _wave_launches(got, L * stats.prefill_batches)
    ok &= got.get("paged", 0) == L * stats.steps
    step_tokens = stats.decode_tokens - n_req
    print(f"engine Mistral-7B sinks launches {got}: flagged = repair = {L} x "
          f"{stats.prefill_batches} waves, paged = {L} x {stats.steps} decode steps",
          flush=True)
    print(f"engine Mistral-7B sinks (attn_sinks 4, window 4096, bf16 KV, run(burst=8)):"
          f" {n_req} requests of {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"prompt tokens finished with {gen_tokens} tokens; prefill "
          f"{stats.prefill_tokens / stats.prefill_s:.1f} tok/s ({stats.prefill_tokens} "
          f"tokens in {stats.prefill_s:.3f} s), decode {_decode_rates(stats, step_tokens)}"
          f", {wall:.3f} s wall, peak memory {peak_gb:.2f} GB [{ident}]", flush=True)
    graphs._ENABLED = False  # a measurement switch: every decode step eager
    try:
        eager, _, est, _, good = run(cfg, 1)
    finally:
        graphs._ENABLED = True
    same = eager == graphed
    ok &= same and good and est.captures == 0
    print(f"engine Mistral-7B sinks, graphs off: decode {step_tokens / est.decode_s:.1f}"
          f" tok/s ({est.steps} steps, {est.decode_s:.3f} s); tokens identical to the "
          f"graphed run: {same} [{ident}]", flush=True)
    nosink, _, _, _, good = run(dataclasses.replace(cfg, attn_sinks=0), 8)
    differ = sum(a != b for a, b in zip(nosink, graphed))
    ok &= good and differ >= 1
    print(f"engine Mistral-7B with attn_sinks=0 (the same weights and prompts): "
          f"{differ} of {n_req} requests generate other tokens (>= 1: the sinks act)",
          flush=True)
    # one prompt past the window, chunked against whole
    prompt = prompts[0][:5000]
    pages = list(range(1, 80))
    whole = llama.build_kv_caches(cfg, 96, 64, 1, 128, device="cuda")
    _, ref = llama.prefill_batch(params, cfg, whole, [0], [pages], [prompt])
    cc = llama.build_kv_caches(cfg, 96, 64, 1, 128, device="cuda")
    for pos in range(0, len(prompt), 512):
        cc, logits = llama.prefill_chunk(params, cfg, cc, 0, pages, prompt[pos:pos + 512],
                                         pos, len(prompt))
    a, r = logits.float().reshape(-1), ref[0].float().reshape(-1)
    rel = float((a - r).norm() / r.norm())
    good = bool(torch.isfinite(a).all()) and rel < 0.05
    ok &= good
    print(f"engine Mistral-7B sinks: a {len(prompt)}-token prompt's last-token logits, "
          f"chunks of 512 (kernel 8) against whole (kernels 2 + 3): relative L2 "
          f"{rel:.4e} (< 0.05), max_abs {float((a - r).abs().max()):.3e}, argmax agree "
          f"{int(a.argmax()) == int(r.argmax())} {'ok' if good else 'FAIL'}", flush=True)
    del whole, cc, logits, ref
    torch.cuda.empty_cache()
    state.update(params=params, cfg=cfg)
    # long prompts past the 4096 window, where the sinks act
    ok &= chunked_engine_phase(counts, ident, state, "int8", "Mistral-7B-sinks",
                               (4200, 6001), (1024, 128))
    return ok


def cpu_vs_cuda_sinks_phase():
    """Phase 4 for the sinks: Mistral-7B at full width cut to 2 layers with a
    window of 64 and 4 sinks, seeded random weights, kernels on the card vs
    plain versions on the CPU over int8 KV pages: a wave of 150- and
    210-token prompts, a decode step, a 256-token prompt in 2 chunks of 128
    and a prefix-hit suffix chunk (_kv_stage_logits: every row past the
    window sees the sinks), logits within max 0.25 / mean 0.02."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.mistral_7b(), n_layers=2,
                              sliding_window=64, attn_sinks=4)
    p_gpu = llama.init_params(cfg, seed=SEED + 8, device="cuda")
    p_cpu = dict(layers=[{k: v.cpu() for k, v in lp.items()} for lp in p_gpu["layers"]],
                 **{k: p_gpu[k].cpu() for k in ("embed", "final_norm", "lm_head")})
    rng = np.random.RandomState(SEED + 8)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (150, 210)]
    pages = [[1, 2, 3], [4, 5, 11, 12]]
    long = list(rng.randint(0, cfg.vocab_size, 256))
    hit = long[:128] + list(rng.randint(0, cfg.vocab_size, 60))
    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        out[dev] = _kv_stage_logits(llama, cfg, params, dev, "int8", out, prompts, pages,
                                    long, hit)
    ok = True
    for i, name in enumerate(("prefill_batch", "decode_step",
                              "prefill_chunk_batch 2 x 128", "prefix-hit suffix chunk")):
        a, r = out["cuda"][i], out["cpu"][i]
        d = (a - r).abs()
        good = bool(torch.isfinite(a).all()) and float(d.max()) < 0.25 \
            and float(d.mean()) < 0.02
        print(f"cuda vs cpu Mistral-7B sinks (2 layers, window 64, 4 sinks) {name} "
              f"logits [{tuple(a.shape)}]: max_abs {float(d.max()):.3e} (< 0.25) "
              f"mean_abs {float(d.mean()):.3e} (< 0.02), argmax agree "
              f"{bool(torch.equal(a.argmax(-1), r.argmax(-1)))} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


HEAD_DIMS = (32, 80, 96, 100, 160, 192, 224)


def _stored_kv_pages(kf, vf, quant):
    """Float pages [hkv, P, page, d] -> (k, v, k_scales, v_scales) as the
    engine's cache stores them: rows at the head-dim plan's stored width
    (cache/paged_cache.py:stored_rows: int4 rows of d 80 widened to 48
    bytes), fp8 as float8_e4m3fn."""
    from mfa_tpu_torch.cache.paged_cache import stored_rows
    from mfa_tpu_torch.kernels.quant import FP8, quantize_rows

    if quant is None:
        return stored_rows(None, kf), stored_rows(None, vf), None, None
    (kq, ks), (vq, vs) = quantize_rows(kf, quant), quantize_rows(vf, quant)
    kp, vp = stored_rows(quant, kq), stored_rows(quant, vq)
    if quant == "fp8":
        kp, vp = kp.view(FP8), vp.view(FP8)
    return kp, vp, ks, vs


def head_dim_kernels():
    """Phase 2 for every head_dim up to 256: kernels 1, 4-9 and 11-14 at d
    32, 80, 96, 100, 160, 192 and 224 (run at the next instantiated D of 64,
    128, 256 on rows of the stored width; d 100's 200-byte rows through a
    zero-padded copy) against their plain versions within kernel_phase's
    limits, kernels 6 and 8 on every page format at d 80 and 96 (int4 at d
    80: rows widened to 48 bytes). Each row prints ms, bound (the true d's
    bytes and operations), share and plain ms, beside the same shape at the
    instantiated D (what a native d instantiation could at best approach)
    and SDPA's time where one SDPA call computes the same function."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.dispatch.config import head_dim_plan
    from mfa_tpu_torch.kernels import (_build, backward, blockmask, decode, paged,
                                       paged_prefill, prefill, varlen)

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    ok = True
    b, hq, hkv, s = 2, 32, 8, 1024
    lens = [512, 512, 512, 512]
    n = sum(lens)
    cu = torch.tensor([0] + lens, device=dev).cumsum(0).int()
    ids = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    ids[:, 100:356] = 0  # one 256-token image run a row
    S, page = 4096, 64
    pps = S // page + 1
    P = 16 * pps + 1
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: 16 * pps] + 1
             ).reshape(16, pps).int()
    L = torch.full((16,), S, dtype=torch.int32, device=dev)
    qs8 = [1536, 1536, 1536, 1536]
    pps8 = (max(qs8) + 512) // page + 1
    P8 = 4 * pps8 + 1
    table8 = (torch.randperm(P8 - 1, generator=gen, device=dev)[: 4 * pps8] + 1
              ).reshape(4, pps8).int()
    L8 = torch.tensor([q + 512 for q in qs8], dtype=torch.int32, device=dev)
    Q8 = torch.tensor(qs8, dtype=torch.int32, device=dev)
    fwd_pairs = b * _visible_pairs(s, s, 0, -1, 0)
    vl_pairs = sum(_visible_pairs(x, x, 0, -1, 0) for x in lens)
    pp_pairs = sum(_visible_pairs(512, q + 512, q, -1, 0) for q in qs8)
    for d in HEAD_DIMS:
        plan = head_dim_plan(d)
        D = plan.kernel_dim
        print(f"head_dim {d}: kernel D {D}, stored {plan.stored} "
              f"({'zero-padded copy' if plan.padded else 'rows as they are'}; "
              f"int4 pages {head_dim_plan(d, 'int4').stored // 2} B a row)", flush=True)

        def timed(tag, fn, fn_D, plain, lib, nbytes, flops):
            ms, ms_D = _time_ms(fn), _time_ms(fn_D)
            plain_ms = _time_ms(plain, iters=1)
            lib_ms = _time_ms(lib) if lib else None
            _report(f"{tag} d{d}", ms, plain_ms, lib_ms, nbytes, flops)
            print(f"    same shape at D {D}: {ms_D:.4f} ms (d {d} / D {D}: "
                  f"{ms / ms_D:.3f})", flush=True)

        # kernels 1 and 4: causal b2 hq32 hkv8 s1024
        q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
        qD, kD, vD = rn(b, hq, s, D), rn(b, hkv, s, D), rn(b, hkv, s, D)
        ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), d ** -0.5, -1, 0,
                                        0.0, True)
        fb = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        for mode, name in ((False, "prefill"), (None, "bound")):
            _build.reset_launches()
            o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                               bound_softmax=mode)
            good = dict(_build.launches) == {name: 1}
            _, g2 = _err(o, ro, what=f"kernel {1 if mode is False else 4} ({name}) d{d} O")
            ok &= good and g2 and _lse_err(lse, rl, name)
            timed(f"kernel {1 if mode is False else 4} ({name}), causal b{b} hq{hq} "
                  f"hkv{hkv} s{s}",
                  lambda: prefill.prefill_attention(q, k, v, causal=True,
                                                    bound_softmax=mode),
                  lambda: prefill.prefill_attention(  # kernel 4 at D too
                      qD, kD, vD, causal=True,
                      bound_softmax="prepass" if mode is None else mode),
                  lambda: prefill._prefill_plain(q.float(), k.float(), v.float(),
                                                 d ** -0.5, -1, 0, 0.0, False),
                  lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                         enable_gqa=True),
                  fb, 4 * hq * d * fwd_pairs)
        # kernel 9: the same shape with one image run a row, window 255
        _build.reset_launches()
        o = blockmask.image_block_prefill(q, k, v, ids, window_left=255)
        ref = blockmask._image_block_plain(q.float(), k.float(), v.float(), ids,
                                           d ** -0.5, 255)
        _, good = _err(o, ref, what=f"kernel 9 d{d} O")
        ok &= good and dict(_build.launches) == {"blockmask": 1}
        mask = blockmask.block_mask(ids, 255)[:, None]
        timed(f"kernel 9 (blockmask), b{b} s{s} one 256-token run, window 255",
              lambda: blockmask.image_block_prefill(q, k, v, ids, window_left=255),
              lambda: blockmask.image_block_prefill(qD, kD, vD, ids, window_left=255),
              lambda: blockmask._image_block_plain(q.float(), k.float(), v.float(), ids,
                                                   d ** -0.5, 255),
              lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                     enable_gqa=True),
              fb, 4 * hq * d * int(mask.sum()))
        del q, k, v, qD, kD, vD, ro, rl, o, ref, mask
        # kernel 7: 4 x 512 packed, causal
        q, k, v = rn(n, hq, d), rn(n, hkv, d), rn(n, hkv, d)
        qD, kD, vD = rn(n, hq, D), rn(n, hkv, D), rn(n, hkv, D)
        _build.reset_launches()
        o, lse = varlen.varlen_attention(q, k, v, cu, cu, 512, 512, causal=True,
                                         return_lse=True)
        ro, rl = varlen._varlen_plain(q.float(), k.float(), v.float(), cu, cu, d ** -0.5,
                                      -1, 0, 0.0, True)
        _, good = _err(o, ro, what=f"kernel 7 d{d} O")
        ok &= good and _lse_err(lse, rl, "varlen") and dict(_build.launches) == {"varlen": 1}
        qb, kb, vb = (x.reshape(4, 512, -1, d).transpose(1, 2) for x in (q, k, v))
        timed("kernel 7 (varlen), 4 x 512 packed, causal",
              lambda: varlen.varlen_attention(q, k, v, cu, cu, 512, 512, causal=True),
              lambda: varlen.varlen_attention(qD, kD, vD, cu, cu, 512, 512, causal=True),
              lambda: varlen._varlen_plain(q.float(), k.float(), v.float(), cu, cu,
                                           d ** -0.5, -1, 0, 0.0, False),
              lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True,
                                                     enable_gqa=True),
              2 * (2 * n * hq * d + 2 * n * hkv * d), 4 * hq * d * vl_pairs)
        # kernel 14: the same pack's backward, both launches
        do = rn(n, hq, d)
        got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu, causal=True)
        ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), cu, cu, d ** -0.5, -1, 0, 0.0)
        _, good = _bwd_close(got, ref, f"kernel 14 d{d} (varlen_bwd_dkv + _dq)")
        ok &= good
        oD, lD = varlen.varlen_attention(qD, kD, vD, cu, cu, 512, 512, causal=True,
                                         return_lse=True)
        doD = rn(n, hq, D)
        timed("kernel 14 (varlen_bwd_dkv + varlen_bwd_dq), 4 x 512 packed, causal",
              lambda: backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu,
                                                    causal=True, max_seqlen_q=512,
                                                    max_seqlen_k=512),
              lambda: backward.varlen_attention_bwd(qD, kD, vD, oD, lD, doD, cu, cu,
                                                    causal=True, max_seqlen_q=512,
                                                    max_seqlen_k=512),
              lambda: backward._varlen_bwd_plain(q.float(), k.float(), v.float(),
                                                 o.float(), lse, do.float(), cu, cu,
                                                 d ** -0.5, -1, 0, 0.0),
              None, 2 * (4 * n * hq * d + 4 * n * hkv * d), 14 * hq * d * vl_pairs)
        del q, k, v, qD, kD, vD, o, lse, ro, rl, do, got, ref, oD, lD, doD
        # kernels 11-13: causal b1 hq32 hkv8 s2048
        q, k, v, do = rn(1, hq, 2048, d), rn(1, hkv, 2048, d), rn(1, hkv, 2048, d), \
            rn(1, hq, 2048, d)
        qD, kD, vD, doD = rn(1, hq, 2048, D), rn(1, hkv, 2048, D), rn(1, hkv, 2048, D), \
            rn(1, hq, 2048, D)
        o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True)
        oD, lD = prefill.prefill_attention(qD, kD, vD, causal=True, return_lse=True)
        ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                  do.float(), d ** -0.5, -1, 0, 0.0)
        pairs = _visible_pairs(2048, 2048, 0, -1, 0)
        io = 2 * (4 * hq * 2048 * d + 4 * hkv * 2048 * d)
        for fused, names in ((True, ("bwd_fused",)), (False, ("bwd_dkv", "bwd_dq"))):
            _build.reset_launches()
            got = backward.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                               fused=fused)
            _, good = _bwd_close(got, ref, f"kernels 11-13 d{d} {sorted(_build.launches)}")
            ok &= good and sorted(_build.launches) == sorted(names)
        args = backward._dense_cuda_inputs(q, k, v, o, lse, do) + (d ** -0.5, -1, 0, 0.0)
        argsD = backward._dense_cuda_inputs(qD, kD, vD, oD, lD, doD) + (D ** -0.5, -1, 0,
                                                                       0.0)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)

        def plain():
            return backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), d ** -0.5, -1, 0, 0.0)

        for tag, launch, flops, lib in (
                ("kernel 11 (bwd_fused)", backward._launch_fused, 10, True),
                ("kernel 12 (bwd_dkv)", backward._launch_dkv, 8, False),
                ("kernel 13 (bwd_dq)", backward._launch_dq, 6, False)):
            timed(f"{tag}, causal b1 hq{hq} hkv{hkv} s2048", lambda: launch(*args),
                  lambda: launch(*argsD), plain,
                  (lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                               retain_graph=True)) if lib else None,
                  io + (2 * hq * 2048 * 4 if lib else 0), flops * hq * d * pairs)
        del q, k, v, do, qD, kD, vD, doD, o, lse, oD, lD, ref, got, args, argsD, qg, kg
        del vg, out
        # kernel 5: b16 hq32 hkv8 S4096
        q, kc, vc = rn(16, hq, d), rn(16, hkv, S, d), rn(16, hkv, S, d)
        qD, kcD, vcD = rn(16, hq, D), rn(16, hkv, S, D), rn(16, hkv, S, D)
        ns, tps = decode.split_layout(S, decode.default_splits(16, hkv, S, hq // hkv))
        _build.reset_launches()
        o, lse = decode.decode_attention(q, kc, vc, L, return_lse=True)
        po, pl = decode._decode_partials_plain(q.float(), kc.float(), vc.float(), L,
                                               d ** -0.5, ns, tps, -1, 0.0)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        _, good = _err(o, ro.reshape(16, hq, d), what=f"kernel 5 d{d} O")
        ok &= good and _lse_err(lse, rl.reshape(16, hq), "decode")
        ok &= dict(_build.launches) == {"decode": 1}
        timed(f"kernel 5 (one launch), b16 hq{hq} hkv{hkv} S{S}",
              lambda: decode.decode_attention(q, kc, vc, L),
              lambda: decode.decode_attention(qD, kcD, vcD, L),
              lambda: decode._decode_partials_plain(q, kc, vc, L, d ** -0.5, ns, tps, -1,
                                                    0.0),
              lambda: F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                     enable_gqa=True),
              2 * 16 * hkv * S * d * 2 + 2 * 16 * hq * d * 2, 4 * 16 * hq * S * d)
        del q, kc, vc, qD, kcD, vcD, po, pl, ro, rl, o
        # kernels 6 and 8: bf16 pages at every d; every format at d 80 and 96
        kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
        kfD, vfD = rn(hkv, P, page, D), rn(hkv, P, page, D)
        kf8, vf8 = rn(hkv, P8, page, d), rn(hkv, P8, page, d)
        kf8D, vf8D = rn(hkv, P8, page, D), rn(hkv, P8, page, D)
        q6, q6D = rn(16, hq, d), rn(16, hq, D)
        q8, q8D = rn(4, 512, hq, d), rn(4, 512, hq, D)
        for quant in ((None, "int8", "fp8", "int4") if d in (80, 96) else (None,)):
            kp, vp, ks, vs = _stored_kv_pages(kf, vf, quant)
            kpD, vpD, ksD, vsD = _stored_kv_pages(kfD, vfD, quant)
            # the bound's bytes a K or V row: the true d's (int4: two
            # features a byte) and its scale, not the stored width's
            rb = 2 * d if quant is None else (d // 2 if quant == "int4" else d) + 4
            stored_b = kp.shape[-1] * kp.element_size()
            kw = dict(k_scales=ks, v_scales=vs, quant_dtype=quant, pos_offset=1)
            kwD = dict(k_scales=ksD, v_scales=vsD, quant_dtype=quant, pos_offset=1)
            name6 = paged.launch_name("paged", quant)
            _build.reset_launches()
            o, lse = paged.paged_attention(q6, kp, vp, L, table, return_lse=True, **kw)
            ro, rl = paged._paged_plain(q6.float(), kp, vp, ks, vs, L, table, d ** -0.5,
                                        -1, 0.0, 1, quant)
            _, good = _err(o, ro, what=f"kernel 6 d{d} {quant or 'bf16'} pages O")
            ok &= good and _lse_err(lse, rl, name6) and _build.launches[name6] == 1
            timed(f"kernel 6 ({name6}), {quant or 'bf16'} pages ({stored_b} B rows "
                  f"stored), b16 hq{hq} hkv{hkv} lens {S}",
                  lambda: paged.paged_attention(q6, kp, vp, L, table, **kw),
                  lambda: paged.paged_attention(q6D, kpD, vpD, L, table, **kwD),
                  lambda: paged._paged_plain(q6, kp, vp, ks, vs, L, table, d ** -0.5, -1,
                                             0.0, 1, quant),
                  None, 2 * 16 * hkv * S * rb + 2 * q6.numel() * 2, 4 * 16 * hq * S * d)
            del kp, vp, kpD, vpD, o, ro
            kp, vp, ks, vs = _stored_kv_pages(kf8, vf8, quant)
            kpD, vpD, ksD, vsD = _stored_kv_pages(kf8D, vf8D, quant)
            kw = dict(k_scales=ks, v_scales=vs, quant_dtype=quant, causal=True)
            kwD = dict(k_scales=ksD, v_scales=vsD, quant_dtype=quant, causal=True)
            name8 = paged.launch_name("paged_prefill", quant)
            _build.reset_launches()
            o, lse = paged_prefill.paged_prefill_attention(q8, kp, vp, L8, Q8, table8,
                                                           return_lse=True, **kw)
            ro, rl = paged_prefill._paged_prefill_plain(
                q8.float(), kp, vp, ks, vs, L8, Q8, L8 - Q8, table8, d ** -0.5, -1, 0,
                0.0, quant)
            _, good = _err(o, ro, what=f"kernel 8 d{d} {quant or 'bf16'} pages O")
            ok &= good and _lse_err(lse, rl, name8) and _build.launches[name8] == 1
            timed(f"kernel 8 ({name8}), {quant or 'bf16'} pages, chunk batch 4 x 512 at "
                  f"q_start 1536",
                  lambda: paged_prefill.paged_prefill_attention(q8, kp, vp, L8, Q8, table8,
                                                                **kw),
                  lambda: paged_prefill.paged_prefill_attention(q8D, kpD, vpD, L8, Q8,
                                                                table8, **kwD),
                  lambda: paged_prefill._paged_prefill_plain(
                      q8, kp, vp, ks, vs, L8, Q8, L8 - Q8, table8, d ** -0.5, -1, 0, 0.0,
                      quant),
                  None, 2 * int(L8.sum()) * hkv * rb + 2 * q8.numel() * 2,
                  4 * hq * d * pp_pairs)
            del kp, vp, kpD, vpD, o, ro
        del kf, vf, kfD, vfD, kf8, vf8, kf8D, vf8D
        torch.cuda.empty_cache()
    return ok


def _stale_rows(table, lens, page, hkv, num_pages):
    """[hkv, P, page] bool: every row of a sequence's table pages at or past
    its length (each page in one sequence's table at most)."""
    import torch

    pps = table.shape[1]
    pos = (torch.arange(pps, device=table.device)[:, None] * page
           + torch.arange(page, device=table.device)[None])  # [pps, page]
    past = pos[None] >= torch.as_tensor(lens, device=table.device)[:, None, None]
    where = torch.zeros(num_pages, page, dtype=torch.bool, device=table.device)
    where[table.reshape(-1).long()] = past.reshape(-1, page)
    return where[None].expand(hkv, -1, -1)


PAGE_SIZES = (64, 12, 1)  # pages of 64 rows beside pages of 12 and of 1 row


def page_rows_kernels(records):
    """Kernels 6 and 8 on pages of 12 rows and of 1 row (boxes of 4 and of 1
    row; int8 boxes of 1 row by cp.async), beside pages of 64, and kernel 8
    above 64 q heads a kv head. Kernel 6: the 8B serve step (b16 hq32 hkv8
    d128, lens 195-300, pos_offset 1) and lens 8192 on int8 and bf16 pages,
    and with fp32 q on fp32 pages. Kernel 8: the 8B chunk batch (4 x 512
    rows at q_start 1536, the last chunk 500 rows) on int8 and bf16 pages;
    Falcon-7B's heads (hq 71 over one kv head, d 64: two head chunks, 57
    tail rows in the second) on the same positions, bf16 and int8 pages of
    64, beside hq 64 over one kv head (one chunk); fp32 q at group 71.
    Every row of a sequence's pages at or past its length holds NaN (16-bit
    and fp32 pages) or NaN scales (int8); each case against its plain
    version on the pages before the poisoning (bf16 q max 2e-2, mean 2e-3,
    LSE 1e-3 with the same -inf rows; fp32 q on fp32 pages atol = rtol =
    1e-4), timed beside its bound and its plain time. Inputs from a
    generator of its own."""
    import torch

    from mfa_tpu_torch.kernels import paged, paged_prefill

    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    F32 = torch.float32

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    ok, summary = True, []

    def check(o, lse, ro, rl, f32, what):
        if f32:
            return _err32(o, ro, what, lse, rl)
        mx, good = _err(o, ro, what=what)
        return mx, good and _lse_err(lse, rl, what)

    def report(kernel, tag, name, mx, ms, plain_ms, nbytes, flops, f32, quant):
        bound_ms, by = (_bound32(nbytes, flops, _peak32(quant)) if f32
                        else _bound(nbytes, flops))
        print(f"  ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms none bound_ms "
              f"{bound_ms:.4f} ({by}) bound share {bound_ms / ms:.3f}", flush=True)
        rec = records[name]
        rec["max_abs_err"] = max(rec.get("max_abs_err") or 0.0, mx)
        summary.append((kernel, tag, name, ms, plain_ms, bound_ms, by, mx))

    # -- kernel 6
    hq, hkv, d = 32, 8, 128
    for tag, lens_l in (("8B serve step", [300 - 7 * i for i in range(16)]),
                        ("lens 8192", [8192] * 16)):
        b = len(lens_l)
        for quant, dtype, page in (
                [(q, torch.bfloat16, pg) for q in ("int8", None) for pg in PAGE_SIZES]
                + [(None, F32, pg) for pg in (64, 12)]):
            f32 = dtype == F32
            pps = max(lens_l) // page + 1
            P = b * pps + 1
            q = rn(b, hq, d, dtype=dtype)
            kf, vf = rn(hkv, P, page, d, dtype=dtype), rn(hkv, P, page, d, dtype=dtype)
            bt = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
                  ).reshape(b, pps).to(torch.int32)
            L = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            kp, vp, ks, vs = _pages32(kf, vf, quant)
            ro, rl = paged._paged_plain(q if f32 else q.float(), kp, vp, ks, vs, L, bt,
                                        d ** -0.5, -1, 0.0, 1, quant_dtype=quant)
            plain_ms = _time_ms(lambda: paged._paged_plain(
                q, kp, vp, ks, vs, L, bt, d ** -0.5, -1, 0.0, 1, quant_dtype=quant),
                iters=3)
            _poison_rows_past(kp, vp, ks, vs, quant, bt, lens_l, page)

            def run(kp=kp, vp=vp, ks=ks, vs=vs, quant=quant, q=q, L=L, bt=bt):
                return paged.paged_attention(q, kp, vp, L, bt, k_scales=ks, v_scales=vs,
                                             pos_offset=1, quant_dtype=quant,
                                             return_lse=True)

            o, lse = run()
            fmt = quant or ("fp32" if f32 else "bf16")
            name = paged.launch_name("paged", quant, 1, dtype)
            what = f"paged {fmt} pages of {page} rows, {tag}"
            print(f"{what}: b={b} hq={hq} hkv={hkv} d={d} lens "
                  f"{min(lens_l)}..{max(lens_l)} pos_offset 1, splits "
                  f"{paged.split_plan(b, hkv, pps, page)[0]}, box rows "
                  f"{math.gcd(page, 64)}", flush=True)
            mx, good = check(o, lse, ro, rl, f32, "O")
            ok &= good
            ms = _time_ms(run)
            rows = sum(lens_l) * hkv
            row_b = _row_bytes32(quant, d) if f32 else _row_bytes(quant, d)
            nbytes = (2 * rows * row_b + sum(-(-n // page) for n in lens_l) * 4
                      + 2 * b * hq * d * q.element_size() + b * hq * 4)
            report(6, tag, name, mx, ms, plain_ms, nbytes, 4 * hq // hkv * rows * d,
                   f32, quant)
            del q, kf, vf, kp, vp, ks, vs, o, ro
        torch.cuda.empty_cache()

    # -- kernel 8
    q_start, q_lens = [1536] * 4, [512, 512, 512, 500]
    lens = [s_ + n for s_, n in zip(q_start, q_lens)]
    b, sq = len(lens), max(q_lens)
    L, QS, QL = (torch.tensor(x, dtype=torch.int32, device="cuda")
                 for x in (lens, q_start, q_lens))
    dead = torch.arange(sq, device="cuda")[None] >= QL[:, None]
    cases = ([("8B chunk batch", 32, 8, 128, q, torch.bfloat16, pg)
              for q in ("int8", None) for pg in PAGE_SIZES]
             + [("Falcon-7B heads", 71, 1, 64, q, torch.bfloat16, 64) for q in (None, "int8")]
             + [("hq 64 over one kv head", 64, 1, 64, q, torch.bfloat16, 64)
                for q in (None, "int8")]
             + [("Falcon-7B heads", 71, 1, 64, None, F32, 64)])
    for tag, hq, hkv, d, quant, dtype, page in cases:
        f32 = dtype == F32
        pps = max(lens) // page + 1
        P = b * pps + 1
        q = rn(b, sq, hq, d, dtype=dtype)
        kf, vf = rn(hkv, P, page, d, dtype=dtype), rn(hkv, P, page, d, dtype=dtype)
        table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
                 ).reshape(b, pps).to(torch.int32)
        kp, vp, ks, vs = _pages32(kf, vf, quant)
        ro, rl = paged_prefill._paged_prefill_plain(
            q if f32 else q.float(), kp, vp, ks, vs, L, QS, QL, table, d ** -0.5, -1, 0,
            0.0, quant_dtype=quant)
        plain_ms = _time_ms(lambda: paged_prefill._paged_prefill_plain(
            q, kp, vp, ks, vs, L, QS, QL, table, d ** -0.5, -1, 0, 0.0, quant_dtype=quant),
            iters=3)
        _poison_rows_past(kp, vp, ks, vs, quant, table, lens, page)

        def run(lse=False, kp=kp, vp=vp, ks=ks, vs=vs, quant=quant, q=q, table=table):
            return paged_prefill.paged_prefill_attention(
                q, kp, vp, L, QS, table, q_lens=QL, k_scales=ks, v_scales=vs,
                causal=True, quant_dtype=quant, return_lse=lse)

        o, lse = run(True)
        fmt = quant or ("fp32" if f32 else "bf16")
        name = paged.launch_name("paged_prefill", quant, 1, dtype)
        what = f"paged_prefill {fmt} pages of {page} rows, {tag}"
        print(f"{what}: {b} x {sq} rows at q_start {q_start}, q_lens {q_lens}, "
              f"hq={hq} hkv={hkv} (group {hq // hkv}, head chunks "
              f"{-(-(hq // hkv) // 64)}) d={d}, box rows {math.gcd(page, 128 if d <= 128 else 64)}",
              flush=True)
        mx, good = check(o, lse, ro, rl, f32, "O")
        zero = bool((o[dead] == 0).all()) and bool(torch.isneginf(
            lse.transpose(1, 2)[dead]).all())
        print(f"  rows past q_lens: O = 0 and LSE = -inf {zero}", flush=True)
        ok &= good and zero
        ms = _time_ms(run)
        row_b = _row_bytes32(quant, d) if f32 else _row_bytes(quant, d)
        nbytes = (2 * sum(lens) * hkv * row_b + sum(-(-n // page) for n in lens) * 4
                  + 2 * b * sq * hq * d * q.element_size())
        pairs = sum(_visible_pairs(n, n_k, s_, -1, 0)
                    for s_, n, n_k in zip(q_start, q_lens, lens))
        report(8, tag, name, mx, ms, plain_ms, nbytes, 4 * hq * pairs * d, f32, quant)
        del q, kf, vf, kp, vp, ks, vs, o, ro
        torch.cuda.empty_cache()
    print("page_rows_kernels summary (kernel, shape, launch name, ms, plain_ms, "
          "bound_ms, bound_by, max_abs_err):", flush=True)
    for row in summary:
        print("  " + json.dumps(row), flush=True)
    return ok


def decode_groups():
    """Phase 2 for kernel 5 with any q-per-kv group: groups 16 and 32 (b16
    hq32 hkv2 and hkv1, S8192, d128, bf16; before this, refused above 8),
    the 16-row blocks, against the plain version, the bound and SDPA."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import _build, decode

    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    ok = True
    b, hq, S, d = 16, 32, 8192, 128
    L = torch.full((b,), S, dtype=torch.int32, device=dev)
    for hkv in (2, 1):
        g = hq // hkv
        q = torch.randn(b, hq, d, generator=gen, device=dev).to(bf)
        kc, vc = (torch.randn(b, hkv, S, d, generator=gen, device=dev).to(bf)
                  for _ in range(2))
        ns, tps = decode.split_layout(S, decode.default_splits(b, hkv, S, g))
        partials = (torch.empty((b, hkv, ns, g, d), device=dev),
                    torch.empty((b, hkv, ns, g), device=dev))
        _build.reset_launches()
        o, lse = decode._decode_cuda(q, kc, vc, L, d ** -0.5, ns, tps, -1, 0.0,
                                     partials=partials)
        launched = dict(_build.launches)
        po, pl = decode._decode_partials_plain(q.float(), kc.float(), vc.float(), L,
                                               d ** -0.5, ns, tps, -1, 0.0)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        print(f"kernel 5 group {g}: b{b} hq{hq} hkv{hkv} S{S} d{d}, "
              f"{decode.row_blocks(g)} row blocks, {ns} split(s) {launched}", flush=True)
        _, good = _err(o, ro.reshape(b, hq, d), what="O")
        ok &= good and _lse_err(lse, rl.reshape(b, hq), "")
        ok &= launched == {"decode": 1}
        if ns > 1:
            _merge_bits(o, lse, partials, bf)
        _report(f"decode (one launch), group {g}", _time_ms(lambda: decode.decode_attention(
            q, kc, vc, L)), _time_ms(lambda: decode._decode_partials_plain(
                q, kc, vc, L, d ** -0.5, ns, tps, -1, 0.0), iters=1),
            _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                            enable_gqa=True)),
            2 * b * hkv * S * d * 2 + 2 * b * hq * d * 2, 4 * b * hq * S * d)
        del q, kc, vc, po, pl, ro, o, partials
        torch.cuda.empty_cache()
    return ok


def engine_danube_phase(counts, ident, state):
    """Main path, H2O-Danube-1.8B (h2oai/h2o-danube-1.8b-base config.json:
    24 layers, dim 2560, 32 / 8 heads of 80, ffn 6912, window 4096) at full
    width and depth, random bf16 weights from a seed, int8 KV pages of 64:
    head_dim 80 runs every attention kernel at D 128 on 160-byte bf16 and
    80-byte int8 rows. The 8B engine's traffic (16 prompts of 200-256
    tokens, 32 new) graphed, then graphs off (the same tokens); KV bytes
    per token of bf16, int8 and int4 pools (int4 rows widened to 48 bytes)
    against 128-wide rows; then chunked_engine_phase on int8 and int4 KV.
    The weights stay in `state` for the train phase."""
    import gc

    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve import graphs
    from mfa_tpu_torch.serve.engine import Engine

    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.LlamaConfig.h2o_danube_1_8b()
    params = llama.init_params(cfg, seed=SEED + 9, device="cuda")
    n_mat = sum(p.numel() for p in llama.param_tensors(params) if p.dim() == 2) \
        - params["embed"].numel()
    torch.cuda.reset_peak_memory_stats()
    n_req, gen_tokens, L = 16, 32, cfg.n_layers
    kw = dict(num_pages=128, page_size=64, max_seqs=16, pages_per_seq=8,
              quant_dtype="int8", device="cuda")
    rng = np.random.RandomState(SEED)
    prompts = [list(rng.randint(0, cfg.vocab_size, int(n)))
               for n in rng.randint(200, 257, n_req)]

    def run():
        eng = Engine(params, cfg, **kw)
        reqs = [eng.submit(p, gen_tokens) for p in prompts]
        _build.reset_launches()
        stats = eng.run()
        good = eng.sched.allocator.free_pages == kw["num_pages"] - 1
        return [list(r.generated) for r in reqs], reqs, stats, good, eng

    graphed, reqs, stats, ok, eng = run()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ok &= all(len(g) == gen_tokens for g in graphed) and stats.captures >= 1
    ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
    ok &= _wave_launches(got, L * stats.prefill_batches, head_dim=cfg.head_dim)
    ok &= got.get("paged", 0) == L * stats.steps
    step_tokens = stats.decode_tokens - n_req
    print(f"engine H2O-Danube-1.8B launches {got}: bound = {L} x "
          f"{stats.prefill_batches} waves (head_dim 80: the bound prepass, as "
          f"mfa_tpu selects it), paged = {L} x {stats.steps} decode steps", flush=True)
    print(f"engine H2O-Danube-1.8B (head_dim 80, int8 KV, {n_mat} matmul weights): "
          f"{n_req} requests of {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"prompt tokens finished with {gen_tokens} tokens; prefill "
          f"{stats.prefill_tokens / stats.prefill_s:.1f} tok/s ({stats.prefill_tokens} "
          f"tokens in {stats.prefill_s:.3f} s), decode {_decode_rates(stats, step_tokens)}"
          f", peak memory {peak_gb:.2f} GB [{ident}]", flush=True)
    kvb = {"int8": _kv_bytes_per_token(eng.cache)}
    del eng
    graphs._ENABLED = False  # a measurement switch: every decode step eager
    try:
        eager, _, est, good, eng = run()
    finally:
        graphs._ENABLED = True
    del eng
    same = eager == graphed
    ok &= same and good and est.captures == 0
    print(f"engine H2O-Danube-1.8B, graphs off: decode {step_tokens / est.decode_s:.1f}"
          f" tok/s ({est.steps} steps, {est.decode_s:.3f} s); tokens identical to the "
          f"graphed run: {same} [{ident}]", flush=True)
    for quant in (None, "int4"):
        c = llama.build_kv_caches(cfg, 8, 64, 1, 1, quant, device="cuda")
        kvb[quant or "bf16"] = _kv_bytes_per_token(c)
        del c
    want = {"bf16": 61440, "int8": 32256, "int4": 19968}
    wide = {"bf16": 2 * L * cfg.n_kv_heads * 128 * 2,
            "int8": 2 * L * cfg.n_kv_heads * (128 + 4)}
    good = all(kvb[f] == want[f] for f in want)
    ok &= good
    print(f"engine H2O-Danube-1.8B KV bytes per token: "
          + ", ".join(f"{f} {kvb[f]:.0f}" for f in ("bf16", "int8", "int4"))
          + f" (stored widths 80 / 80 / 48 B a row; expected {want}) against "
          f"128-wide rows {wide} {'ok' if good else 'FAIL'}", flush=True)
    torch.cuda.empty_cache()
    for quant in ("int8", "int4"):
        state.update(params=params, cfg=cfg)
        ok &= chunked_engine_phase(counts, ident, state, quant, "H2O-Danube-1.8B")
    state.update(params=params, cfg=cfg)
    return ok


def cpu_vs_cuda_danube_phase():
    """Phase 4 for head_dim 80: H2O-Danube-1.8B at full width cut to 2 layers
    with a window of 64, seeded random weights, kernels on the card vs plain
    versions on the CPU over int8 and int4 KV pages (int4 rows widened to
    48 bytes; the CPU reads the card's int4 payloads, _device_pair_logits):
    a prompt wave, a decode step, a 256-token prompt in 2 chunks of 128 and
    a prefix-hit suffix chunk (_kv_stage_logits), logits within max 0.25 /
    mean 0.02."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.h2o_danube_1_8b(), n_layers=2,
                              sliding_window=64)
    p_gpu = llama.init_params(cfg, seed=SEED + 10, device="cuda")
    p_cpu = dict(layers=[{k: v.cpu() for k, v in lp.items()} for lp in p_gpu["layers"]],
                 **{k: p_gpu[k].cpu() for k in ("embed", "final_norm", "lm_head")})
    rng = np.random.RandomState(SEED + 10)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (150, 210)]
    pages = [[1, 2, 3], [4, 5, 11, 12]]
    long = list(rng.randint(0, cfg.vocab_size, 256))
    hit = long[:128] + list(rng.randint(0, cfg.vocab_size, 60))
    ok = True
    for quant in ("int8", "int4"):
        out = _device_pair_logits(llama, cfg, p_gpu, p_cpu, quant, prompts, pages,
                                  long, hit)
        tag = f"{quant} KV" + (", the card's payloads" if quant == "int4" else "")
        for i, name in enumerate(("prefill_batch", "decode_step",
                                  "prefill_chunk_batch 2 x 128",
                                  "prefix-hit suffix chunk")):
            a, r = out["cuda"][i], out["cpu"][i]
            d = (a - r).abs()
            good = bool(torch.isfinite(a).all()) and float(d.max()) < 0.25 \
                and float(d.mean()) < 0.02
            print(f"cuda vs cpu H2O-Danube-1.8B (2 layers, head_dim 80, window 64) "
                  f"{name} ({tag}) logits [{tuple(a.shape)}]: max_abs "
                  f"{float(d.max()):.3e} (< 0.25) mean_abs {float(d.mean()):.3e} "
                  f"(< 0.02), argmax agree {bool(torch.equal(a.argmax(-1), r.argmax(-1)))}"
                  f" {'ok' if good else 'FAIL'}", flush=True)
            ok &= good
    return ok


def _cache_bytes(card, cpu, quant):
    """Where a card-written page pool differs from the CPU's: (differing
    payload elements, elements compared, differing scales, scales). int4
    counts nibble values (a byte holds two features), fp8 bytes."""
    import torch

    from mfa_tpu_torch.kernels.quant import page_values

    pay = diff = sc = n_sc = 0
    for f in ("k", "v"):
        a = page_values(getattr(card, f + "_pages").cpu(), quant)
        b = page_values(getattr(cpu, f + "_pages"), quant)
        if a.dtype.itemsize == 1:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        else:
            a, b = a.view(torch.int16), b.view(torch.int16)
        diff += int((a != b).sum())
        pay += a.numel()
        if quant is not None:
            x, y = getattr(card, f + "_scales").cpu(), getattr(cpu, f + "_scales")
            sc += int((x != y).sum())
            n_sc += x.numel()
    return diff, pay, sc, n_sc


def layer_cache_phase(counts, ident):
    """The per-layer paged KV cache (cache/paged_cache.py: create_cache,
    write_prompt, map_page, append_token) under kernel 6, as a library user
    keeps one layer's cache: one Llama-3-8B attention layer (hq 32, hkv 8, d
    128) and H2O-Danube-1.8B's (hq 32, hkv 8, d 80), 16 sequences with seeded
    prompts of 200-4000 tokens on pages of 64 and of 16, in bf16, int8, fp8
    and int4 KV. Every prompt goes in by write_prompt on the pages it needs;
    then 32 decode steps, each mapping a page where a sequence crosses into
    one, appending a token to every sequence and running paged_attention,
    whose output is held against kernel 6's plain version on the same pages
    (max 2e-2, mean 2e-3: kv_format_kernels' limits). After the last step
    the card's pages and scales are compared with those the CPU writes from
    the same K/V (the counts of differing payload elements and scales are
    printed; the limit is none differing). Times one step's append_token
    (with a 64-byte reset of the lengths, so the timed appends overwrite
    one row) and kernel 6 per format."""
    import numpy as np
    import torch

    from mfa_tpu_torch.cache import paged_cache as pc
    from mfa_tpu_torch.kernels import _build, paged

    ok = True
    n_seq, steps, hq, hkv = 16, 32, 32, 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    rng = np.random.RandomState(SEED + 61)
    lens = [int(n) for n in rng.randint(200, 4001, n_seq)]
    for model, d in (("Llama-3-8B", 128), ("H2O-Danube-1.8B", 80)):
        scale = d ** -0.5

        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

        prompts = [(rn(n, hkv, d), rn(n, hkv, d)) for n in lens]
        new_k, new_v, qs = rn(steps, n_seq, hkv, d), rn(steps, n_seq, hkv, d), \
            rn(steps, n_seq, hq, d)
        for page in (64, 16):
            pps = -(-(max(lens) + steps) // page)
            num_pages = sum(-(-(n + steps) // page) for n in lens) + 1
            for quant in (None, "int8", "fp8", "int4"):
                fmt = quant or "bf16"
                kw = dict(num_pages=num_pages, page_size=page, num_kv_heads=hkv,
                          head_dim=d, max_seqs=n_seq, pages_per_seq=pps,
                          quant_dtype=quant)
                cache = pc.create_cache(**kw, device="cuda")
                host = pc.create_cache(**kw, device="cpu")
                alloc = pc.PageAllocator(num_pages)
                held = [alloc.alloc(-(-n // page)) for n in lens]
                for c in (cache, host):
                    for i, (k, v) in enumerate(prompts):
                        pc.write_prompt(c, i, held[i], k.to(c.lengths.device),
                                        v.to(c.lengths.device))
                tokens, slots = list(lens), list(range(n_seq))
                worst, mean_worst, maps = 0.0, 0.0, []
                _build.reset_launches()
                for t in range(steps):
                    for i in slots:  # a page for each row that starts one
                        if tokens[i] % page == 0:
                            pid = alloc.alloc(1)[0]
                            maps.append((i, tokens[i] // page, pid))
                            for c in (cache, host):
                                pc.map_page(c, i, tokens[i] // page, pid)
                    pc.append_token(cache, slots, new_k[t], new_v[t])
                    pc.append_token(host, slots, new_k[t].cpu(), new_v[t].cpu())
                    tokens = [n + 1 for n in tokens]
                    o = paged.paged_attention(
                        qs[t], cache.k_pages, cache.v_pages, cache.lengths,
                        cache.block_tables, k_scales=cache.k_scales,
                        v_scales=cache.v_scales, quant_dtype=quant)
                    ro, _ = paged._paged_plain(
                        qs[t].float(), cache.k_pages, cache.v_pages,
                        cache.k_scales, cache.v_scales, cache.lengths,
                        cache.block_tables, scale, -1, 0.0, 0, quant_dtype=quant)
                    diff = (o.float() - ro.float()).abs()
                    good = bool(torch.isfinite(o.float()).all())
                    worst = max(worst, float(diff.max()))
                    mean_worst = max(mean_worst, float(diff.mean()))
                    ok &= good
                got = dict(_build.launches)
                counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
                name = paged.launch_name("paged", quant)
                splits = paged.split_plan(n_seq, hkv, pps, page)[0]
                want = {name: steps}  # one launch at any split count
                good = worst < 2e-2 and mean_worst < 2e-3 and got == want \
                    and cache.lengths.tolist() == tokens
                ok &= good
                diff, pay, sdiff, n_sc = _cache_bytes(cache, host, quant)
                same = diff == 0 and sdiff == 0
                ok &= same
                print(f"layer_cache {model} d{d} {fmt} KV, pages of {page}: "
                      f"{n_seq} prompts of {min(lens)}-{max(lens)} tokens, "
                      f"{steps} steps ({len(maps)} pages mapped), splits {splits}; "
                      f"kernel 6 vs plain: max_abs_err {worst:.3e} (< 2e-2) worst "
                      f"step mean {mean_worst:.3e} (< 2e-3); launches {got}; card "
                      f"vs CPU writes: {diff} of {pay} payload "
                      f"{'nibbles' if quant == 'int4' else 'elements'} and {sdiff} "
                      f"of {n_sc} scales differ (limit 0) "
                      f"{'ok' if good and same else 'FAIL'}", flush=True)
                if page == 64:
                    base = cache.lengths.clone()
                    last_k, last_v = new_k[-1], new_v[-1]

                    def append():
                        cache.lengths.copy_(base)
                        pc.append_token(cache, slots, last_k, last_v)

                    app_ms = _time_ms(append)  # after the counts were read
                    cache.lengths.copy_(base)
                    ms = _time_ms(lambda: paged.paged_attention(
                        qs[-1], cache.k_pages, cache.v_pages, cache.lengths,
                        cache.block_tables, k_scales=cache.k_scales,
                        v_scales=cache.v_scales, quant_dtype=quant))
                    plain_ms = _time_ms(lambda: paged._paged_plain(
                        qs[-1], cache.k_pages, cache.v_pages, cache.k_scales,
                        cache.v_scales, cache.lengths, cache.block_tables, scale,
                        -1, 0.0, 0, quant_dtype=quant), iters=3)
                    rows = sum(tokens) * hkv
                    bound_ms, by = _bound(
                        2 * rows * _row_bytes(quant, d) + n_seq * pps * 4
                        + 2 * n_seq * hq * d * 2, 4 * hq * sum(tokens) * d)
                    print(f"  layer_cache {model} d{d} {fmt} pages of 64, step at "
                          f"{sum(tokens)} tokens: append_token {app_ms:.4f} ms, "
                          f"kernel 6 {ms:.4f} ms, plain_ms {plain_ms:.4f} bound_ms "
                          f"{bound_ms:.4f} ({by}) share {bound_ms / ms:.3f} "
                          f"[{ident}]", flush=True)
                del cache, host
                torch.cuda.empty_cache()
        del prompts, new_k, new_v, qs
    return ok


def instruments_phase(ident):
    """The port's instruments on the card (not the main path): the peak
    table's entries for this card (utils/timing.py); scan_timeit of kernel
    6 at the 8B serve step (int8 pages of 64, b16 hq32 hkv8, lens about
    300, pos_offset 1), chained through timing.chain, beside _time_ms of
    the same call (fails only when it is <= 0 or more than 2x off: a broken
    harness); profiling.trace around one eager call of kernel 6 inside
    annotate("paged_decode"), the Chrome trace holding the annotation and,
    where the trace has device events, the kernel's symbol (splitkv_kernel);
    and the native runtime's build seconds."""
    import os

    import torch

    from mfa_tpu_torch.kernels import paged
    from mfa_tpu_torch.kernels.quant import quantize_rows
    from mfa_tpu_torch.utils import native, profiling, timing

    ok = True
    bw, peak = timing.device_bw(), timing.device_peak_flops()
    ok &= bw == timing.PEAK_BYTES and peak == timing.PEAK_BF16_FLOPS
    print(f"instruments: device_bw {bw:.3e} B/s, device_peak_flops {peak:.3e} "
          f"FLOP/s for {torch.cuda.get_device_name()} [{ident}]", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, hq, hkv, d, page = 16, 32, 8, 128, 64
    lens_l = [300 - 7 * i for i in range(b)]
    pps = max(lens_l) // page + 1
    P = b * pps + 1

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = rn(b, hq, d)
    kp, ks = quantize_rows(rn(hkv, P, page, d), "int8")
    vp, vs = quantize_rows(rn(hkv, P, page, d), "int8")
    bt = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
          ).reshape(b, pps).to(torch.int32)
    L = torch.tensor(lens_l, dtype=torch.int32, device="cuda")

    def call(qc):
        return paged.paged_attention(qc, kp, vp, L, bt, k_scales=ks,
                                     v_scales=vs, pos_offset=1)

    scan_ms = timing.scan_timeit(lambda qc: timing.chain(qc, call(qc)), q) * 1e3
    ms = _time_ms(lambda: call(q))
    ratio = scan_ms / ms
    ok &= scan_ms > 0 and 0.5 <= ratio <= 2.0
    print(f"instruments: scan_timeit of kernel 6 at the 8B serve step, chained "
          f"(a CUDA graph of N and 2N steps): {scan_ms:.4f} ms an iteration; "
          f"_time_ms of the same call {ms:.4f} ms; ratio {ratio:.3f} "
          f"(limit 0.5-2) [{ident}]", flush=True)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "traces")
    call(q)
    torch.cuda.synchronize()
    with profiling.trace(out_dir) as prof:
        with profiling.annotate("paged_decode"):
            call(q)
    with open(prof.trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    annotated = any(e.get("name") == "paged_decode" for e in events)
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    symbol = any("splitkv_kernel" in k for k in kernels)
    ok &= annotated and (symbol or not kernels)
    print(f"instruments: trace {os.path.relpath(prof.trace_path)}: annotation "
          f"'paged_decode' {'present' if annotated else 'MISSING'}; "
          + (f"{len(kernels)} device kernel events, splitkv_kernel "
             f"{'present' if symbol else 'MISSING'}" if kernels else
             "NO device events (CUPTI recorded no kernel)"), flush=True)

    secs = native.build_seconds
    ok &= secs is not None
    print(f"instruments: native runtime (g++) built in "
          f"{'n/a' if secs is None else f'{secs:.2f} s'} (the scheduler's host "
          f"time on it: server_8b)", flush=True)
    return ok


def _scheduler_host_us(allocator_cls, lens, gen_tokens, rounds=20):
    """Host microseconds of the scheduler bookkeeping of part 2's serve
    (max_seqs 16, pages of 64, 8 pages a sequence, 128 pages) with its
    allocator replaced by `allocator_cls`: (admitting the prompts of `lens`
    at once, one decode step's ensure_decode_pages over every request,
    finishing them all), each the mean over `rounds` lifecycles of
    `gen_tokens` steps. Admission goes through native.admit either way."""
    from mfa_tpu_torch.serve.scheduler import Request, Scheduler

    admit_s = step_s = finish_s = 0.0
    for _ in range(rounds):
        s = Scheduler(max_seqs=16, pages_per_seq=8, page_size=64, num_pages=128)
        s.allocator = allocator_cls(128)
        for i, n in enumerate(lens):
            s.submit(Request(i, [0] * n, gen_tokens))
        t0 = time.perf_counter()
        reqs = s.admit()
        admit_s += time.perf_counter() - t0
        for _ in range(gen_tokens):
            t0 = time.perf_counter()
            for r in reqs:
                s.ensure_decode_pages(r, 1)
            step_s += time.perf_counter() - t0
            for r in reqs:
                r.generated.append(1)
        t0 = time.perf_counter()
        for r in reqs:
            s.finish(r)
        finish_s += time.perf_counter() - t0
    return (admit_s / rounds * 1e6, step_s / (rounds * gen_tokens) * 1e6,
            finish_s / rounds * 1e6)


# ---- the sharding layer (shard/, serve/multihost.py): SPMD ranks ----------
#
# Every rank of these phases is a process of one card: NCCL runs only at
# world size 1 there (it refuses two ranks on one GPU), so the parent runs
# the model-1 engine over NCCL, and 2-4 spawned ranks time-share the card
# over gloo (shard/launch.py), staging their collectives through host
# memory. Their rates are not multi-GPU rates. The rank functions below run
# in the spawned ranks (which import this file as a module) and return
# numbers and launch counts; the parent checks and prints them.

SHARD_RANKS = 4


def _shard_ranks(shard):
    """The phases' gloo ranks, spawned once (the kernels are built)."""
    from mfa_tpu_torch.shard.launch import Ranks

    if "ranks" not in shard:
        shard["ranks"] = Ranks(SHARD_RANKS, device="cuda", backend="gloo",
                               timeout_s=900)
    return shard["ranks"]


def _rates(shard, n):
    """What the phases' rates are: n ranks sharing this card over gloo, or
    shard["label"] where a caller gave the phases ranks of their own."""
    return shard.get("label", "{n} ranks time-sharing one card over gloo, "
                     "not a multi-GPU rate").format(n=n)


def _close_ranks(shard):
    ranks = shard.pop("ranks", None)
    if ranks is not None:
        ranks.close()


def _diff(got, ref):
    """(max |a - r|, mean |a - r|, max |r|, mean |r|, relative L2, finite)."""
    import torch

    a, r = got.float(), ref.float()
    d = (a - r).abs()
    return (float(d.max()), float(d.mean()), float(r.abs().max()),
            float(r.abs().mean()), float((a - r).norm() / r.norm().clamp_min(1e-30)),
            bool(torch.isfinite(a).all()))


def _tp_prompts(cfg):
    """engine_phase's traffic: 16 prompts of 200-256 tokens."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    return [list(rng.randint(0, cfg.vocab_size, int(n)))
            for n in rng.randint(200, 257, 16)]


def _forced_logits(llama, cfg, params, prompts, mesh, tokens):
    """Teacher-forced logits [32, 16, vocab] (fp32, int8 KV): the prefill's
    last position, then 31 decode steps, step j fed tokens[i][j] in row
    i, so a rank and the unsharded model score the same sequences."""
    import torch

    cache = llama.build_kv_caches(cfg, 128, 64, 16, 8, "int8", device="cuda",
                                  mesh=mesh)
    n = len(prompts)
    pages = [list(range(1 + 5 * i, 6 + 5 * i)) for i in range(n)]
    cache, logits = llama.prefill_batch(params, cfg, cache, list(range(n)),
                                        pages, prompts, mesh=mesh)
    out = [logits.float()]
    for j in range(len(tokens[0]) - 1):
        step = torch.tensor([t[j] for t in tokens], device="cuda")
        cache, logits = llama.decode_step(params, cfg, cache, list(range(n)),
                                          step, mesh=mesh)
        out.append(logits.float())
    return torch.stack(out)


def _tp_engine_rank(quantize, forced):
    """A rank of the {"model": 2} engine: its shard of Llama-3-8B (seeded
    like engine_phase's weights), int8 KV, engine_phase's traffic; then
    _forced_logits on `forced` (the unsharded engine's tokens)."""
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine
    from mfa_tpu_torch.shard.mesh import axis_index, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh({"model": 2})
    if mesh.get_coordinate() is None:
        return None
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=SEED, device="cuda", quantize=quantize,
                               mesh=mesh)
    prompts = _tp_prompts(cfg)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                 pages_per_seq=8, quant_dtype="int8", device="cuda", mesh=mesh)
    reqs = [eng.submit(p, 32) for p in prompts]
    _build.reset_launches()
    stats = eng.run()
    launches = dict(_build.launches)
    logits = _forced_logits(llama, cfg, params, prompts, mesh, forced)
    first = axis_index(mesh, "model") == 0
    out = dict(tokens=[list(r.generated) for r in reqs], launches=launches,
               prefill_tps=stats.prefill_tokens / stats.prefill_s,
               decode_tps=(stats.decode_tokens - len(reqs)) / stats.decode_s,
               captures=stats.captures, steps=stats.steps,
               waves=stats.prefill_batches,
               kv_heads=int(eng.cache.k_pages.shape[0]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               logits=logits.half().cpu().numpy() if first else None)
    del eng, params
    torch.cuda.empty_cache()
    return out


def _unsharded_reference(llama, cfg, params, prompts):
    """The unsharded engine's tokens on engine_phase's traffic (int8 KV,
    graphs on) and _forced_logits on them, on the card, in this process."""
    from mfa_tpu_torch.serve.engine import Engine

    eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                 pages_per_seq=8, quant_dtype="int8", device="cuda")
    reqs = [eng.submit(p, 32) for p in prompts]
    eng.run()
    tokens = [list(r.generated) for r in reqs]
    del eng
    return tokens, _forced_logits(llama, cfg, params, prompts, None, tokens).cpu()


def _first_divergence(tokens, want):
    """Per row, the index of the first token that differs (its length when
    none does)."""
    return [next((j for j, (a, b) in enumerate(zip(t, w)) if a != b), len(t))
            for t, w in zip(tokens, want)]


def tp_engine_phase(counts, ident, state, shard):
    """tp_engine_8b: Llama-3-8B at full width and depth behind
    Engine(mesh=) with int8 KV and engine_phase's traffic. (a) {"model":
    1} over NCCL in this process, graphs on: tokens identical to the
    unsharded engine's. (b) {"model": 2}, two ranks time-sharing the card
    over gloo (graphs off: gloo cannot be captured): the ranks' tokens
    identical, and at each of 32 steps teacher-forced on the unsharded
    engine's tokens (the prefill's last position and 31 decode steps) the
    logits within relative L2 0.05 of the unsharded model's. (c) (b) on
    int8 weights (kernel 10 on the ranks' N / 2 and K / 2 slices), held to
    the unsharded int8 model and engine."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine
    from mfa_tpu_torch.shard.mesh import make_mesh

    params, cfg, want = state["params"], state["cfg"], state["step_tokens"]
    prompts = _tp_prompts(cfg)
    mesh = make_mesh({"model": 1})
    eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                 pages_per_seq=8, quant_dtype="int8", device="cuda", mesh=mesh)
    reqs = [eng.submit(p, 32) for p in prompts]
    _build.reset_launches()
    stats = eng.run()
    got = dict(_build.launches)
    counts.update({k: counts.get(k, 0) + n for k, n in got.items()})
    same = [list(r.generated) for r in reqs] == want
    ok = same and stats.captures >= 1 and dist.get_backend() == "nccl"
    ok &= got.get("paged", 0) == cfg.n_layers * stats.steps
    print(f"tp_engine_8b model 1 over {dist.get_backend()} (this process), graphs "
          f"on: {stats.captures} captures, tokens identical to the unsharded "
          f"engine: {same}; prefill {stats.prefill_tokens / stats.prefill_s:.1f} "
          f"tok/s, decode {(stats.decode_tokens - 16) / stats.decode_s:.1f} tok/s "
          f"[{ident}]", flush=True)
    del eng
    dist.destroy_process_group()
    # the unsharded references: bf16 weights (engine_phase's tokens), and
    # int8 weights from the same seed (its own engine's tokens)
    refs = {None: (want, _forced_logits(llama, cfg, params, prompts, None,
                                        want).cpu())}
    p8 = llama.init_params(cfg, seed=SEED, device="cuda", quantize="int8")
    refs["int8"] = _unsharded_reference(llama, cfg, p8, prompts)
    del p8
    torch.cuda.empty_cache()
    ranks = _shard_ranks(shard)
    for quantize in (None, "int8"):
        ref_tokens, ref = refs[quantize]
        t0 = time.perf_counter()
        outs = [o for o in ranks.run(_tp_engine_rank, quantize, ref_tokens)
                if o is not None]
        wall = time.perf_counter() - t0
        for o in outs:
            counts.update({k: counts.get(k, 0) + n
                           for k, n in o["launches"].items()})
        agree = len(outs) == 2 and outs[0]["tokens"] == outs[1]["tokens"]
        o = outs[0]
        good = agree and all(len(t) == 32 for t in o["tokens"])
        good &= o["captures"] == 0 and o["kv_heads"] == cfg.n_kv_heads // 2
        good &= o["launches"].get("paged", 0) == cfg.n_layers * o["steps"]
        if quantize:
            good &= o["launches"].get("wmatmul", 0) > 0
        share = np.mean([a == b for t, w in zip(o["tokens"], ref_tokens)
                         for a, b in zip(t, w)])
        div = _first_divergence(o["tokens"], ref_tokens)
        lg = torch.from_numpy(o["logits"]).float()
        rl2 = [_diff(lg[j], ref[j])[4] for j in range(lg.shape[0])]
        fin = bool(torch.isfinite(lg).all())
        argmax = float((lg.argmax(-1) == ref.argmax(-1)).float().mean())
        mx = float((lg - ref).abs().max())
        good &= fin and lg.shape == ref.shape and max(rl2) <= 0.05
        kind = "int8 weights" if quantize else "bf16 weights"
        print(f"tp_engine_8b model 2 ({kind}): ranks' tokens identical {agree}; "
              f"teacher-forced on the unsharded {kind} engine's tokens, the "
              f"logits of each of {len(rl2)} steps vs the unsharded model's: "
              f"relative L2 first {rl2[0]:.4f}, largest {max(rl2):.4f} (at step "
              f"{int(np.argmax(rl2))}, <= 0.05), max_abs {mx:.3e}, argmax equal "
              f"{argmax:.4f}; free-running, {share:.4f} of tokens equal to the "
              f"unsharded {kind} engine's, a row's first differing token at "
              f"{sorted(div)} (32: none); {o['captures']} captures, "
              f"{o['kv_heads']} kv heads a rank, launches a rank "
              f"{o['launches']}; {_rates(shard, 2)}: prefill "
              f"{o['prefill_tps']:.1f} tok/s, decode "
              f"{o['decode_tps']:.1f} tok/s, peak {o['peak_gb']:.2f} GB a rank, "
              f"{wall:.1f} s [{ident}] {'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


def _seeded(shape, gen, dtype, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _cp_rank():
    """ctx ranks: ring prefill (causal, window (4095, 0)) and ring grad at s
    8192 over ctx 4; context_parallel_decode (b16, S 32768),
    context_parallel_paged_decode (int8 pages) and sequence_parallel_loss_fn
    (2 layers at 8B width) over ctx 2. Each rank also computes the
    unsharded reference of its part (not counted as launches)."""
    import dataclasses

    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.kernels.backward import flash_attention_bwd
    from mfa_tpu_torch.kernels.decode import decode_attention
    from mfa_tpu_torch.kernels.paged import paged_attention
    from mfa_tpu_torch.kernels.prefill import prefill_attention
    from mfa_tpu_torch.kernels.quant import quantize_rows
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.shard import attention as sa
    from mfa_tpu_torch.shard import ring
    from mfa_tpu_torch.shard.mesh import axis_index, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    res, launches = {}, {}

    def count():
        for k, n in _build.launches.items():
            launches[k] = launches.get(k, 0) + n

    mesh4 = make_mesh({"ctx": 4})
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, hq, hkv, s, d = 1, 32, 8, 8192, 128
    q, do = (_seeded((b, hq, s, d), gen, bf) for _ in range(2))
    k, v = (_seeded((b, hkv, s, d), gen, bf) for _ in range(2))
    me, chunk = axis_index(mesh4, "ctx"), s // 4
    sl = slice(me * chunk, (me + 1) * chunk)
    qc, kc, vc = (x[:, :, sl].contiguous() for x in (q, k, v))
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_c = ring.ring_attention_prefill(mesh4, causal=True)(qc, kc, vc)
    torch.cuda.synchronize()
    res["ring_ms"] = (time.perf_counter() - t0) * 1e3
    out_w = ring.ring_attention_prefill(mesh4, causal=True, window_left=4095)(
        qc, kc, vc)
    g_in = [x.clone().requires_grad_() for x in (qc, kc, vc)]
    ring.ring_attention_grad(mesh4, causal=True)(*g_in).backward(
        do[:, :, sl].contiguous())
    torch.cuda.synchronize()
    count()
    res["fwd_causal"] = _diff(out_c, prefill_attention(
        q, k, v, causal=True, bound_softmax=False)[:, :, sl])
    res["fwd_window"] = _diff(out_w, prefill_attention(
        q, k, v, causal=True, window_size=(4095, 0), bound_softmax=False)[:, :, sl])
    o_ref, lse_ref = prefill_attention(q, k, v, causal=True, return_lse=True)
    refs = flash_attention_bwd(q, k, v, o_ref, lse_ref, do, causal=True)
    res["grads"] = [_diff(g.grad, r[:, :, sl]) for g, r in zip(g_in, refs)]
    del q, k, v, do, qc, kc, vc, g_in, refs, o_ref, out_c, out_w
    torch.cuda.empty_cache()

    mesh2 = make_mesh({"ctx": 2})
    if mesh2.get_coordinate() is None:
        return res, launches
    me2 = axis_index(mesh2, "ctx")
    # context_parallel_decode: b16, S 32768, against kernel 5 unsharded
    B, S = 16, 32768
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    qd = _seeded((B, hq, d), gen, bf)
    kd, vd = (_seeded((B, hkv, S, d), gen, bf) for _ in range(2))
    lens = torch.as_tensor(np.random.RandomState(SEED).randint(1, S + 1, B),
                           dtype=torch.int32, device="cuda")
    lens[0], lens[1] = 100, S  # all on rank 0; the whole cache
    half = slice(me2 * S // 2, (me2 + 1) * S // 2)
    kh, vh = kd[:, :, half].contiguous(), vd[:, :, half].contiguous()
    _build.reset_launches()
    out = sa.context_parallel_decode(mesh2)(qd, kh, vh, lens)
    torch.cuda.synchronize()
    count()
    res["cp_decode"] = _diff(out, decode_attention(qd, kd, vd, lens))
    del kd, vd, kh, vh
    torch.cuda.empty_cache()
    # context_parallel_paged_decode on int8 pages: each rank a pool of its
    # own, against kernel 6 on the two pools merged
    page, pps = 64, 64
    pool = B * pps + 1
    rng = np.random.RandomState(SEED + 2)
    l0 = rng.randint(0, pps + 1, B) * page  # rank 0: whole pages
    l1 = rng.randint(0, pps * page + 1, B)
    lens_r = [torch.as_tensor(x, dtype=torch.int32, device="cuda") for x in (l0, l1)]
    tables_r = [torch.as_tensor(1 + np.arange(B * pps).reshape(B, pps),
                                dtype=torch.int32, device="cuda")] * 2
    pools = []
    for r in range(2):
        kp, vp = (_seeded((hkv, pool, page, d), gen, torch.float32) for _ in range(2))
        pools.append(quantize_rows(kp, "int8") + quantize_rows(vp, "int8"))
    kq, ks, vq, vs = pools[me2]
    _build.reset_launches()
    out = sa.context_parallel_paged_decode(mesh2, quantized=True)(
        qd, kq, vq, lens_r[me2], tables_r[me2], ks, vs)
    torch.cuda.synchronize()
    count()
    merged = [torch.cat([pools[0][i], pools[1][i]], dim=1) for i in range(4)]
    table = np.zeros((B, 2 * pps), np.int32)
    for i in range(B):
        n0 = l0[i] // page
        table[i, :n0] = 1 + i * pps + np.arange(n0)
        table[i, n0:n0 + pps] = pool + 1 + i * pps + np.arange(pps)
    ref = paged_attention(qd, merged[0], merged[2], torch.as_tensor(
        l0 + l1, dtype=torch.int32, device="cuda"), torch.as_tensor(
        table, device="cuda"), k_scales=merged[1], v_scales=merged[3])
    res["cp_paged"] = _diff(out, ref)
    del pools, merged, kq, vq
    torch.cuda.empty_cache()
    # sequence_parallel_loss_fn: 2 layers at 8B width, 1 x 4097 tokens
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    tokens = torch.as_tensor(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (1, 4097)), device="cuda")
    with torch.no_grad():
        want = float(llama.loss_fn(params, tokens, cfg))
    for p in llama.param_tensors(params):
        p.requires_grad_(True)
    _build.reset_launches()
    loss = ring.sequence_parallel_loss_fn(params, tokens, cfg, mesh2)
    loss.backward()
    torch.cuda.synchronize()
    count()
    res["sp_loss"] = (float(loss.detach()), want, all(
        bool(torch.isfinite(p.grad).all()) for p in llama.param_tensors(params)))
    del params, loss
    torch.cuda.empty_cache()
    return res, launches


def cp_ring_phase(counts, ident, shard):
    """cp_ring_8b: at 8B heads (hq 32, hkv 8, d 128, bf16) ring prefill and
    ring grad over ctx 4 against kernels 1 and 11 unsharded, then the
    context-parallel decodes and sequence-parallel training over ctx 2."""
    outs = _shard_ranks(shard).run(_cp_rank)
    ok = True
    for rank, (res, launches) in enumerate(outs):
        counts.update({k: counts.get(k, 0) + n for k, n in launches.items()})
        for name in ("fwd_causal", "fwd_window") + (
                ("cp_decode", "cp_paged") if "cp_decode" in res else ()):
            mx, mean, _, _, _, fin = res[name]
            good = fin and mx < 2e-2 and mean < 2e-3
            print(f"cp_ring_8b rank {rank} {name}: max_abs_err {mx:.3e} (< 2e-2) "
                  f"mean {mean:.3e} (< 2e-3) [{ident}] {'ok' if good else 'FAIL'}",
                  flush=True)
            ok &= good
        for name, (mx, mean, rmax, rmean, _, fin) in zip(("dq", "dk", "dv"),
                                                         res["grads"]):
            good = fin and mx <= 2e-2 * rmax and mean <= 2e-2 * rmean
            print(f"cp_ring_8b rank {rank} ring grad {name}: max_abs_err {mx:.3e} "
                  f"(<= {2e-2 * rmax:.3e}) mean {mean:.3e} (<= {2e-2 * rmean:.3e}) "
                  f"[{ident}] {'ok' if good else 'FAIL'}", flush=True)
            ok &= good
        if "sp_loss" in res:
            got, want, fin = res["sp_loss"]
            good = fin and abs(got - want) <= 1e-2 * abs(want)
            print(f"cp_ring_8b rank {rank} sequence_parallel_loss_fn (2 layers, "
                  f"1 x 4097, ctx 2): loss {got:.5f} vs loss_fn {want:.5f} "
                  f"(relative <= 1e-2), grads finite {fin} [{ident}] "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            ok &= good
        print(f"cp_ring_8b rank {rank}: causal ring prefill {res['ring_ms']:.1f} ms "
              f"(host clock, {_rates(shard, 4)}); launches {launches} "
              f"[{ident}]", flush=True)
    return ok


def _ep_rank():
    """expert ranks: Mixtral-8x7B's MoE layer at full width (int8 banks, 8
    experts) over expert 2 at 16 and 4096 rows, both forms against the
    unsharded routed output on the rank."""
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.models.wquant import adapt, stack_bank
    from mfa_tpu_torch.shard import expert
    from mfa_tpu_torch.shard.mesh import axis_index, make_mesh, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh({"expert": 2})
    if mesh.get_coordinate() is None:
        return None
    cfg = llama.LlamaConfig.mixtral_8x7b()
    d, f, E = cfg.dim, cfg.ffn_dim, cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    full = {n: stack_bank((_seeded(s, gen, torch.bfloat16, s[0] ** -0.5)
                           for _ in range(E)), E, True)
            for n, s in (("we_gate", (d, f)), ("we_up", (d, f)),
                         ("we_down", (f, d)))}
    w_router = _seeded((d, E), gen, torch.float32, d ** -0.5)
    spec = sharding(mesh, "expert")
    local = [llama._shard_leaf(full[n], adapt(spec, full[n]), n)
             for n in ("we_gate", "we_up", "we_down")]
    me = axis_index(mesh, "expert")
    res, launches = {}, {}
    for T in (16, 4096):
        t = _seeded((T, d), gen, torch.bfloat16)
        w_top, idx = llama._moe_route(t, w_router, cfg.n_active_experts,
                                      cfg.norm_topk)
        form = llama._moe_dense if T <= llama._MOE_DENSE_MAX_T else llama._moe_grouped
        ref = form(t, full, w_top, idx, cfg)
        _build.reset_launches()
        out = expert.expert_parallel_moe(mesh, cfg)(t, w_router, *local)
        rows = slice(me * T // 2, (me + 1) * T // 2)
        out_a2a = expert.expert_parallel_moe_a2a(mesh, cfg, capacity_factor=2.0)(
            t[rows].contiguous(), w_router, *local)
        torch.cuda.synchronize()
        for k, n in _build.launches.items():
            launches[k] = launches.get(k, 0) + n
        res[T] = (_diff(out, ref), _diff(out_a2a, ref[rows]))
    return res, launches


def ep_phase(counts, ident, shard):
    """ep_mixtral: expert_parallel_moe and expert_parallel_moe_a2a at
    Mixtral-8x7B's width over expert 2 against the unsharded _moe's routed
    output (relative L2 <= 1e-2: bf16 outputs, kernel 10's expert launch
    over other row groupings)."""
    ok = True
    outs = [o for o in _shard_ranks(shard).run(_ep_rank) if o is not None]
    ok &= len(outs) == 2
    for rank, (res, launches) in enumerate(outs):
        counts.update({k: counts.get(k, 0) + n for k, n in launches.items()})
        for T, pair in res.items():
            for name, (mx, _, rmax, _, rl2, fin) in zip(("psum", "a2a"), pair):
                good = fin and rl2 <= 1e-2
                print(f"ep_mixtral rank {rank} T {T} {name} form: relative L2 "
                      f"{rl2:.2e} (<= 1e-2), max_abs_err {mx:.3e} of |ref| max "
                      f"{rmax:.3f} [{ident}] {'ok' if good else 'FAIL'}", flush=True)
                ok &= good
        ok &= launches.get("wmatmul_bank", 0) > 0
        print(f"ep_mixtral rank {rank} launches {launches} [{ident}]", flush=True)
    return ok


def _pp_rank():
    """pipe ranks: pipeline_train_step at 8B width, 4 layers, pipe 2, 4
    microbatches of 1 x 2048, on the rank's stage tree (init_params(mesh=):
    its 2 layers), against the unsharded loss_fn's loss and gradients,
    computed on the rank first from the whole tree of the same seed."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.shard.mesh import axis_index, make_mesh
    from mfa_tpu_torch.shard.pipeline import pipeline_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh({"pipe": 2})
    if mesh.get_coordinate() is None:
        return None
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=4)
    tokens = torch.as_tensor(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (4, 2049)), device="cuda")
    mine = llama.stage_layers(cfg, mesh)

    def gb(tree):
        return sum(w.numel() * w.element_size()
                   for w in llama.param_tensors(tree)) / 1e9

    full = llama.init_params(cfg, seed=SEED, device="cuda")
    whole_gb = gb(full)
    for p in llama.param_tensors(full):
        p.requires_grad_(True)
    loss = llama.loss_fn(full, tokens, cfg)
    loss.backward()
    want = float(loss.detach())
    ref = [p.grad.float().cpu() for p in llama.param_tensors(
        dict(full, layers=[full["layers"][i] for i in mine]))]
    del full, loss
    torch.cuda.empty_cache()
    params = llama.init_params(cfg, seed=SEED, device="cuda", mesh=mesh)
    _build.reset_launches()
    torch.cuda.synchronize()
    dist.barrier(group=mesh.get_group("pipe"))  # both stages start the clock
    t0 = time.perf_counter()
    _, got = pipeline_train_step(params, tokens, cfg, mesh, n_micro=4, lr=1e-3)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launches)
    leaves = llama.param_tensors(params)
    worst_cos, worst_ratio = 1.0, 0.0
    for p, r in zip(leaves, ref):
        a = p.grad.float().cpu()
        na, nr = float(a.norm()), float(r.norm())
        if na == 0.0 and nr == 0.0:
            continue
        worst_cos = min(worst_cos, float((a * r).sum()) / max(na * nr, 1e-30))
        worst_ratio = max(worst_ratio, abs(na / max(nr, 1e-30) - 1.0))
    return dict(loss=float(got), want=want, cos=worst_cos, ratio=worst_ratio,
                n=len(ref), n_got=len(leaves), held=len(params["layers"]),
                stage_gb=gb(params), whole_gb=whole_gb, ms=ms,
                stage=axis_index(mesh, "pipe"), launches=launches)


def pipeline_phase(counts, ident, shard):
    """pipeline_8b: one GPipe SGD step (pipe 2), each rank on its stage's
    2 layers only, against the unsharded train step, within the train
    tolerance of cuda_vs_cpu (loss |diff| <= 5e-2, gradient cosine >=
    0.99, norm ratio within 0.05)."""
    try:
        outs = [o for o in _shard_ranks(shard).run(_pp_rank) if o is not None]
    finally:
        _close_ranks(shard)
    ok = len(outs) == 2
    for o in outs:
        counts.update({k: counts.get(k, 0) + n for k, n in o["launches"].items()})
        good = abs(o["loss"] - o["want"]) <= 5e-2 and o["cos"] >= 0.99 \
            and o["ratio"] <= 0.05 and o["launches"].get("bwd_fused", 0) == 2 * 4
        good &= o["held"] == 2 and o["n_got"] == o["n"]
        print(f"pipeline_8b stage {o['stage']}: holds {o['held']} of 4 layers "
              f"({o['stage_gb']:.2f} GB of weights, the whole tree "
              f"{o['whole_gb']:.2f} GB); loss {o['loss']:.5f} vs unsharded "
              f"{o['want']:.5f} (|diff| <= 5e-2); over its {o['n']} weight "
              f"tensors the least gradient cosine {o['cos']:.5f} (>= 0.99), the "
              f"largest norm ratio - 1 {o['ratio']:.4f} (<= 0.05); step "
              f"{o['ms']:.1f} ms (host clock, {_rates(shard, 2)}); launches "
              f"{o['launches']} [{ident}] "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


# fp32: the fp32 tile (csrc/flash_fwd_f32.cuh, paged_prefill.cu) and the decode tile
# (csrc/decode_sm90.cuh) with fp32 q

FP32_KERNELS = ("prefill", "flagged", "repair", "bound", "decode", "paged",
                "varlen", "paged_prefill", "blockmask")
# the backward's launches (csrc/flash_bwd_f32.cuh on fp32 inputs)
FP32_BWD = ("bwd_fused", "bwd_dkv", "bwd_dq", "varlen_bwd_dkv", "varlen_bwd_dq")
# fp32-accurate products on the card: TF32's dense 495 TFLOP/s over the three
# passes of a split product (3xTF32), the rate an fp32 bound is held to
PEAK_F32_FLOPS = 495e12 / 3
# kernel 10 on fp32 x: three bf16 products at the dense bf16 rate, the least
# any exact route on this card costs
PEAK_W32_FLOPS = 989e12 / 3


def _peak32(quant) -> float:
    """The rate 4 d flops a visible (row, key) pair are held to with fp32 q:
    165 TFLOP/s on fp32 K/V (3xTF32, both products). On quantized pages the
    payload values are exact in bf16, so S = q k needs fp32 q as three bf16
    parts against k (PEAK_W32_FLOPS, as kernel 10), and P V, p rounded to
    bf16, one exact bf16 product at 989: 4 flops a pair at
    4 / (2 / 329.7 + 2 / 989) = 494.5 TFLOP/s."""
    return PEAK_F32_FLOPS if quant is None else 4 / (2 / PEAK_W32_FLOPS + 2 / 989e12)


def _bound32(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS):
    """The least ms for fp32 work: bytes over 3.35 TB/s against operations
    over `peak` (165 TFLOP/s), whichever is larger."""
    from mfa_tpu_torch.utils.timing import PEAK_BYTES

    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _err32(out, ref, what, lse=None, ref_lse=None, tol=1e-4):
    """fp32 outputs against their plain version: |o - r| <= tol + tol |r|
    everywhere, the LSE likewise with the same -inf rows -> (max abs
    error, ok)."""
    import torch

    o, r = out.float(), ref.float()
    d = (o - r).abs()
    ok = bool(torch.isfinite(o).all()) and bool((d <= tol + tol * r.abs()).all())
    msg = f"  {what}: max_abs_err {float(d.max()):.3e} (atol = rtol = {tol})"
    if lse is not None:
        same = torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
        fin = torch.isfinite(ref_lse)
        dl = (lse[fin] - ref_lse[fin]).abs()
        ok &= same and bool((dl <= tol + tol * ref_lse[fin].abs()).all())
        msg += (f", lse max_abs_err {float(dl.max()) if dl.numel() else 0.0:.3e}, "
                f"-inf rows match {same}")
    print(f"{msg} {'ok' if ok else 'FAIL'}", flush=True)
    return float(d.max()), ok


def _record32(records, name, tag, mx, ms, plain_ms, lib_ms, nbytes, flops,
              peak=PEAK_F32_FLOPS):
    """Print a timing line; the first shape timed for a kernel is its row
    of the kernels line (the error is the largest over its shapes)."""
    bound_ms, by = _bound32(nbytes, flops, peak)
    lib = (f"library_ms {lib_ms:.4f} (kernel / library {ms / lib_ms:.2f}x)"
           if lib_ms else "library_ms none")
    print(f"  {tag}: ms {ms:.4f} bound_ms {bound_ms:.6f} ({by}, share "
          f"{bound_ms / ms:.3f}) plain_ms {plain_ms:.4f} {lib}", flush=True)
    rec = records[f"{name}_fp32"]
    rec["max_abs_err"] = max(rec.get("max_abs_err") or 0.0, mx)
    if "ms" not in rec:
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                   library_ms=lib_ms)


def _poison_rows_past(kp, vp, ks, vs, quant, table, lens, page):
    """NaN (16-bit and fp32 pages), NaN scales and the fp8 NaN code in every
    row of a sequence's pages at or past its length: rows no kernel may
    read."""
    where = _stale_rows(table, lens, page, kp.shape[0], kp.shape[1])
    for pages, scales in ((kp, ks), (vp, vs)):
        if quant is None:
            pages[where] = float("nan")
        else:
            _poison_stale(pages, scales, quant, where)


def _pages32(kf, vf, quant):
    """fp32 pages (copies) or their quantized format (_kv_pages)."""
    return _kv_pages(kf, vf, quant) if quant else (kf.clone(), vf.clone(), None, None)


def _row_bytes32(quant, d: int) -> int:
    """Bytes one K or V row of a page moves: 4 d in fp32, else _row_bytes."""
    return _row_bytes(quant, d) if quant else 4 * d


def _fp32_bound_vs_fp64(rn, hq, hkv):
    """fp32 kernel 4 on std-1e3 and shifted (+-40) inputs, b16 s256 causal
    at d 128 ("prepass") and d 64 (the default). Their 1e4-1e6 scores carry
    fp32 rounding of about 1e-3 in any summation order, so they are held to
    an fp64 reference (_causal_reference64) at the bf16 kernel 4's limits
    on O (max 1e-1, mean 2e-3: zero_shift_kernels) or at twice the
    distance from fp64 of the plain version in fp32 or in the kernel's own
    arithmetic (3xTF32 products, backward._matmul_3xtf32_plain; every tile
    here is risky, so the classic prefill is the function), where that is
    larger: no summation in that arithmetic does better. The LSE error is
    taken relative to the row's score bound |q| max |k| scale, which fp32
    rounding scales with (1e-5, or twice the plain versions'): the bf16
    check's |lse| (at least 1) fails the fp32 plain version itself on
    some draws, where a row's LSE sits near 0 among scores of 1e6."""
    import torch

    from mfa_tpu_torch.kernels import backward, prefill

    ok = True
    for d4, mode, kind in ((128, "prepass", "std 1e3"), (128, "prepass", "shifted"),
                           (64, None, "std 1e3"), (64, None, "shifted")):
        q, k, v = rn(16, hq, 256, d4), rn(16, hkv, 256, d4), rn(16, hkv, 256, d4)
        q, k = (q * 1e3, k * 1e3) if kind == "std 1e3" else (q + 40.0, k - 40.0)
        sc = d4 ** -0.5
        bits = prefill._risky_bits(q, k, sc * prefill._LOG2E)
        o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                           bound_softmax=mode)
        ro, rl = _causal_reference64(q, k, v, sc)
        po, pl, _ = prefill._engine_plain("bound", mode or "prepass", q, k, v, sc, -1, 0)
        to, tl = prefill._prefill_plain(q, k, v, sc, -1, 0, 0.0, True,
                                        matmul=backward._matmul_3xtf32_plain)
        group = hq // hkv
        span = (q.double().norm(dim=-1) * sc * k.double().norm(dim=-1).amax(-1)
                .repeat_interleave(group, 1)[..., None])

        def dists(out, l_):
            e = (out.double() - ro).abs()
            return float(e.max()), float(e.mean()), float(((l_ - rl).abs() / span).max())

        got, fp32, tf32x3 = dists(o, lse), dists(po, pl), dists(to, tl)
        lim = tuple(max(b, 2 * f, 2 * t) for b, f, t in zip((1e-1, 2e-3, 1e-5), fp32,
                                                            tf32x3))
        good = bool(torch.isfinite(o).all()) and all(g < li for g, li in zip(got, lim)) \
            and bool(bits.all())
        print(f"bound_fp32 (kernel 4) b16 hq{hq} hkv{hkv} s256 d{d4} "
              f"{mode or 'default'} on {kind} inputs ({int(bits.sum())} of "
              f"{bits.numel()} tiles risky), against fp64: max_abs_err {got[0]:.3e} "
              f"(< {lim[0]:.3e}) mean {got[1]:.3e} (< {lim[1]:.3e}) lse error / "
              f"|q| max|k| scale {got[2]:.3e} (< {lim[2]:.3e}); the plain version's "
              f"in fp32: max "
              f"{fp32[0]:.3e} mean {fp32[1]:.3e} lse {fp32[2]:.3e}, in 3xTF32: max "
              f"{tf32x3[0]:.3e} mean {tf32x3[1]:.3e} lse {tf32x3[2]:.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
        del q, k, v, o, ro, po, to
    return ok


def fp32_kernels(records):
    """Phase 2 in fp32: every forward kernel and kind on fp32 inputs against
    its plain fp32 version on the card, at the 8B shapes of PERF.md §6 (d
    128, 32 q / 8 kv heads): kernel 1, 2 + 3 and 3 alone at the 8B wave
    and at one 4096-token prompt (benign: 0 flags; std-1e3 and shifted
    inputs: flags equal to the plain version's, > 0, and every flagged tile
    equal to kernel 1 bit for bit), kernel 4 at d 64 (the 8B wave's heads
    and BASELINE's first config) with and without risky bits (q and k x 4:
    every tile risky), kernel 5 at
    b16 S8192 (one split and two), kernel 6 at the 8B serve step on fp32, int8,
    fp8 and int4 pages (fp32 q) and at lens 8192, kernel 7 on 8 x 512 and a
    ragged pack, kernel 8 at the engine chunk batch on every page format,
    kernel 9 at Gemma3-4B's image wave. Limits: atol = rtol = 1e-4 on fp32
    inputs and pages (the LSE too, the same -inf rows); on quantized pages
    the bf16-q case's (max 2e-2, mean 2e-3). Bounds: 4-byte rows (the page
    bytes for quantized pages) at 3.35 TB/s against the operations at 165
    TFLOP/s (494.5 on quantized pages, _peak32); library: SDPA on the fp32
    tensors (kernels 1, 2, 4, 5, 7; 9 with a bool mask), none for 3, 6 and
    8."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import (_build, blockmask, decode, paged,
                                       paged_prefill, prefill, varlen)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    ok = tf32 is False and prec == "highest"
    print(f"fp32 kernels: torch.backends.cuda.matmul.allow_tf32 {tf32}, float32 "
          f"matmul precision {prec!r} (the plain versions' products in full fp32)",
          flush=True)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5
    # -- kernels 1, 2, 3: the 8B wave and one 4096-token prompt
    for b, s in ((16, 256), (1, 4096)):
        q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
        flops = 4 * b * hq * s * (s + 1) / 2 * d
        nbytes = 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        tag = f"b{b} hq{hq} hkv{hkv} s{s} d{d} causal fp32"
        ro, rl = prefill._prefill_plain(q, k, v, scale, -1, 0, 0.0, True)
        plain_ms = _time_ms(lambda: prefill._prefill_plain(
            q, k, v, scale, -1, 0, 0.0, False), iters=3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                           bound_softmax=False)
        print(f"prefill_fp32 (kernel 1) {tag}", flush=True)
        mx, good = _err32(o, ro, "O", lse, rl)
        ok &= good
        _record32(records, "prefill", "kernel 1", mx, _time_ms(
            lambda: prefill.prefill_attention(q, k, v, causal=True, bound_softmax=False)),
            plain_ms, lib_ms, nbytes, flops)
        o2, lse2, flags = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                                    bound_softmax="flag_debug")
        zo, zl, zf = prefill._engine_plain("flagged", "flag_debug", q, k, v, scale, -1, 0)
        print(f"flagged_fp32 + repair_fp32 (kernels 2 + 3) {tag}, benign: "
              f"{int(flags.sum())} flags (plain {int(zf.sum())})", flush=True)
        mx, good = _err32(o2, zo, "O", lse2, zl)
        ok &= good and int(flags.sum()) == 0 and torch.equal(flags, zf.int())
        _record32(records, "flagged", "kernel 2 alone (flag_only)", mx, _time_ms(
            lambda: prefill.prefill_attention(q, k, v, causal=True,
                                              bound_softmax="flag_only")),
            plain_ms, lib_ms, nbytes, flops)
        out, lse3 = torch.empty_like(q), torch.empty_like(lse)
        none_ms = _time_ms(lambda: prefill._zs_launch(
            "repair", q, k, v, out, lse3, torch.zeros_like(flags), scale, -1, 0))
        every = torch.ones_like(flags)
        ms = _time_ms(lambda: prefill._zs_launch("repair", q, k, v, out, lse3, every,
                                                 scale, -1, 0))
        torch.cuda.synchronize()
        print(f"  kernel 3 with no tile flagged: ms {none_ms:.4f}", flush=True)
        mx, good = _err32(out, ro, "kernel 3 over every tile", lse3, rl)
        same = torch.equal(out, o) and torch.equal(lse3, lse)
        print(f"  kernel 3 over every tile equals kernel 1 bit for bit: {same}", flush=True)
        ok &= good and same
        _record32(records, "repair", "kernel 3, every tile flagged", mx, ms, plain_ms,
                  None, nbytes, flops)
        print(f"  kernel 3 beside SDPA fp32 on kernel 1's function: sdpa_ms {lib_ms:.4f} "
              f"(kernel 3 / sdpa {ms / lib_ms:.2f}x)", flush=True)
        del q, k, v, ro, rl, o, o2, zo, out
        torch.cuda.empty_cache()
    for kind in ("overflow", "flush"):
        q, k, v = rn(16, hq, 256, d), rn(16, hkv, 256, d), rn(16, hkv, 256, d)
        q, k = (q * 1e3, k * 1e3) if kind == "overflow" else (q + 40.0, k - 40.0)
        o, flags = prefill.prefill_attention(q, k, v, causal=True,
                                             bound_softmax="flag_debug")
        k1 = prefill.prefill_attention(q, k, v, causal=True, bound_softmax=False)
        _, _, zf = prefill._engine_plain("flagged", "flag_debug", q, k, v, scale, -1, 0)
        rows = flags.bool().repeat_interleave(64, -1)[..., :256]
        good = int(flags.sum()) > 0 and torch.equal(flags, zf.int()) \
            and torch.equal(o[rows], k1[rows])
        print(f"kernels 2 + 3 fp32 on {kind} inputs (8B wave): {int(flags.sum())} of "
              f"{flags.numel()} tiles flagged (plain {int(zf.sum())}), flagged tiles "
              f"equal kernel 1 bit for bit {'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    # -- kernel 4 at d 64: the 8B wave's heads, and BASELINE's first config
    # ("risky": q and k x 4, every tile's norm bound past the zero shift's
    # range, so every tile runs the classic softmax: scores of std ~16 stay
    # well inside fp32's exactness, unlike std-1e3 scores, whose fp32
    # rounding alone moves p by percents in any summation order)
    for b, h, kvh, s, causal, kind in ((16, 32, 8, 256, True, "benign"),
                                       (2, 8, 8, 128, False, "benign"),
                                       (16, 32, 8, 256, True, "risky")):
        q, k, v = rn(b, h, s, 64), rn(b, kvh, s, 64), rn(b, kvh, s, 64)
        if kind == "risky":
            q, k = q * 4.0, k * 4.0
            bits = prefill._risky_bits(q, k, 64 ** -0.5 * prefill._LOG2E)
            print(f"  risky bits: {int(bits.sum())} of {bits.numel()} tiles", flush=True)
            ok &= bool(bits.all())
        wr = 0 if causal else -1
        tag = f"bound_fp32 (kernel 4) b{b} hq{h} hkv{kvh} s{s} d64 {kind}"
        for mode in (None, "unchecked") if kind == "benign" else (None,):
            o, lse = prefill.prefill_attention(q, k, v, causal=causal, return_lse=True,
                                               bound_softmax=mode)
            zo, zl, _ = prefill._engine_plain("bound", mode or "prepass", q, k, v,
                                              64 ** -0.5, -1, wr)
            print(f"{tag} {mode or 'prepass'}", flush=True)
            mx, good = _err32(o, zo, "O", lse, zl)
            ok &= good
        if kind == "benign" and b == 16:
            pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
            _record32(records, "bound", "kernel 4 alone (unchecked); prepass "
                      f"{_time_ms(lambda: prefill.prefill_attention(q, k, v, causal=causal)):.4f}",
                      mx, _time_ms(lambda: prefill.prefill_attention(
                          q, k, v, causal=causal, bound_softmax="unchecked")),
                      _time_ms(lambda: prefill._engine_plain(
                          "bound", "prepass", q, k, v, 64 ** -0.5, -1, wr), iters=3),
                      _time_ms(lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=causal, enable_gqa=True)),
                      4 * (2 * b * h * s * 64 + 2 * b * kvh * s * 64), 4 * pairs * 64)
    ok &= _fp32_bound_vs_fp64(rn, hq, hkv)
    # -- kernel 5, one launch: b16 S8192 at its split count and at 2, then a
    # window with sinks and ALiBi
    b, S = 16, 8192
    q, kc, vc = rn(b, hq, d), rn(b, hkv, S, d), rn(b, hkv, S, d)
    L = torch.full((b,), S, dtype=torch.int32, device=dev)
    heur = decode.default_splits(b, hkv, S, hq // hkv)
    for wl, sinks, alibi, req in ((-1, 0, False, heur), (-1, 0, False, 2),
                                  (4095, 4, True, heur)):
        ns, tps = decode.split_layout(S, req)
        slopes = _alibi_slopes(hq) if alibi else None
        po, pl = decode._decode_partials_plain(q, kc, vc, L, scale, ns, tps, wl, 0.0,
                                               sinks, slopes)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        partials = (torch.empty((b, hkv, ns, hq // hkv, d), device=dev),
                    torch.empty((b, hkv, ns, hq // hkv), device=dev))

        def call():
            return decode._decode_cuda(q, kc, vc, L, scale, ns, tps, wl, 0.0, sinks,
                                       slopes, partials=partials)

        _build.reset_launches()
        o, lse = call()
        print(f"decode_fp32 (kernel 5) b{b} hq{hq} hkv{hkv} S{S} d{d}, "
              f"{ns} splits, window {wl}, sinks {sinks}, ALiBi {alibi}: "
              f"{dict(_build.launches)}", flush=True)
        mx, good = _err32(o, ro.reshape(b, hq, d), "O", lse, rl.reshape(b, hq))
        ok &= good and dict(_build.launches) == {"decode_fp32": 1}
        if ns > 1:
            _merge_bits(o, lse, partials, torch.float32)
        if wl < 0 and req == heur:
            _record32(records, "decode", f"one launch ({ns} splits)", mx, _time_ms(call),
                      _time_ms(lambda: decode.combine_splits(*decode._decode_partials_plain(
                          q, kc, vc, L, scale, ns, tps, -1, 0.0), axis=2), iters=3),
                      _time_ms(lambda: F.scaled_dot_product_attention(
                          q[:, :, None], kc, vc, enable_gqa=True)),
                      2 * b * hkv * S * d * 4 + 2 * b * hq * d * 4, 4 * b * hq * S * d)
    del q, kc, vc, po, pl, ro, partials
    torch.cuda.empty_cache()
    # -- kernel 6: the 8B serve step (fp32 q) on every page format, and lens 8192
    page = 64
    for quant, lens in ((None, [300 - 7 * i for i in range(16)]), ("int8", None),
                        ("fp8", None), ("int4", None), (None, [8192] * 16),
                        ("int8", [8192] * 16)):
        lens = lens or [300 - 7 * i for i in range(16)]
        b, pps = len(lens), max(lens) // page + 1
        P = b * pps + 1
        q = rn(b, hq, d)
        kp, vp, ks, vs = _pages32(rn(hkv, P, page, d), rn(hkv, P, page, d), quant)
        bt = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
              ).reshape(b, pps).int()
        L = torch.tensor(lens, dtype=torch.int32, device=dev)
        ro, rl = paged._paged_plain(q, kp, vp, ks, vs, L, bt, scale, -1, 0.0, 1, quant)
        plain_ms = _time_ms(lambda: paged._paged_plain(q, kp, vp, ks, vs, L, bt, scale,
                                                       -1, 0.0, 1, quant), iters=3)
        _poison_rows_past(kp, vp, ks, vs, quant, bt, lens, page)
        _build.reset_launches()
        o, lse = paged.paged_attention(q, kp, vp, L, bt, k_scales=ks, v_scales=vs,
                                       pos_offset=1, quant_dtype=quant, return_lse=True)
        got = dict(_build.launches)
        print(f"paged_fp32 (kernel 6) fp32 q on {quant or 'fp32'} pages b{b} hq{hq} "
              f"hkv{hkv} page {page} lens {min(lens)}..{max(lens)} pos_offset 1: {got}",
              flush=True)
        if quant is None:
            mx, good = _err32(o, ro, "O", lse, rl)
        else:
            mx, good = _err(o, ro, what="O")
            good &= _lse_err(lse, rl, "")
        ok &= good and got.get("paged_fp32", 0) == 1
        rows = sum(lens) * hkv
        _record32(records, "paged", f"{quant or 'fp32'} pages, lens {max(lens)}", mx,
                  _time_ms(lambda: paged.paged_attention(
                      q, kp, vp, L, bt, k_scales=ks, v_scales=vs, pos_offset=1,
                      quant_dtype=quant, return_lse=True)), plain_ms, None,
                  2 * rows * _row_bytes32(quant, d) + b * pps * 4
                  + 2 * b * hq * d * 4 + b * hq * 4, 4 * (hq // hkv) * rows * d,
                  _peak32(quant))
        del kp, vp, ks, vs
    torch.cuda.empty_cache()
    # -- kernel 7: 8 x 512 packed, causal, and a ragged pack with a window
    for lens in ([512] * 8, [200, 1100, 512, 300, 700, 384, 450, 450]):
        n = sum(lens)
        q, k, v = rn(n, hq, d), rn(n, hkv, d), rn(n, hkv, d)
        cu = torch.tensor([0] + lens, device=dev).cumsum(0).int()
        wl = -1 if len(set(lens)) == 1 else 255
        ro, rl = varlen._varlen_plain(q, k, v, cu, cu, scale, wl, 0, 0.0, True)
        o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens),
                                         causal=True, window_size=(wl, -1),
                                         return_lse=True)
        print(f"varlen_fp32 (kernel 7) lens {lens} hq{hq} hkv{hkv} d{d} causal, "
              f"window {wl}", flush=True)
        mx, good = _err32(o, ro, "O", lse, rl)
        ok &= good
        if wl < 0:
            qb, kb, vb = (t.view(8, 512, -1, d).transpose(1, 2) for t in (q, k, v))
            _record32(records, "varlen", "8 x 512", mx, _time_ms(
                lambda: varlen.varlen_attention(q, k, v, cu, cu, 512, 512, causal=True)),
                _time_ms(lambda: varlen._varlen_plain(q, k, v, cu, cu, scale, -1, 0, 0.0,
                                                      False), iters=3),
                _time_ms(lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, is_causal=True, enable_gqa=True)),
                4 * (2 * n * hq * d + 2 * n * hkv * d), 4 * hq * 8 * 512 * 513 / 2 * d)
    # -- kernel 8: the engine chunk batch, 4 x 512 at q_start 0-3072, pages of 64
    q_start, sq = [0, 1024, 2048, 3072], 512
    lens = [s0 + sq for s0 in q_start]
    b, pps = 4, max(lens) // page + 1
    P = b * pps + 3
    q = rn(b, sq, hq, d)
    kf, vf = rn(hkv, P, page, d), rn(hkv, P, page, d)
    bt = (torch.randperm(P - 1, generator=gen, device=dev)[: b * pps] + 1
          ).reshape(b, pps).int()
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    ql = L - qs
    pairs = sum(_visible_pairs(sq, n, s0, -1, 0) for s0, n in zip(q_start, lens))
    for quant in ("int8", None, "fp8", "int4"):
        kp, vp, ks, vs = _pages32(kf, vf, quant)
        ro, rl = paged_prefill._paged_prefill_plain(q, kp, vp, ks, vs, L, qs, ql, bt,
                                                    scale, -1, 0, 0.0, quant)
        plain_ms = _time_ms(lambda: paged_prefill._paged_prefill_plain(
            q, kp, vp, ks, vs, L, qs, ql, bt, scale, -1, 0, 0.0, quant), iters=3)
        _poison_rows_past(kp, vp, ks, vs, quant, bt, lens, page)
        _build.reset_launches()
        o, lse = paged_prefill.paged_prefill_attention(
            q, kp, vp, L, qs, bt, q_lens=ql, k_scales=ks, v_scales=vs, quant_dtype=quant,
            return_lse=True)
        got = dict(_build.launches)
        print(f"paged_prefill_fp32 (kernel 8) fp32 q on {quant or 'fp32'} pages: chunk "
              f"batch 4 x 512 at q_start {q_start}, hq{hq} hkv{hkv} d{d}: {got}",
              flush=True)
        if quant is None:
            mx, good = _err32(o, ro, "O", lse, rl)
        else:
            mx, good = _err(o, ro, what="O")
            good &= _lse_err(lse, rl, "")
        ok &= good and got == {"paged_prefill_fp32": 1}
        _record32(records, "paged_prefill", f"{quant or 'fp32'} pages", mx, _time_ms(
            lambda: paged_prefill.paged_prefill_attention(
                q, kp, vp, L, qs, bt, q_lens=ql, k_scales=ks, v_scales=vs,
                quant_dtype=quant)), plain_ms, None,
            2 * sum(lens) * hkv * _row_bytes32(quant, d) + 2 * b * sq * hq * d * 4,
            4 * hq * pairs * d, _peak32(quant))
        del kp, vp, ks, vs
    del q, kf, vf
    torch.cuda.empty_cache()
    # -- kernel 9: Gemma3-4B's image wave (b4 hq8 hkv4 s2048 d256, a 256-token
    # run at 700, window 1023)
    b, h9, kv9, s, d9 = 4, 8, 4, 2048, 256
    q, k, v = rn(b, h9, s, d9), rn(b, kv9, s, d9), rn(b, kv9, s, d9)
    ids = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    ids[:, 700:956] = 0
    vis = blockmask.block_mask(ids, 1023)
    ref = blockmask._image_block_plain(q, k, v, ids, d9 ** -0.5, 1023)
    o = blockmask.image_block_prefill(q, k, v, ids, window_left=1023)
    print(f"blockmask_fp32 (kernel 9) Gemma3-4B image wave b{b} hq{h9} hkv{kv9} s{s} "
          f"d{d9}, run 700-955, window 1023", flush=True)
    mx, good = _err32(o, ref, "O")
    ok &= good
    _record32(records, "blockmask", "image wave", mx, _time_ms(
        lambda: blockmask.image_block_prefill(q, k, v, ids, window_left=1023)),
        _time_ms(lambda: blockmask._image_block_plain(q, k, v, ids, d9 ** -0.5, 1023),
                 iters=3),
        _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=vis[:, None], enable_gqa=True)),
        4 * (2 * b * h9 * s * d9 + 2 * b * kv9 * s * d9) + 4 * b * s,
        4 * h9 * float(vis.sum()) * d9)
    del q, k, v, vis, ref
    torch.cuda.empty_cache()
    return ok


def minimal_fp32_phase(counts):
    """Main path in fp32, the library surface: BASELINE's first config
    (flash_attn_func, non-causal MHA, b2 s128 h8 d64 fp32: kernel 4) and
    tests/test_minimal.py's two cases (a one-head dense prefill; a paged
    decode through flash_attn_with_kvcache: kernel 6 on fp32 pages) against
    mfa_tpu_torch/ref/oracle.py within 2e-5, as tests/test_minimal.py:34,49
    hold them; then every fp32 kernel through its entry point at the 8B
    heads: flash_attn_func causal (kernels 2 + 3) and with a softcap
    (kernel 1), flash_attn_varlen_func packed (7) and paged (8),
    flash_attn_with_kvcache contiguous (5) and paged (6),
    image_block_prefill (9); then the gradients on fp32 tensors (kernels
    11-14): BASELINE's first config through flash_attn_func_grad (fused),
    the 8B heads' flash_attn_func_grad (fused) and flash_attention_bwd with
    fused=False (12 + 13), flash_attn_varlen_func_grad on the packed
    sequences (14). Only fp32 launch names may appear."""
    import torch

    import mfa_tpu_torch
    from mfa_tpu_torch.kernels import _build, autodiff, backward, blockmask, prefill
    from mfa_tpu_torch.ref import oracle

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    _build.reset_launches()
    ok = True
    q, k, v = rn(2, 128, 8, 64), rn(2, 128, 8, 64), rn(2, 128, 8, 64)
    q1, k1, v1 = rn(1, 128, 1, 64), rn(1, 128, 1, 64), rn(1, 128, 1, 64)
    qd = rn(1, 1, 2, 64)
    kp, vp = rn(5, 64, 2, 64), rn(5, 64, 2, 64)
    table = torch.tensor([[3, 1, 4, 2]], dtype=torch.int32, device="cuda")
    lens = torch.tensor([200], dtype=torch.int32, device="cuda")
    for name, out, ref in (
            ("BASELINE configs[0]: non-causal MHA b2 s128 h8 d64",
             mfa_tpu_torch.flash_attn_func(q, k, v), oracle.attention_ref(q, k, v)),
            ("test_minimal_dense: b1 s128 h1 d64", mfa_tpu_torch.flash_attn_func(
                q1, k1, v1), oracle.attention_ref(q1, k1, v1)),
            ("test_minimal_paged_decode: hq2 hkv2 d64, pages of 64, len 200",
             mfa_tpu_torch.flash_attn_with_kvcache(qd, kp, vp, cache_seqlens=lens,
                                                   block_table=table),
             oracle.paged_decode_ref(qd, kp, vp, lens, table))):
        diff = float((out - ref).abs().max())
        good = out.dtype == torch.float32 and out.shape == ref.shape \
            and bool(torch.isfinite(out).all()) and diff < 2e-5
        print(f"minimal fp32, {name}: max |out - oracle| {diff:.3e} (< 2e-5) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    minimal = dict(_build.launches)
    q, k, v = rn(16, 256, 32, 128), rn(16, 256, 8, 128), rn(16, 256, 8, 128)
    outs = [mfa_tpu_torch.flash_attn_func(q, k, v, causal=True),
            mfa_tpu_torch.flash_attn_func(q, k, v, causal=True, softcap=30.0)]
    lens_v = [200, 1100, 512, 300, 700, 384, 450, 450]
    cu = torch.tensor([0] + lens_v, device="cuda").cumsum(0).int()
    qv, kv, vv = rn(4096, 32, 128), rn(4096, 8, 128), rn(4096, 8, 128)
    outs.append(mfa_tpu_torch.flash_attn_varlen_func(qv, kv, vv, cu, cu, 1100, 1100,
                                                     causal=True))
    kpool, vpool = rn(256, 64, 8, 128), rn(256, 64, 8, 128)
    ptab = torch.arange(1, 65, device="cuda", dtype=torch.int32).reshape(16, 4)
    plens = [100, 256, 37, 180]
    cu_p = torch.tensor([0] + plens, device="cuda").cumsum(0).int()
    outs.append(mfa_tpu_torch.flash_attn_varlen_func(
        rn(sum(plens), 32, 128), kpool, vpool, cu_p, cu_p, 256, 256, causal=True,
        block_table=ptab[:4]))
    qd = rn(16, 1, 32, 128)
    kc, vc = rn(16, 2048, 8, 128), rn(16, 2048, 8, 128)
    outs.append(mfa_tpu_torch.flash_attn_with_kvcache(qd, kc, vc, cache_seqlens=2048))
    outs.append(mfa_tpu_torch.flash_attn_with_kvcache(qd, kpool, vpool, cache_seqlens=200,
                                                      block_table=ptab))
    ids = torch.full((2, 600), -1, dtype=torch.int32, device="cuda")
    ids[:, 100:356] = 0
    outs.append(blockmask.image_block_prefill(rn(2, 8, 600, 256), rn(2, 4, 600, 256),
                                              rn(2, 4, 600, 256), ids, window_left=127))
    # the gradients: BASELINE's first config, the 8B heads (fused, then the
    # split through flash_attention_bwd), the packed sequences
    qb, kb, vb = (rn(2, 128, 8, 64).requires_grad_() for _ in range(3))
    ob = autodiff.flash_attn_func_grad(qb, kb, vb)
    grads = list(torch.autograd.grad((ob * ob).sum(), (qb, kb, vb)))
    leaves = [t.detach().requires_grad_() for t in (q, k, v, qv, kv, vv)]
    og = autodiff.flash_attn_func_grad(*leaves[:3], causal=True)
    ogv = autodiff.flash_attn_varlen_func_grad(*leaves[3:], cu, cu, 1100, 1100,
                                               causal=True)
    grads += torch.autograd.grad((og * outs[0]).sum() + (ogv * outs[2]).sum(), leaves)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ot, lse = prefill.prefill_attention(qt, kt, vt, causal=True, return_lse=True)
    grads += backward.flash_attention_bwd(qt, kt, vt, ot, lse, ot, causal=True,
                                          fused=False)
    outs += [ob, og, ogv] + list(grads)
    torch.cuda.synchronize()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    print(f"minimal fp32 launches {minimal}; library surface fp32 launches {got}",
          flush=True)
    ok &= all(o.dtype == torch.float32 and bool(torch.isfinite(o).all()) for o in outs)
    ok &= all(got.get(f"{n}_fp32", 0) >= 1 for n in FP32_KERNELS + FP32_BWD)
    # no bf16 launch, no plain route
    ok &= not any(n in got for n in FP32_KERNELS + FP32_BWD)
    return ok


def _serve_traffic(params, cfg, quant, graphed, counts, n_req=16, gen_tokens=32):
    """The first engine's traffic (n_req prompts of 200-256 tokens from
    numpy.random.RandomState(SEED), gen_tokens new tokens each) behind a
    fresh Engine on KV pages of 64 rows (quant: their format), the decode
    graphs on or off -> (engine, requests, stats, launches, free pages
    before the run); the launches are added to counts."""
    import numpy as np

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.serve import graphs
    from mfa_tpu_torch.serve.engine import Engine

    graphs._ENABLED = graphed
    try:
        eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                     pages_per_seq=8, quant_dtype=quant, device="cuda")
        free0 = eng.sched.allocator.free_pages
        rng = np.random.RandomState(SEED)
        reqs = [eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))), gen_tokens)
                for n in rng.randint(200, 257, n_req)]
        _build.reset_launches()
        stats = eng.run()
    finally:
        graphs._ENABLED = True
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    return eng, reqs, stats, got, free0


def engine_fp32_phase(counts, ident, state):
    """Main path: Llama-3-8B in fp32 (dataclasses.replace(llama3_8b(),
    dtype=float32): 8.03e9 weights x 4 B = 32.1 GB from the seed; the
    projections torch.matmul in true fp32, TF32 off). The earlier phases'
    weights are freed first. The 8B traffic (16 prompts of 200-256 tokens,
    32 new) on fp32 KV pages and then on int8 KV pages, each graphed and
    with the graphs off (the same tokens): every wave runs kernels 2 + 3
    in fp32, every decode step kernel 6 in fp32 (fp32 q on int8 pages).
    Then the chunked + prefix traffic on int8 KV (kernel 8 with fp32 q;
    kernel 6's split route at its long contexts)."""
    import torch

    from mfa_tpu_torch.models import llama, wquant

    for key in ("params", "cfg"):
        state.pop(key, None)
    torch.cuda.empty_cache()
    ok = torch.backends.cuda.matmul.allow_tf32 is False
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), dtype=torch.float32)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    nbytes = wquant.params_nbytes(params)
    ok &= 32.0e9 < nbytes < 32.2e9
    print(f"engine fp32: Llama-3-8B width, {cfg.n_layers} layers, fp32 weights "
          f"{nbytes / 1e9:.3f} GB from seed {SEED} ({time.perf_counter() - t0:.1f} s "
          f"to build)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    n_req, gen_tokens = 16, 32
    tokens = {}
    for quant in (None, "int8"):
        for graphed in (True, False):
            eng, reqs, stats, got, free0 = _serve_traffic(params, cfg, quant, graphed,
                                                          counts, n_req, gen_tokens)
            tokens[(quant, graphed)] = [list(r.generated) for r in reqs]
            good = all(len(r.generated) == gen_tokens for r in reqs)
            good &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
            good &= eng.sched.allocator.free_pages == free0
            good &= _wave_launches(got, cfg.n_layers * stats.prefill_batches,
                                   suffix="_fp32")
            good &= got.get("paged_fp32", 0) == cfg.n_layers * stats.steps
            good &= not any(n in got for n in FP32_KERNELS)
            good &= (stats.captures >= 1) == graphed
            step_tokens = stats.decode_tokens - n_req
            print(f"engine fp32 ({quant or 'fp32'} KV, graphs {'on' if graphed else 'off'})"
                  f" launches {got}: prefill {stats.prefill_tokens / stats.prefill_s:.1f} "
                  f"tok/s ({stats.prefill_tokens} tokens in {stats.prefill_s:.3f} s), "
                  f"decode {_decode_rates(stats, step_tokens)}, KV "
                  f"{_kv_bytes_per_token(eng.cache):.0f} bytes a token "
                  f"{'ok' if good else 'FAIL'} [{ident}]", flush=True)
            ok &= good
            del eng
            torch.cuda.empty_cache()
    same = {q_: tokens[(q_, True)] == tokens[(q_, False)] for q_ in (None, "int8")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"engine fp32: graphed tokens equal graphs-off tokens: fp32 KV "
          f"{same[None]}, int8 KV {same['int8']}; peak memory {peak_gb:.2f} GB (< 80)",
          flush=True)
    ok &= all(same.values()) and peak_gb < 80
    state.update(params=params, cfg=cfg)
    ok &= chunked_engine_phase(counts, ident, state, "int8", "8B fp32")
    del params  # state keeps them for train_8b_fp32
    torch.cuda.empty_cache()
    print(f"engine fp32: fp32 launches so far {({f'{n}_fp32': counts.get(f'{n}_fp32', 0) for n in FP32_KERNELS})}",
          flush=True)
    ok &= all(counts.get(f"{n}_fp32", 0) > 0 for n in
              ("flagged", "repair", "paged", "paged_prefill"))
    return ok


def _rel_l2(a, r) -> float:
    return float((a.double() - r.double()).norm() / r.double().norm())


def cpu_vs_cuda_fp32_phase():
    """Phase 4 in fp32: 2 layers of the fp32 8B at full width on the card
    (kernels 2 + 3, 6 and 8 in fp32) and on the CPU (plain versions), the
    same weights, on fp32 KV pages: a prompt wave, four decode steps
    teacher-forced on the card's tokens, a 256-token prompt in two 128-token
    chunks and a prefix-hit suffix chunk. Every logit row within relative L2
    1e-4 of the CPU's (fp32 end to end: the two devices differ only in the
    order of their sums)."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    p_gpu = llama.init_params(cfg, seed=SEED + 7, device="cuda")
    p_cpu = dict(layers=[{k: v.cpu() for k, v in lp.items()} for lp in p_gpu["layers"]],
                 **{k: p_gpu[k].cpu() for k in ("embed", "final_norm", "lm_head")})
    rng = np.random.RandomState(SEED + 7)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (37, 90)]
    pages = [[1, 2], [3, 4, 5]]
    long = list(rng.randint(0, cfg.vocab_size, 256))
    hit = long[:128] + list(rng.randint(0, cfg.vocab_size, 60))
    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = llama.build_kv_caches(cfg, 16, 64, 2, 4, None, device=dev)
        cache, lg = llama.prefill_batch(params, cfg, cache, [0, 1], pages, prompts)
        res = [lg]
        forced = out.setdefault("toks", [lg.argmax(-1).cpu()])
        for i in range(4):
            cache, lg = llama.decode_step(params, cfg, cache, [0, 1], forced[i])
            res.append(lg)
            if dev == "cuda":
                forced.append(lg.argmax(-1).cpu())
        cc = llama.build_kv_caches(cfg, 16, 64, 2, 8, None, device=dev)
        for off in (0, 128):
            cc, lg = llama.prefill_chunk_batch(params, cfg, cc, [0], [[6, 7, 8, 9]],
                                               [long[off:off + 128]], [off], [256], 128)
            res.append(lg)
        cc, lg = llama.prefill_chunk_batch(params, cfg, cc, [1], [[6, 7, 10]],
                                           [hit[128:]], [128], [188], 64)
        res.append(lg)
        out[dev] = [x.float().cpu() for x in res]
    names = (["prefill_batch"] + [f"decode_step {i + 1}" for i in range(4)]
             + ["chunk 1 of 2", "chunk 2 of 2", "prefix-hit suffix chunk"])
    ok, worst = True, 0.0
    for name, a, r in zip(names, out["cuda"], out["cpu"]):
        rel = max(_rel_l2(a[i], r[i]) for i in range(a.shape[0]))
        worst = max(worst, rel)
        good = bool(torch.isfinite(a).all()) and rel < 1e-4
        print(f"cuda vs cpu fp32 {name} logits [{tuple(a.shape)}]: largest row "
              f"relative L2 {rel:.3e} (< 1e-4), argmax agree "
              f"{bool(torch.equal(a.argmax(-1), r.argmax(-1)))} {'ok' if good else 'FAIL'}",
              flush=True)
        ok &= good
    print(f"cuda vs cpu fp32: largest relative L2 over every stage {worst:.3e}",
          flush=True)
    return ok


def _grads_close32(got, ref, what):
    """dq, dk and dv (None: skipped) each within torch.allclose(g, r,
    rtol=1e-4, atol=1e-4 max |r|), fp32 and finite: fp32 products in
    another order than the plain version's (and the fused launch's dQ
    additions across blocks). Returns (largest max abs error, ok)."""
    import torch

    worst, ok = 0.0, True
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        if g is None:
            continue
        mx = float((g - r).abs().max())
        atol = 1e-4 * float(r.abs().max())
        good = g.dtype == torch.float32 and bool(torch.isfinite(g).all()) \
            and torch.allclose(g, r, rtol=1e-4, atol=atol)
        print(f"  {what} {name}: max_abs_err {mx:.3e} (allclose rtol 1e-4, atol "
              f"{atol:.3e}) {'ok' if good else 'FAIL'}", flush=True)
        worst, ok = max(worst, mx), ok and good
    return worst, ok


def _sdpa_bwd_ms(q, k, v, do, mask=None):
    """SDPA's backward alone on [b, h, s, d] tensors: autograd.grad over the
    retained graph of one call (is_causal, or a bool band mask;
    enable_gqa). The library time of the backward rows."""
    import torch
    import torch.nn.functional as F

    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    if mask is None:
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    else:
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, enable_gqa=True)
    ms = _time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
                  iters=3)
    del ql, kl, vl, ol
    return ms


def fp32_backward_kernels(records):
    """Phase 2 in fp32, the backward (csrc/flash_bwd_f32.cuh): kernels 11, 12
    and 13 on fp32 inputs against _bwd_plain in fp32 on the card (TF32
    off): the 8B train shape (causal b4 hq32 hkv8 s2048 d128); d 64, 80 and
    256 at b1 hq32 hkv8 s2048; Gemma3-4B's train shape with window (1023,
    0); 4 sinks with window (2047, 0) at b1 s4096 (kernel 11 alone: the
    split refuses sinks); ALiBi, kv_position_offset 1024 and softcap 50 at
    d 256; group 7 (hq28 hkv4). Kernel 14 on 8 x 512 equal lengths (and
    there bit for bit kernels 12 + 13 on the batched data) and on the
    ragged pack, against _varlen_bwd_plain. Limit: torch.allclose(got, ref,
    rtol=1e-4, atol=1e-4 max |ref|) on each of dQ, dK and dV. Timed at
    the 8B and Gemma3 shapes and the two packs: bounds of 10 / 8 / 6 hq d
    flops a visible pair (fused / dK,dV / dQ) at 165 TFLOP/s against the
    4-byte rows at 3.35 TB/s; library: SDPA's backward on the fp32 tensors
    (the pair 12 + 13 beside the same call; batched for the equal-length
    pack; none for the ragged one)."""
    import torch

    from mfa_tpu_torch.kernels import backward, prefill, varlen

    ok = torch.backends.cuda.matmul.allow_tf32 is False \
        and torch.get_float32_matmul_precision() == "highest"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    #   tag, b, hq, hkv, sq, sk, d, (wl, wr), softcap, sinks, offset, alibi, timed
    cases = (("8B train shape, causal", 4, 32, 8, 2048, 2048, 128, (-1, 0), 0.0, 0, 0,
              False, True),
             ("d 64, causal", 1, 32, 8, 2048, 2048, 64, (-1, 0), 0.0, 0, 0, False, False),
             ("d 80, causal", 1, 32, 8, 2048, 2048, 80, (-1, 0), 0.0, 0, 0, False, False),
             ("d 256, causal", 1, 32, 8, 2048, 2048, 256, (-1, 0), 0.0, 0, 0, False, False),
             ("Gemma3-4B train shape, window (1023, 0)", 4, 8, 4, 2048, 2048, 256,
              (1023, 0), 0.0, 0, 0, False, True),
             ("sinks 4, window (2047, 0)", 1, 32, 8, 4096, 4096, 128, (2047, 0), 0.0, 4,
              0, False, False),
             ("ALiBi, causal, d 256", 1, 8, 4, 2048, 2048, 256, (-1, 0), 0.0, 0, 0, True,
              False),
             ("offset 1024, causal, d 256", 1, 8, 4, 2048, 3072, 256, (-1, 0), 0.0, 0,
              1024, False, False),
             ("softcap 50, causal, d 256", 1, 8, 4, 2048, 2048, 256, (-1, 0), 50.0, 0, 0,
              False, False),
             ("group 7: hq28 hkv4", 1, 28, 4, 2048, 2048, 128, (-1, 0), 0.0, 0, 0, False,
              False))
    for tag, b, hq, hkv, sq, sk, d, (wl, wr), cap, sinks, off, alibi, timed in cases:
        scale = d ** -0.5
        q, k, v, do = rn(b, hq, sq, d), rn(b, hkv, sk, d), rn(b, hkv, sk, d), rn(b, hq, sq, d)
        slopes = _alibi_slopes(hq) if alibi else None
        kw = dict(window_size=(wl, wr), logit_softcap=cap, sink_tokens=sinks,
                  kv_position_offset=off, alibi_slopes=slopes)
        o, lse = prefill.prefill_attention(q, k, v, return_lse=True, **kw)
        print(f"fp32 backward {tag}: b={b} hq={hq} hkv={hkv} sq={sq} sk={sk} d={d}",
              flush=True)
        ref = backward._bwd_plain(q, k, v, o, lse, do, scale, wl, wr, cap, sinks, off,
                                  slopes)
        fused = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=True, **kw)
        e_f, good = _grads_close32(fused, ref, "fused")
        errs = {"bwd_fused": e_f}
        if not sinks:
            split = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **kw)
            errs["bwd_dq"], g1 = _grads_close32(split[:1] + (None, None), ref, "split dq")
            errs["bwd_dkv"], g2 = _grads_close32((None,) + split[1:], ref, "split dkv")
            good &= g1 and g2
            del split
        ok &= good
        for n, e in errs.items():
            rec = records[f"{n}_fp32"]
            rec["max_abs_err"] = max(rec.get("max_abs_err") or 0.0, e)
        if timed:
            args = backward._dense_cuda_inputs(q, k, v, o, lse, do) + (scale, wl, wr, cap)
            launch = {"bwd_fused": backward._launch_fused,
                      "bwd_dkv": backward._launch_dkv, "bwd_dq": backward._launch_dq}
            ms = {n: _time_ms(lambda fn=fn: fn(*args), iters=3) for n, fn in launch.items()}
            plain_ms = _time_ms(lambda: backward._bwd_plain(
                q, k, v, o, lse, do, scale, wl, wr, cap), iters=2)
            lib_ms = _sdpa_bwd_ms(q, k, v, do, None if wl < 0 else _band_mask(sq, wl, "cuda"))
            pairs = b * hq * _visible_pairs(sq, sk, off, wl, wr, sinks)
            qb, kb, row_b = b * hq * sq * d * 4, b * hkv * sk * d * 4, b * hq * sq * 4
            work = {"bwd_fused": (4 * qb + 4 * kb + row_b, 10 * pairs * d),
                    "bwd_dkv": (2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d),
                    "bwd_dq": (2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)}
            for n in launch:
                _record32(records, n, f"{n} {tag}", errs[n], ms[n], plain_ms, lib_ms,
                          *work[n])
            print(f"  pair 12 + 13 {ms['bwd_dkv'] + ms['bwd_dq']:.4f} ms; fused / SDPA "
                  f"{ms['bwd_fused'] / lib_ms:.2f}x, pair / SDPA "
                  f"{(ms['bwd_dkv'] + ms['bwd_dq']) / lib_ms:.2f}x", flush=True)
            del args
        del q, k, v, do, o, lse, ref, fused
        torch.cuda.empty_cache()

    # kernel 14: 8 x 512 equal lengths (bit for bit 12 + 13 batched) and the
    # ragged pack, causal, at the 8B heads
    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5
    for tag, lens in (("8 x 512 equal lengths", [512] * 8),
                      ("ragged pack", [200, 1100, 512, 300, 700, 384, 450, 450])):
        n = sum(lens)
        q, do, k, v = rn(n, hq, d), rn(n, hq, d), rn(n, hkv, d), rn(n, hkv, d)
        cu = torch.tensor([0] + lens, device="cuda").cumsum(0).int()
        o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens),
                                         causal=True, return_lse=True)
        print(f"fp32 varlen backward {tag}: lens {lens} hq={hq} hkv={hkv} d={d}",
              flush=True)
        got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu, causal=True)
        ref = backward._varlen_bwd_plain(q, k, v, o, lse, do, cu, cu, scale, -1, 0, 0.0)
        e_q, g1 = _grads_close32(got[:1] + (None, None), ref, "varlen dq")
        e_kv, g2 = _grads_close32((None,) + got[1:], ref, "varlen dkv")
        ok &= g1 and g2
        lib_ms = None
        if len(set(lens)) == 1:
            s = lens[0]

            def batched(t):  # [n, h, d] -> [8, h, s, d]
                return t.view(len(lens), s, t.shape[1], d).transpose(1, 2).contiguous()

            dense = backward.flash_attention_bwd(
                batched(q), batched(k), batched(v), batched(o),
                lse.view(hq, len(lens), s).transpose(0, 1), batched(do), causal=True,
                fused=False)
            same = all(torch.equal(batched(a), b_) for a, b_ in zip(got, dense))
            print(f"  kernel 14 bit for bit kernels 12 + 13 on the batched data: {same}",
                  flush=True)
            ok &= same
            lib_ms = _sdpa_bwd_ms(batched(q), batched(k), batched(v), batched(do))
            del dense
        args = backward._varlen_cuda_inputs(q, k, v, o, lse, do, cu, cu)
        tail = (cu, cu, max(lens), scale, -1, 0, 0.0)
        ms_kv = _time_ms(lambda: backward._launch_varlen_dkv(*args, *tail), iters=3)
        ms_q = _time_ms(lambda: backward._launch_varlen_dq(*args, *tail), iters=3)
        plain_ms = _time_ms(lambda: backward._varlen_bwd_plain(
            q, k, v, o, lse, do, cu, cu, scale, -1, 0, 0.0), iters=2)
        pairs = hq * sum(_visible_pairs(x, x, 0, -1, 0) for x in lens)
        qb, kb, row_b = n * hq * d * 4, n * hkv * d * 4, n * hq * 4
        _record32(records, "varlen_bwd_dkv", f"varlen_bwd_dkv {tag}", e_kv, ms_kv,
                  plain_ms, lib_ms, 2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d)
        _record32(records, "varlen_bwd_dq", f"varlen_bwd_dq {tag}", e_q, ms_q, plain_ms,
                  lib_ms, 2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)
        del q, k, v, do, o, lse, got, ref, args
        torch.cuda.empty_cache()
    return ok


def fp32_wmatmul_kernels(records):
    """Phase 2 in fp32, kernel 10 on fp32 x (csrc/wmatmul.cu: three bf16
    parts of x against one conversion of W, fp32 out) against
    _int8_matmul_plain in fp32 (TF32 off): m 16 at the 8B projections wq,
    wk, w_gate, w_down and the lm_head, m 3601 at w_gate; its expert
    launch at Mixtral-8x7B's dense decode (m 16, 8 experts: gate / up over
    shared rows, down over each expert's) and grouped wave (7202
    expert-sorted rows, one expert empty, one of a single row) shapes.
    Limit: max |a - r| <= 1e-5 max |r|. Bounds: the int8 weight and 4-byte
    x and out at 3.35 TB/s against 2 m K N operations at 330 TFLOP/s
    (three bf16 passes at 989); library: torch.matmul on the
    fp32-dequantized weight (one an expert over host-known bounds for the
    grouped form)."""
    import torch

    from mfa_tpu_torch.kernels import wmatmul
    from mfa_tpu_torch.models.wquant import dequantize_weight, quantize_weight

    ok = torch.backends.cuda.matmul.allow_tf32 is False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 44)

    def check(name, tag, out, ref):
        mx = float((out - ref).abs().max())
        lim = 1e-5 * float(ref.abs().max())
        good = out.dtype == torch.float32 and bool(torch.isfinite(out).all()) and mx <= lim
        print(f"{name} {tag}: max_abs_err {mx:.3e} (<= {lim:.3e}) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        return mx, good

    for tag, m, K, N in (("wq", 16, 4096, 4096), ("wk", 16, 4096, 1024),
                         ("w_gate", 16, 4096, 14336), ("w_down", 16, 14336, 4096),
                         ("lm_head", 16, 4096, 128256), ("w_gate", 3601, 4096, 14336)):
        x = torch.randn(m, K, generator=gen, device="cuda")
        w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5)
        splits, per = wmatmul.split_k(m, K, N, f32=True)
        tag = (f"{tag} m={m} K={K} N={N} fp32 x, {wmatmul.block_m(m, True)} rows a "
               f"block, {splits} K split(s)")
        mx, good = check("wmatmul_fp32", tag, wmatmul.int8_matmul(x, w.qw, w.scale),
                         wmatmul._int8_matmul_plain(x, w.qw, w.scale, torch.float32))
        ok &= good
        ms = _time_ms(lambda: wmatmul.int8_matmul(x, w.qw, w.scale))
        plain_ms = _time_ms(lambda: wmatmul._int8_matmul_plain(x, w.qw, w.scale,
                                                               torch.float32), iters=5)
        wd = dequantize_weight(w, torch.float32)
        lib_ms = _time_ms(lambda: torch.matmul(x, wd))
        _record32(records, "wmatmul", tag, mx, ms, plain_ms, lib_ms,
                  K * N + 4 * N + 4 * m * K + 4 * m * N, 2 * m * K * N, PEAK_W32_FLOPS)
        del x, w, wd
    torch.cuda.empty_cache()

    def offsets(sizes):
        return torch.tensor([0, *torch.tensor(sizes).cumsum(0).tolist()],
                            dtype=torch.int32, device="cuda")

    sizes = (1500, 1100, 0, 1303, 1, 1298, 1000, 1000)
    for K, N, per_expert in ((4096, 14336, False), (14336, 4096, True)):
        E = 8
        w = quantize_weight(torch.randn(E, K, N, generator=gen, device="cuda") * K ** -0.5)
        wd = dequantize_weight(w, torch.float32)
        proj = "gate/up" if K == 4096 else "down"
        for form in ("dense", "grouped"):
            if form == "dense":
                x = torch.randn(*((E,) if per_expert else ()), 16, K, generator=gen,
                                device="cuda")
                offs, rows = None, 16
            else:
                x = torch.randn(sum(sizes), K, generator=gen, device="cuda")
                offs, rows = offsets(sizes), sum(sizes)
            mr = None if offs is None else max(sizes)
            tag = f"Mixtral {form} {proj}: E={E} rows={rows} K={K} N={N} fp32 x"
            mx, good = check("wmatmul_bank_fp32", tag, wmatmul.int8_bank_matmul(
                x, w.qw, w.scale, offs=offs, max_rows=mr),
                wmatmul._bank_plain(x, w.qw, w.scale, offs, torch.float32))
            ok &= good
            ms = _time_ms(lambda: wmatmul.int8_bank_matmul(x, w.qw, w.scale, offs=offs,
                                                           max_rows=mr))
            plain_ms = _time_ms(lambda: wmatmul._bank_plain(x, w.qw, w.scale, offs,
                                                            torch.float32), iters=3)
            if offs is None:
                lib_ms = _time_ms(lambda: torch.matmul(x, wd))
                flops = 2 * E * rows * K * N
                nbytes = E * K * N + 4 * E * N + x.numel() * 4 + E * rows * N * 4
            else:
                b = offs.tolist()
                lib_ms = _time_ms(lambda: [torch.matmul(x[b[e]:b[e + 1]], wd[e])
                                           for e in range(E)])
                flops = 2 * rows * K * N
                nbytes = E * K * N + 4 * E * N + rows * (K + N) * 4 + 4 * (E + 1)
            _record32(records, "wmatmul_bank", tag, mx, ms, plain_ms, lib_ms, nbytes, flops,
                      PEAK_W32_FLOPS)
            del x
        del w, wd
        torch.cuda.empty_cache()
    return ok


def engine_fp32_int8w_phase(counts, ident, state):
    """Main path: Llama-3-8B in fp32 on int8 weights. The fp32 weights the
    train phase left (the fp32 engine's, trained three steps) quantized with
    wquant.quantize_params(include_embed=False): every projection and the
    lm_head int8 per output channel, the embedding kept fp32, so the
    activations stay fp32 and every projection runs kernel 10 on fp32 x
    (three bf16 parts, launch name wmatmul_fp32); the fp32 weights freed
    first. The first engine's traffic (16 prompts of 200-256 tokens, 32 new)
    on int8 KV pages, graphed and with the graphs off (the same tokens):
    every wave kernels 2 + 3 in fp32, every decode step kernel 6 with fp32
    q. Weight bytes, peak memory, prefill and decode rates."""
    import torch

    from mfa_tpu_torch.models import wquant

    params, cfg = state.pop("params"), state.pop("cfg")
    ok = cfg.dtype == torch.float32
    qparams = wquant.quantize_params(params, include_embed=False)
    del params
    torch.cuda.empty_cache()
    nbytes = wquant.params_nbytes(qparams)
    emb = qparams["embed"].numel() * 4
    print(f"engine fp32 int8 weights: Llama-3-8B width, {cfg.n_layers} layers, "
          f"{nbytes / 1e9:.3f} GB of weights ({(nbytes - emb) / 1e9:.3f} GB int8 "
          f"projections, lm_head, scales and norms, {emb / 1e9:.3f} GB fp32 embedding)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    n_req, gen_tokens, L = 16, 32, cfg.n_layers
    tokens = {}
    for graphed in (True, False):
        eng, reqs, stats, got, free0 = _serve_traffic(qparams, cfg, "int8", graphed, counts,
                                                      n_req, gen_tokens)
        tokens[graphed] = [list(r.generated) for r in reqs]
        passes = stats.prefill_batches + stats.steps
        good = all(len(r.generated) == gen_tokens for r in reqs)
        good &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
        good &= eng.sched.allocator.free_pages == free0
        good &= got.get("wmatmul_fp32", 0) == (7 * L + 1) * passes
        good &= _wave_launches(got, L * stats.prefill_batches, suffix="_fp32")
        good &= got.get("paged_fp32", 0) == L * stats.steps
        good &= not any(n in got for n in FP32_KERNELS + ("wmatmul",))
        good &= (stats.captures >= 1) == graphed
        step_tokens = stats.decode_tokens - n_req
        print(f"engine fp32 int8 weights (int8 KV, graphs {'on' if graphed else 'off'}) "
              f"launches {got}: wmatmul_fp32 = (7 x {L} + lm_head) x ({stats.prefill_batches}"
              f" waves + {stats.steps} steps); prefill "
              f"{stats.prefill_tokens / stats.prefill_s:.1f} tok/s ({stats.prefill_tokens} "
              f"tokens in {stats.prefill_s:.3f} s), decode {_decode_rates(stats, step_tokens)} "
              f"{'ok' if good else 'FAIL'} [{ident}]", flush=True)
        ok &= good
        del eng
        torch.cuda.empty_cache()
    same = tokens[True] == tokens[False]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"engine fp32 int8 weights: graphed tokens equal graphs-off tokens {same}; "
          f"weights {nbytes / 1e9:.3f} GB, peak memory {peak_gb:.2f} GB (< 80) [{ident}]",
          flush=True)
    ok &= same and peak_gb < 80
    del qparams
    torch.cuda.empty_cache()
    return ok


def engine_mixtral_fp32_phase(counts, ident, state):
    """Main path: Mixtral-8x7B at full width on int8 weights and expert banks
    with fp32 activations, its depth cut to 4 layers (the fp32 activations,
    not the weights, are what this part adds; full depth runs in
    engine_mixtral_8x7b): init_params(quantize="int8") on the fp32 config,
    then the embedding dequantized to fp32, so every projection runs kernel
    10 on fp32 x and every MoE layer its expert launch on fp32 x
    (wmatmul_bank_fp32: the dense form in decode steps, the grouped form in
    waves). The first engine's traffic on int8 KV, graphed and with the
    graphs off: the same tokens."""
    import torch

    from mfa_tpu_torch.models import llama, wquant

    for key in ("params", "cfg"):
        state.pop(key, None)
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LlamaConfig.mixtral_8x7b(), n_layers=4,
                              dtype=torch.float32)
    params = llama.init_params(cfg, seed=SEED, device="cuda", quantize="int8")
    params["embed"] = wquant.dequantize_weight(params["embed"], torch.float32)
    torch.cuda.synchronize()
    print(f"engine Mixtral fp32: {cfg.n_layers} of 32 layers at full width, int8 "
          f"weights and banks, fp32 embedding: {wquant.params_nbytes(params) / 1e9:.3f} GB",
          flush=True)
    ok, tokens, L = True, {}, cfg.n_layers
    for graphed in (True, False):
        eng, reqs, stats, got, _ = _serve_traffic(params, cfg, "int8", graphed, counts)
        tokens[graphed] = [list(r.generated) for r in reqs]
        passes = stats.prefill_batches + stats.steps
        good = all(len(r.generated) == 32 for r in reqs)
        good &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
        good &= got.get("wmatmul_bank_fp32", 0) == 3 * L * passes
        good &= got.get("wmatmul_fp32", 0) == (4 * L + 1) * passes
        good &= not any(n in got for n in ("wmatmul", "wmatmul_bank"))
        print(f"engine Mixtral fp32 (graphs {'on' if graphed else 'off'}) launches {got}: "
              f"wmatmul_bank_fp32 = 3 x {L} x {passes} passes; prefill "
              f"{stats.prefill_tokens / stats.prefill_s:.1f} tok/s, decode "
              f"{_decode_rates(stats, stats.decode_tokens - 16)} {'ok' if good else 'FAIL'} "
              f"[{ident}]", flush=True)
        ok &= good
        del eng
        torch.cuda.empty_cache()
    same = tokens[True] == tokens[False]
    print(f"engine Mixtral fp32: graphed tokens equal graphs-off tokens {same}", flush=True)
    del params
    torch.cuda.empty_cache()
    return ok and same


def cpu_vs_cuda_fp32_train_phase():
    """Phase 4, the fp32 backward and kernel 10 on fp32 x: 2 layers of the
    fp32 8B at full width, the same weights on the card and on the CPU
    (plain versions) through params_from_numpy (a numpy tree of mfa_tpu's
    layout, layers stacked): the int8-weight forward (quantize_params with
    the embedding kept fp32: kernel 10 on fp32 x against the plain
    product) on 1 x 257 tokens, every logit row within relative L2 1e-4;
    then one SGD step on the same tokens (kernels 2 + 3 and 11 in fp32):
    the loss within relative 1e-5 and every gradient tensor within
    relative L2 1e-4 (fp32 end to end; the devices differ in the order of
    their sums)."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama, wquant

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    src = llama.init_params(cfg, seed=SEED + 9, device="cpu")
    tree = {k: src[k].numpy() for k in ("embed", "final_norm", "lm_head")}
    tree["layers"] = {k: np.stack([lp[k].numpy() for lp in src["layers"]])
                      for k in src["layers"][0]}
    del src
    p = {dev: llama.params_from_numpy(tree, cfg, dev) for dev in ("cuda", "cpu")}
    del tree
    toks = np.random.RandomState(SEED + 9).randint(0, cfg.vocab_size, (1, 257))
    logits, res = {}, {}
    for dev in ("cuda", "cpu"):
        _build.reset_launches()
        with torch.no_grad():
            logits[dev] = llama.forward(wquant.quantize_params(p[dev], include_embed=False),
                                        torch.as_tensor(toks, device=dev), cfg).float().cpu()
        fwd = dict(_build.launches)
        _build.reset_launches()
        params, loss = llama.train_step(p[dev], toks, cfg, lr=1.0)
        res[dev] = (float(loss), [t.grad.cpu() for t in llama.param_tensors(params)],
                    fwd, dict(_build.launches))
        for t in llama.param_tensors(params):
            t.grad = None
    a, r = logits["cuda"][0], logits["cpu"][0]
    rel = max(_rel_l2(a[i], r[i]) for i in range(a.shape[0]))
    ok = bool(torch.isfinite(a).all()) and rel < 1e-4
    ok &= res["cuda"][2].get("wmatmul_fp32", 0) == 7 * cfg.n_layers + 1
    print(f"cuda vs cpu fp32, int8-weight forward logits [{tuple(a.shape)}] (launches "
          f"{res['cuda'][2]}): largest row relative L2 {rel:.3e} (< 1e-4), argmax agree "
          f"{bool(torch.equal(a.argmax(-1), r.argmax(-1)))} {'ok' if ok else 'FAIL'}",
          flush=True)
    lc, lp = res["cuda"][0], res["cpu"][0]
    worst = max(_rel_l2(g, h) for g, h in zip(res["cuda"][1], res["cpu"][1]))
    good = abs(lc - lp) <= 1e-5 * abs(lp) and worst <= 1e-4
    good &= res["cuda"][3].get("bwd_fused_fp32", 0) == cfg.n_layers
    print(f"cuda vs cpu fp32 train_step (2 layers at full width, 1 x 257 tokens, SGD; "
          f"launches {res['cuda'][3]}): loss {lc:.7f} vs {lp:.7f} (relative "
          f"{abs(lc - lp) / abs(lp):.2e} <= 1e-5); largest gradient relative L2 over "
          f"{len(res['cpu'][1])} tensors {worst:.3e} (<= 1e-4) {'ok' if good else 'FAIL'}",
          flush=True)
    del p, params
    torch.cuda.empty_cache()
    return ok and good


def main() -> int:
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this script measures the port on a GPU")
    try:
        from mfa_tpu_torch.kernels import _build
    except ImportError as e:
        return _fail(f"the mfa_tpu_torch package is not next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    ident = smi[0].strip() if smi else "nvidia-smi: n/a"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({ident})", flush=True)

    # 1. build
    try:
        secs = _build.build_all()
    except RuntimeError as e:
        return _fail(f"kernel build: {e}")
    print(f"build: {len(_build.SOURCES)} sources with nvcc for sm_90a in "
          f"{secs:.1f} s", flush=True)

    sources = {
        "prefill": ("mfa_tpu_torch/csrc/prefill.cu",
                    "mfa_tpu/kernels/prefill.py:178"),
        "decode": ("mfa_tpu_torch/csrc/decode_sm90.cuh",
                   "mfa_tpu/kernels/decode.py:53"),
        "paged": ("mfa_tpu_torch/csrc/decode_sm90.cuh",
                  "mfa_tpu/kernels/paged.py:122"),
        "paged_fp8": ("mfa_tpu_torch/csrc/decode_sm90.cuh",
                      "mfa_tpu/kernels/paged.py:122"),
        "paged_int4": ("mfa_tpu_torch/csrc/decode_sm90.cuh",
                       "mfa_tpu/kernels/paged.py:122"),
        "paged_span": ("mfa_tpu_torch/csrc/decode_sm90.cuh",
                       "mfa_tpu/kernels/paged.py:122"),
        "varlen": ("mfa_tpu_torch/csrc/flash_fwd_sm90.cuh",
                   "mfa_tpu/kernels/varlen.py:53"),
        "paged_prefill": ("mfa_tpu_torch/csrc/paged_prefill.cu",
                          "mfa_tpu/kernels/paged_prefill.py:50"),
        "paged_prefill_fp8": ("mfa_tpu_torch/csrc/paged_prefill.cu",
                              "mfa_tpu/kernels/paged_prefill.py:50"),
        "paged_prefill_int4": ("mfa_tpu_torch/csrc/paged_prefill.cu",
                               "mfa_tpu/kernels/paged_prefill.py:50"),
        "bwd_fused": ("mfa_tpu_torch/csrc/flash_bwd_sm90.cuh",
                      "mfa_tpu/kernels/backward.py:163"),
        "bwd_dkv": ("mfa_tpu_torch/csrc/flash_bwd_sm90.cuh",
                    "mfa_tpu/kernels/backward.py:413"),
        "bwd_dq": ("mfa_tpu_torch/csrc/flash_bwd_sm90.cuh",
                   "mfa_tpu/kernels/backward.py:513"),
        "varlen_bwd_dkv": ("mfa_tpu_torch/csrc/flash_bwd_sm90.cuh",
                           "mfa_tpu/kernels/backward.py:1060"),
        "varlen_bwd_dq": ("mfa_tpu_torch/csrc/flash_bwd_sm90.cuh",
                          "mfa_tpu/kernels/backward.py:1142"),
        "blockmask": ("mfa_tpu_torch/csrc/flash_fwd_sm90.cuh",
                      "mfa_tpu/kernels/blockmask.py:54"),
        "flagged": ("mfa_tpu_torch/csrc/bound.cu",
                    "mfa_tpu/kernels/prefill.py:697"),
        "repair": ("mfa_tpu_torch/csrc/bound.cu",
                   "mfa_tpu/kernels/prefill.py:738"),
        "bound": ("mfa_tpu_torch/csrc/bound.cu",
                  "mfa_tpu/kernels/prefill.py:661"),
        "wmatmul": ("mfa_tpu_torch/csrc/wmatmul.cu",
                    "mfa_tpu/kernels/wmatmul.py:34"),
        "wmatmul_bank": ("mfa_tpu_torch/csrc/wmatmul.cu",
                         "mfa_tpu/kernels/wmatmul.py:34"),
        # fp32 inputs: the fp32 tile
        "prefill_fp32": ("mfa_tpu_torch/csrc/flash_fwd_f32.cuh",
                         "mfa_tpu/kernels/prefill.py:178"),
        "flagged_fp32": ("mfa_tpu_torch/csrc/flash_fwd_f32.cuh",
                         "mfa_tpu/kernels/prefill.py:697"),
        "repair_fp32": ("mfa_tpu_torch/csrc/flash_fwd_f32.cuh",
                        "mfa_tpu/kernels/prefill.py:738"),
        "bound_fp32": ("mfa_tpu_torch/csrc/flash_fwd_f32.cuh",
                       "mfa_tpu/kernels/prefill.py:661"),
        "decode_fp32": ("mfa_tpu_torch/csrc/decode_sm90.cuh",
                        "mfa_tpu/kernels/decode.py:53"),
        "paged_fp32": ("mfa_tpu_torch/csrc/decode_sm90.cuh",
                       "mfa_tpu/kernels/paged.py:122"),
        "varlen_fp32": ("mfa_tpu_torch/csrc/flash_fwd_f32.cuh",
                        "mfa_tpu/kernels/varlen.py:53"),
        "paged_prefill_fp32": ("mfa_tpu_torch/csrc/paged_prefill.cu",
                               "mfa_tpu/kernels/paged_prefill.py:50"),
        "blockmask_fp32": ("mfa_tpu_torch/csrc/flash_fwd_f32.cuh",
                           "mfa_tpu/kernels/blockmask.py:54"),
        # fp32 inputs of the backward (the fp32 tile) and of kernel 10 (x
        # split into three bf16 parts)
        "bwd_fused_fp32": ("mfa_tpu_torch/csrc/flash_bwd_f32.cuh",
                           "mfa_tpu/kernels/backward.py:163"),
        "bwd_dkv_fp32": ("mfa_tpu_torch/csrc/flash_bwd_f32.cuh",
                         "mfa_tpu/kernels/backward.py:413"),
        "bwd_dq_fp32": ("mfa_tpu_torch/csrc/flash_bwd_f32.cuh",
                        "mfa_tpu/kernels/backward.py:513"),
        "varlen_bwd_dkv_fp32": ("mfa_tpu_torch/csrc/flash_bwd_f32.cuh",
                                "mfa_tpu/kernels/backward.py:1060"),
        "varlen_bwd_dq_fp32": ("mfa_tpu_torch/csrc/flash_bwd_f32.cuh",
                               "mfa_tpu/kernels/backward.py:1142"),
        "wmatmul_fp32": ("mfa_tpu_torch/csrc/wmatmul.cu",
                         "mfa_tpu/kernels/wmatmul.py:34"),
        "wmatmul_bank_fp32": ("mfa_tpu_torch/csrc/wmatmul.cu",
                              "mfa_tpu/kernels/wmatmul.py:34"),
    }
    records = {n: {"name": n, "route": "cuda", "source": s, "replaces": r}
               for n, (s, r) in sources.items()}
    phases = {}
    counts = {}
    state = {}
    shard = {}  # the sharding phases' spawned ranks
    phase_fns = (("kernels", lambda: kernel_phase(records)),
                 ("sinks_kernels", sinks_kernels),
                 ("head_dim_kernels", head_dim_kernels),
                 ("decode_groups", decode_groups),
                 ("page_rows_kernels", lambda: page_rows_kernels(records)),
                 ("fp32_kernels", lambda: fp32_kernels(records)),
                 ("fp32_backward_kernels", lambda: fp32_backward_kernels(records)),
                 ("fp32_wmatmul_kernels", lambda: fp32_wmatmul_kernels(records)),
                 ("library_surface", lambda: library_surface(counts)),
                 ("layer_cache", lambda: layer_cache_phase(counts, ident)),
                 ("minimal_fp32", lambda: minimal_fp32_phase(counts)),
                 ("engine_8b", lambda: engine_phase(counts, ident, state)),
                 ("tp_engine_8b",
                  lambda: tp_engine_phase(counts, ident, state, shard)),
                 ("cp_ring_8b", lambda: cp_ring_phase(counts, ident, shard)),
                 ("ep_mixtral", lambda: ep_phase(counts, ident, shard)),
                 ("pipeline_8b", lambda: pipeline_phase(counts, ident, shard)),
                 ("engine_8b_kvq", lambda: kvq_engine_phase(counts, ident, state)),
                 ("chunked_prefix_engine_8b",
                  lambda: chunked_engine_phase(counts, ident, state)),
                 ("chunked_prefix_engine_8b_page1",
                  lambda: chunked_engine_phase(counts, ident, state, pages=(512 * 64, 64 * 64),
                                               page=1)),
                 ("chunked_prefix_engine_8b_int4",
                  lambda: chunked_engine_phase(counts, ident, state, "int4")),
                 ("chunked_prefix_engine_8b_fp8",
                  lambda: chunked_engine_phase(counts, ident, state, "fp8")),
                 ("engine_8b_burst",
                  lambda: burst_engine_phase(counts, ident, state)),
                 ("engine_8b_pressure", lambda: pressure_engine_phase(counts, ident)),
                 ("engine_8b_sampling",
                  lambda: sampling_engine_phase(counts, ident, state)),
                 ("engine_8b_speculative",
                  lambda: speculative_engine_phase(counts, ident, state)),
                 ("server_8b", lambda: server_phase(counts, ident, state)),
                 ("train_8b", lambda: train_phase(counts, ident, state)),
                 ("engine_gemma3_4b_vision",
                  lambda: engine_gemma3_phase(counts, ident, state)),
                 ("chunked_prefix_engine_gemma3_4b",
                  lambda: chunked_engine_phase(counts, ident, state, "int8",
                                               "Gemma3-4B")),
                 ("chunked_prefix_engine_gemma3_4b_int4",
                  lambda: chunked_engine_phase(counts, ident, state, "int4",
                                               "Gemma3-4B")),
                 ("chunked_prefix_engine_gemma3_4b_fp8",
                  lambda: chunked_engine_phase(counts, ident, state, "fp8",
                                               "Gemma3-4B")),
                 ("train_gemma3_4b",
                  lambda: train_phase(counts, ident, state, "Gemma3-4B")),
                 ("engine_8b_int8w", lambda: engine_int8w_phase(counts, ident)),
                 ("checkpoint_qwen2_7b", lambda: checkpoint_phase(counts, ident)),
                 ("chunked_prefix_engine_qwen2_7b",
                  lambda: family_engine_phase(counts, ident, state, "Qwen2-7B")),
                 ("chunked_prefix_engine_gemma2_9b",
                  lambda: family_engine_phase(counts, ident, state, "Gemma2-9B")),
                 ("engine_mixtral_8x7b",
                  lambda: engine_mixtral_phase(counts, ident, state)),
                 ("engine_mistral_7b_sinks",
                  lambda: engine_mistral_sinks_phase(counts, ident, state)),
                 ("train_mistral_7b_sinks",
                  lambda: train_phase(counts, ident, state, "Mistral-7B-sinks",
                                      (1, 8192))),
                 ("engine_danube_1_8b",
                  lambda: engine_danube_phase(counts, ident, state)),
                 ("train_danube_1_8b",
                  lambda: train_phase(counts, ident, state, "H2O-Danube-1.8B")),
                 ("engine_8b_fp32", lambda: engine_fp32_phase(counts, ident, state)),
                 ("train_8b_fp32",
                  lambda: train_phase(counts, ident, state, "Llama-3-8B fp32", keep=True)),
                 ("engine_8b_fp32_int8w",
                  lambda: engine_fp32_int8w_phase(counts, ident, state)),
                 ("engine_mixtral_fp32",
                  lambda: engine_mixtral_fp32_phase(counts, ident, state)),
                 ("cuda_vs_cpu", cpu_vs_cuda_phase),
                 ("cuda_vs_cpu_gemma3", cpu_vs_cuda_gemma3_phase),
                 ("cuda_vs_cpu_int8w", cpu_vs_cuda_int8w_phase),
                 ("cuda_vs_cpu_families", cpu_vs_cuda_families_phase),
                 ("cuda_vs_cpu_moe", cpu_vs_cuda_moe_phase),
                 ("cuda_vs_cpu_sinks", cpu_vs_cuda_sinks_phase),
                 ("cuda_vs_cpu_danube", cpu_vs_cuda_danube_phase),
                 ("cuda_vs_cpu_fp32", cpu_vs_cuda_fp32_phase),
                 ("cuda_vs_cpu_fp32_train", cpu_vs_cuda_fp32_train_phase),
                 ("instruments", lambda: instruments_phase(ident)))
    try:
        for name, fn in phase_fns:
            t0 = time.perf_counter()
            try:
                phases[name] = bool(fn())
            except Exception as e:  # report the phase, then fail the run
                import traceback

                traceback.print_exc()
                print(f"phase {name} raised {type(e).__name__}: {e}", flush=True)
                phases[name] = False
            print(f"phase {name}: {'ok' if phases[name] else 'FAIL'} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        _close_ranks(shard)
    for n in sources:
        records[n]["launches"] = int(counts.get(n, 0))
        if records[n]["launches"] == 0:
            phases.setdefault(f"launched_{n}", False)
    if not all(phases.values()):
        return _fail(f"phases {phases}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: records[n].get(k) for k in keys}
                                  for n in sources]}), flush=True)
    print(ident, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
