#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving loop, on one GPU.

    python3 scripts/profile_torch_engine.py [--layers 32] [--steps 8] [--out FILE]
        [--phases bf16,chunk,train,int8,gemma3] (also: pipeline, fp8kv, int4kv,
        sampling, spec, train_fp32, decode_fp32, split_decode) [--root DIR]

Builds the Llama-3-8B-width engine of chip_smoke.py (random bf16 weights
from a seed, int8 paged KV, page 64), warms it with one short run, then
admits 16 requests of 200-256 prompt tokens into a fresh engine and
traces one prefill wave and `--steps` decode steps with torch.profiler:
issued eagerly, replayed from the decode graphs (serve/graphs.py) one
step a readback, and in graphed bursts of 8.
Every wave runs the default prefill engine (the zero-shift kernel and its
repair). Then an engine with chunked prefill (chunks of 512) takes 4 prompts of
4000 tokens and traces one chunk batch: 4 x 512 tokens at q_start 1536
(after three untraced warm chunks). Last, with the same weights, one SGD
train step of the model on 4 x 2049 tokens with remat (after one untraced
warm step). Then, with those weights freed, the same model with int8
weights (init_params(quantize="int8"): every projection and the lm_head
on the int8 matmul kernel) traces the same wave and decode steps. Last,
Gemma3-4B at full width and
depth with its 27-layer SigLIP tower (random bf16 weights, int8 paged KV):
one image wave of chip_smoke.py's 6 image prompts (7 images of 896 x
896), after one untraced warm wave, and the tower alone on the same 7
images; the tower's trace splits the wave's device time into the tower,
the text projections, the glue and kernel 9; then one wave of its 4 text
prompts and `--steps` decode steps of them (eager, then graphed).
--phases fp8kv / int4kv trace the bf16 model's wave and decode steps on
fp8 (e4m3) or int4 KV pages (kernel 6 on those pages). --phases sampling
traces the bf16 model's decode steps with chip_smoke.py's sampled mix
(engine top-k 50; 4 greedy rows, 4 at temperature 0.8 / top-p 0.9, 4 at
temperature 1.0 / min-p 0.05, 4 greedy with repetition penalty 1.3) and
times the sampler alone on [16, vocab] logits. --phases spec times the
pieces of a greedy speculative iteration at the 8B target with
chip_smoke.py's Llama-3.2-1B-shaped draft (batch 16, int8 KV, k 4), each
a CUDA graph replayed back to back: one draft decode step, one verify of
4 tokens, the acceptance, the whole iteration and, beside them, one
target decode step; from these, the acceptance rate at which an
iteration emits tokens as fast as graphed decode. --phases train_fp32
traces one SGD train step of the model in fp32 (`dtype=float32`, fp32
weights from seed 0, 4 x 2049 tokens, remat, after one untraced warm
step): fp32 cuBLAS projections ("matmul"), the fp32 forward attention
kernels 2 + 3 ("zero-shift prefill kernels"), kernel 11 on the fp32
backward tile ("backward kernel") and the glue. --phases decode_fp32
traces the fp32 model (the same weights) serving the 16 requests on fp32
and then on int8 KV pages: a prefill wave and `--steps` decode steps,
eager, graphed and in graphed bursts of 8, by kernel group (kernel 6 with
fp32 q is "paged kernel", the projections fp32 cuBLAS). --phases
split_decode traces decode steps whose paged kernel splits each sequence
(grids under the card's 132 SMs), eager, graphed and in graphed bursts,
with the device ms of a graph replay: the 8B model (`--layers`) on 2
requests of 1000-1100 tokens (int8 KV, 8 splits), Mistral-7B with 4
attention sinks at `--layers` on chip_smoke.py's 8 prompts of 4200-6000
tokens (bf16 KV, 2 splits), and Gemma3-4B's text stack at full depth on
4 prompts of 300-1800 tokens (int8 KV, window 1023, 16 blocks). --root DIR imports
mfa_tpu_torch from another checkout (e.g. the parent commit unpacked
with git archive), so two versions compare in one call, one process
each. For each phase it prints the host wall time (with and without the
profiler), the device time summed over kernels, the device busy share
(kernel time / wall time) and the kernel time by group and by name;
--out FILE also writes the full profiler tables there. Needs a CUDA
device; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# kernels 1-4, 7 and 9 are instantiations of one template, fa90::fwd_kernel<T,
# D, kind, packed> (csrc/flash_fwd_sm90.cuh): kind 0 is kernel 1 (or 7,
# packed), 1-4 the zero-shift engines (flagged, repair, bound, unchecked), 5
# the image-block kernel (9). Kernel 8 is pp90::paged_prefill_kernel, kernel
# 10 wm90::wmatmul_kernel. Kernel 5's launch 1 and kernel 6 are
# kd90::splitkv_kernel<T, D, paged, KV format>: paged true is kernel 6, which
# merges its splits in the same launch; a checkout before that (--root)
# merged them in combine_kernel, a launch of its own, counted with the paged
# kernel (the engine reached it only from kernel 6).
_FA90 = re.compile(r"fa90::fwd_kernel<[^,]+, (?:\(int\))?\d+, (?:\(int\))?(\d)[,>]")
# their fp32 tile: af32::fwd_kernel<D, kind, packed> (csrc/flash_fwd_f32.cuh)
_AF32 = re.compile(r"af32::fwd_kernel<(?:\(int\))?\d+, (?:\(int\))?(\d)[,>]")
# kernel 10's expert-bank launch: wmatmul_kernel<T, OutT, BMX, BANK = true>
_BANK = re.compile(r"wmatmul_kernel<[^>]*, (?:\(bool\))?(?:true|1)>")
_PAGED = re.compile(r"splitkv_kernel<[^,]+, [^,]+, (?:\(bool\))?(?:true|1)[,>]")
# an older checkout's fp32 decode tile (--root): af32::decode_kernel<D, paged, F>
_PAGED_OLD32 = re.compile(r"af32::decode_kernel<(?:\(int\))?\d+, (?:\(bool\))?(?:true|1)[,>]")
GROUPS = (("prefill kernel", ()),
          ("zero-shift prefill kernels", ()),
          ("int8 expert-bank launch", ()),
          ("int8 matmul kernel", ("wmatmul_kernel",)),
          ("split-KV decode kernel", ("splitkv_kernel",)),
          ("image-block kernel", ()),
          ("paged prefill kernel", ("paged_prefill_kernel",)),
          ("paged kernel", ("combine_kernel",)),
          ("backward kernel", ("bwd_kernel", "bwd_dq_kernel")),
          ("loss (softmax, nll)", ("SoftMax", "nll_loss")),
          ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "splitk")),
          ("elementwise / copy / reduce", ()))


def _group(name: str) -> str:
    if _PAGED.search(name) or _PAGED_OLD32.search(name):
        return "paged kernel"
    if _BANK.search(name):
        return "int8 expert-bank launch"
    m = _FA90.search(name) or _AF32.search(name)
    if m:
        kind = m.group(1)
        return GROUPS[0][0] if kind == "0" else "image-block kernel" if kind == "5" \
            else GROUPS[1][0]
    for g, keys in GROUPS:
        if any(k in name for k in keys):
            return g
    return GROUPS[-1][0]


def _device_rows(prof):
    import torch

    rows = []
    for r in prof.key_averages():
        if getattr(r, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(r, "self_device_time_total", None)
        if us is None:
            us = r.self_cuda_time_total
        rows.append((r.key, r.count, us / 1e3))
    return rows


def _report(tag, prof, wall_ms, plain_ms, n_units, unit, out):
    rows = _device_rows(prof)
    dev_ms = sum(ms for _, _, ms in rows)
    print(f"{tag}: wall {wall_ms:.3f} ms traced, {plain_ms:.3f} ms untraced "
          f"per {unit} ({n_units} {unit}s); device kernels {dev_ms / n_units:.3f} "
          f"ms per {unit}; device busy share {dev_ms / (wall_ms * n_units):.3f} "
          f"traced, {dev_ms / (plain_ms * n_units):.3f} untraced", flush=True)
    groups = collections.Counter()
    for name, _, ms in rows:
        groups[_group(name)] += ms
    for g, ms in groups.most_common():
        print(f"  {g}: {ms / n_units:.3f} ms per {unit} "
              f"({ms / max(dev_ms, 1e-9):.1%})", flush=True)
    for name, count, ms in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"    {ms / n_units:8.3f} ms  x{count // n_units:<5d} {name[:90]}",
              flush=True)
    out.write(f"== {tag}\n")
    try:
        table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60)
    except (AttributeError, KeyError):
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60)
    out.write(table + "\n")
    return {g: ms / n_units for g, ms in groups.items()}, dev_ms / n_units


def gemma3_waves(acts, out_path, steps) -> None:
    """Gemma3-4B image wave: device time of the wave by group, and of the
    tower alone on the same images (its matmuls and elementwise kernels
    are subtracted from the wave's to leave the text stack's); then a text
    wave of chip_smoke.py's 4 text prompts (300-1800 tokens: the zero-shift
    kernels 2 + 3 at head_dim 256, window 1023 on 5 layers of 6), and
    `steps` decode steps of those 4 requests (the paged kernel at d 256 on
    a grid of 16 blocks: its split route)."""
    import numpy as np
    import torch
    from torch.profiler import profile

    from chip_smoke import IMAGE_TOKEN, _gemma3_prompts
    from mfa_tpu_torch.models import llama, vision
    from mfa_tpu_torch.serve.engine import Engine

    cfg, vcfg = llama.LlamaConfig.gemma3_4b(), vision.SiglipVisionConfig()
    params = llama.init_params(cfg, seed=0, device="cuda")
    vparams = vision.init_vision_params(vcfg, cfg.dim, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    prompts, n_images, _ = _gemma3_prompts(rng, n_text=0)
    pixels = [rng.standard_normal((n, 3, vcfg.image_size, vcfg.image_size)
                                  ).astype(np.float32) for n in n_images]

    def engine():
        eng = Engine(params, cfg, num_pages=256, page_size=64, max_seqs=8,
                     pages_per_seq=40, quant_dtype="int8", device="cuda",
                     vision=(vparams, vcfg, IMAGE_TOKEN))
        for p, px in zip(prompts, pixels):
            eng.submit(p, 1, images=px)
        return eng

    def wave(eng):
        t0 = time.perf_counter()
        eng._prefill_admitted(eng.sched.admit())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wave(engine())  # warm-up
    plain = wave(engine())
    eng = engine()
    n_tok = sum(len(p) for p in prompts)
    with open(out_path or os.devnull, "a") as out:
        with profile(activities=acts) as prof:
            wall = wave(eng)
        g_wave, dev_wave = _report(
            f"gemma3 image wave ({len(prompts)} prompts, {sum(n_images)} images, "
            f"{n_tok} tokens, {cfg.n_layers} layers)", prof, wall, plain, 1, "wave",
            out)
        every = torch.cat([torch.as_tensor(p, device="cuda") for p in pixels])

        def tower():
            t0 = time.perf_counter()
            vision.gemma3_image_features(vparams, every, vcfg)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        tower()
        plain = tower()
        with profile(activities=acts) as prof:
            wall = tower()
        g_tower, dev_tower = _report(
            f"gemma3 vision tower + projector alone ({len(every)} images)", prof,
            wall, plain, 1, "call", out)
    mm, ew = "matmul", "elementwise / copy / reduce"
    proj = g_wave.get(mm, 0.0) - g_tower.get(mm, 0.0)
    glue = (g_wave.get(ew, 0.0) + g_wave.get("loss (softmax, nll)", 0.0)
            - g_tower.get(ew, 0.0) - g_tower.get("loss (softmax, nll)", 0.0))
    k9 = g_wave.get("image-block kernel", 0.0)
    print(f"gemma3 image wave by group: vision tower + projector {dev_tower:.3f} ms "
          f"({dev_tower / dev_wave:.1%}), text projections {proj:.3f} ms "
          f"({proj / dev_wave:.1%}), text glue {glue:.3f} ms ({glue / dev_wave:.1%}), "
          f"kernel 9 {k9:.3f} ms ({k9 / dev_wave:.1%}) of {dev_wave:.3f} ms device",
          flush=True)

    _, _, texts = _gemma3_prompts(np.random.RandomState(1), 0, 0, 4)

    def text_engine(n_new=1):
        eng = Engine(params, cfg, num_pages=256, page_size=64, max_seqs=8,
                     pages_per_seq=40, quant_dtype="int8", device="cuda")
        for p in texts:
            eng.submit(p, n_new)
        return eng

    wave(text_engine())  # warm-up
    plain = wave(text_engine())
    eng = text_engine(2 * steps + 4)
    with open(out_path or os.devnull, "a") as out:
        with profile(activities=acts) as prof:
            wall = wave(eng)
        _report(f"gemma3 text wave ({len(texts)} prompts, {sum(map(len, texts))} "
                f"tokens, {cfg.n_layers} layers)", prof, wall, plain, 1, "wave", out)
    del eng
    decode_steps(lambda: text_engine(2 * steps + 4), steps, acts, out_path,
                 f"gemma3 decode step (batch {len(texts)}, {cfg.n_layers} layers)")


def decode_steps(make_engine, steps, acts, out_path, what) -> None:
    """Decode steps of a fresh engine's requests, after its prefill and one
    untraced step (where the graph of the bucket is captured): `steps`
    steps issued eagerly (graphs off), `steps` replayed from the decode
    graphs (serve/graphs.py) one step a readback, and `steps` in graphed
    bursts of 8 (step_burst); each untraced, then traced. Prints the wall
    and device time per step and the host ops that took the most time."""
    import torch
    from torch.profiler import profile

    from mfa_tpu_torch.serve import graphs

    for mode, burst in (("eager", 1), ("graphed", 1),
                        ("graphed, bursts of 8", 8)):
        graphs._ENABLED = mode != "eager"
        try:
            eng = make_engine()
            eng.step()  # the prefill wave and the first decode step

            def run():
                torch.cuda.synchronize()
                t0, s0 = time.perf_counter(), eng.stats.steps
                for _ in range(max(1, steps // burst)):
                    eng.step() if burst == 1 else eng.step_burst(burst)
                torch.cuda.synchronize()
                n = eng.stats.steps - s0
                return (time.perf_counter() - t0) * 1e3 / n, n

            plain, _ = run()
            with open(out_path or os.devnull, "a") as out:
                with profile(activities=acts) as prof:
                    wall, n = run()
                _report(f"{what}, {mode}", prof, wall, plain, n, "step", out)
            host = sorted(((r.key, r.self_cpu_time_total / 1e3)
                           for r in prof.key_averages()), key=lambda r: -r[1])
            print("  host ops by self time per step: " + ", ".join(
                f"{k} {ms / n:.3f} ms" for k, ms in host[:6]), flush=True)
            if mode == "graphed":
                replay_times(eng)
        finally:
            graphs._ENABLED = True


def replay_times(eng, reps: int = 5) -> None:
    """Untraced: host ms of one graph launch (replay() alone, the stream
    idle before it), and device ms per replay of `reps` replays back to
    back between two CUDA events (kernels plus the gaps between them).
    The replays decode past the engine's requests: the engine is done."""
    import torch

    (b,) = eng.graphs.buckets.values()
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.graph.replay()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        b.graph.replay()
    end.record()
    torch.cuda.synchronize()
    print(f"  one replay: host {min(host):.3f} ms (min of {reps}, "
          f"median {sorted(host)[reps // 2]:.3f}), device "
          f"{start.elapsed_time(end) / reps:.3f} ms per replay back to back",
          flush=True)


def pipeline_phase(params, cfg, acts, out_path, pairs: int = 5) -> None:
    """chip_smoke.py's 8B traffic (16 requests of 200-256 prompt tokens, 32
    new tokens) through run(burst=8, pipeline=False) and run(burst=8) in
    turns, each on a fresh engine whose graph is captured by a short warm
    run first: the decode seconds (from the first burst's dispatch to the
    last readback) of `pairs` pairs; then one traced run of each, whose
    device busy share over that span shows whether the card idles between
    bursts."""
    import numpy as np
    import torch
    from torch.profiler import profile

    from mfa_tpu_torch.serve.engine import Engine

    def run(pipeline, traced=False):
        eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                     pages_per_seq=8, quant_dtype="int8", device="cuda")
        rng = np.random.RandomState(0)
        prompts = [list(rng.randint(0, cfg.vocab_size, int(n)))
                   for n in rng.randint(200, 257, 16)]
        for p in prompts:
            eng.submit(p, 2)
        eng.run()  # captures the bucket of 16
        for p in prompts:
            eng.submit(p, 32)
        eng._prefill_admitted(eng.sched.admit())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if traced:
            with profile(activities=acts) as prof:
                eng.run(burst=8, pipeline=pipeline)
        else:
            prof = None
            eng.run(burst=8, pipeline=pipeline)
        ms = (time.perf_counter() - t0) * 1e3
        return ms, eng.stats.steps - 1, eng.stats.readbacks - 1, prof

    run(False), run(True)  # warm-up
    walls = {False: [], True: []}
    for i in range(pairs):
        for pipeline in ((False, True) if i % 2 == 0 else (True, False)):
            walls[pipeline].append(run(pipeline)[0])
    for pipeline in (False, True):
        w = sorted(walls[pipeline])
        print(f"8B bf16 bursts of 8, pipeline={pipeline}: decode "
              f"{w[len(w) // 2]:.3f} ms median of {pairs} runs "
              f"({', '.join(f'{x:.3f}' for x in walls[pipeline])})", flush=True)
    with open(out_path or os.devnull, "a") as out:
        for pipeline in (False, True):
            ms, steps, readbacks, prof = run(pipeline, traced=True)
            _report(f"8B bf16 bursts of 8, pipeline={pipeline} ({steps} steps, "
                    f"{readbacks} readbacks)", prof, ms / steps,
                    sorted(walls[pipeline])[pairs // 2] / steps, steps,
                    "step", out)


def serve_phase(params, cfg, steps, acts, out_path, tag, kv="int8") -> None:
    """16 requests of 200-256 prompt tokens on `kv` KV pages: one traced
    prefill wave, then `steps` traced decode steps (each untraced first for
    the plain wall)."""
    import numpy as np
    import torch
    from torch.profiler import profile

    from mfa_tpu_torch.serve.engine import Engine

    def engine(n_new):
        eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                     pages_per_seq=8, quant_dtype=kv, device="cuda")
        rng = np.random.RandomState(0)
        for n in rng.randint(200, 257, 16):
            eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))), n_new)
        return eng

    engine(4).run()  # warm-up: cuBLAS handles, allocator, kernel libraries
    untraced = engine(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    untraced._prefill_admitted(untraced.sched.admit())
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    del untraced
    eng = engine(2 * steps + 4)
    with open(out_path or os.devnull, "a") as out:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng._flush_released()
            eng._prefill_admitted(eng.sched.admit())
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        _report(f"{tag}prefill wave (16 prompts, {eng.stats.prefill_tokens} tokens, "
                f"{cfg.n_layers} layers)", prof, wall, plain, 1, "wave", out)
    del eng
    decode_steps(lambda: engine(2 * steps + 4), steps, acts, out_path,
                 f"{tag}decode step (batch 16, {cfg.n_layers} layers)")


def sampling_phase(params, cfg, steps, acts, out_path) -> None:
    """Decode steps of chip_smoke.py's sampled mix (eager, graphed, graphed
    bursts: decode_steps), then the sampler alone: sample_dynamic with the
    engine's top-k, presence rows and its noise, plus the logprobs, on
    [16, vocab] fp32 logits, device ms per call (chip_smoke._time_ms)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from mfa_tpu_torch.serve.engine import Engine
    from mfa_tpu_torch.serve.sampling import (SamplingParams, gumbel_from_uniform,
                                              sample, sample_dynamic,
                                              token_logprobs, uniform_noise)

    mix = [SamplingParams(**m) if m else None for m in cs.SAMPLING_MIX]

    def engine():
        eng = Engine(params, cfg, num_pages=128, page_size=64, max_seqs=16,
                     pages_per_seq=8, quant_dtype="int8", device="cuda",
                     sampling=SamplingParams(top_k=50), seed=0)
        rng = np.random.RandomState(0)
        for i, n in enumerate(rng.randint(200, 257, 16)):
            eng.submit(list(rng.randint(0, cfg.vocab_size, int(n))), 2 * steps + 4,
                       sampling=mix[i // 4])
        return eng

    engine().run()  # warm-up
    decode_steps(engine, steps, acts, out_path,
                 "sampled mix decode step (batch 16, top-k 50, 4 x 4 rows)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(16, cfg.vocab_size, generator=gen, device="cuda") * 3
    pres = torch.rand(16, cfg.vocab_size, generator=gen, device="cuda") < 0.002
    vecs = torch.tensor([[0.0] * 4 + [0.8] * 4 + [1.0] * 4 + [0.0] * 4,
                         [1.0] * 4 + [0.9] * 4 + [1.0] * 8,
                         [0.0] * 8 + [0.05] * 4 + [0.0] * 4,
                         [1.0] * 12 + [1.3] * 4], device="cuda")

    def sampler():
        g = gumbel_from_uniform(uniform_noise(tuple(logits.shape), gen, "cuda"))
        ids = sample_dynamic(logits, g, *vecs, top_k=50, presence=pres)
        return token_logprobs(logits, ids)

    def greedy():
        return token_logprobs(logits, sample(logits))

    ms, ms_g = cs._time_ms(sampler), cs._time_ms(greedy)
    print(f"sampler alone on [16, {cfg.vocab_size}] fp32 logits: mixed rows with "
          f"top-k 50, presence and noise {ms:.4f} ms of device time a call; greedy "
          f"argmax + logprob {ms_g:.4f} ms; the sampler adds {ms - ms_g:.4f} ms a "
          f"step", flush=True)


def _replay_ms(graph, reps: int = 5) -> float:
    """Device ms per replay of `reps` replays back to back (CUDA events)."""
    import torch

    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spec_phase(params, cfg, k: int = 4) -> None:
    """The pieces of a greedy speculative iteration, each captured into a
    CUDA graph and replayed back to back: one draft decode step, one
    verify_step of k tokens, the acceptance (argmax, prefix, emitted
    tokens, logprobs, both caches' lengths), the whole iteration
    (SpeculativeGraphs), and one target decode step (DecodeGraphs). The
    draft step and verify graphs put the lengths they advance back, so
    their replays read the same cache. Break-even: with each draft token accepted with
    probability p, an iteration emits 1 + p + ... + p^(k-1) tokens a row;
    it matches graphed decode when that equals iteration / decode step,
    at acceptance rate (p + ... + p^k) / k."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import EngineStats
    from mfa_tpu_torch.serve.graphs import (DecodeGraphs, SpeculativeGraphs,
                                            _Captures)
    from mfa_tpu_torch.serve.sampling import token_logprobs

    dcfg = cs.llama32_1b_draft_config(cfg)
    dparams = llama.init_params(dcfg, seed=5, device="cuda")
    n, pps, page = 16, 8, 64
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(0, cfg.vocab_size, int(m)))
               for m in rng.randint(200, 257, n)]
    pages = [list(range(1 + i * pps, 1 + (i + 1) * pps)) for i in range(n)]
    caches = []
    for p, c in ((params, cfg), (dparams, dcfg)):
        cache = llama.build_kv_caches(c, n * pps + 1, page, n, pps, "int8",
                                      device="cuda")
        cache, logits = llama.prefill_batch(p, c, cache, list(range(n)), pages,
                                            prompts)
        caches.append(cache)
    cache, dcache = caches
    slots = torch.arange(n, device="cuda")
    toks = logits.argmax(-1)
    stats = EngineStats()
    cap = _Captures(torch.device("cuda"), stats)
    feed = torch.stack([toks] * k, 1)
    d_static = feed.clone()

    def draft_step():
        llama.greedy_step(dparams, dcfg, dcache, slots, toks)
        dcache.lengths[slots] -= 1

    def verify():
        _, lg = llama.verify_step(params, cfg, cache, slots, feed)
        cache.lengths[slots] -= k
        return lg

    g_draft, _, _ = cap.capture(draft_step)
    g_verify, v_logits, _ = cap.capture(verify)

    def accept():
        base = cache.lengths[slots]
        a = torch.argmax(v_logits, dim=-1)
        m = torch.cumprod((d_static == a).long(), dim=1).sum(dim=1)
        n_emit = torch.where(m < k, m + 1, torch.full_like(m, k))
        pos = torch.arange(k, device="cuda")[None]
        t_out = torch.where(pos < m[:, None], d_static, a)
        token_logprobs(v_logits, t_out)
        new_lens = (base.long() + n_emit).to(base.dtype)
        cache.lengths[slots] = new_lens
        dcache.lengths[slots] = new_lens
        torch.gather(t_out, 1, (n_emit - 1)[:, None])

    g_accept, _, _ = cap.capture(accept)
    ms_draft, ms_verify, ms_accept = (_replay_ms(g) for g in (g_draft, g_verify,
                                                               g_accept))
    sg = SpeculativeGraphs(params, dparams, cfg, dcfg, torch.device("cuda"), stats)
    sg.burst(cache, dcache, slots, toks, k, 1)
    ms_iter = _replay_ms(sg.buckets[(n, k)].graph)
    dg = DecodeGraphs(params, cfg, torch.device("cuda"), stats)
    dg.burst(cache, slots, toks, 1)
    ms_dec = _replay_ms(dg.buckets[n].graph)
    ratio = ms_iter / ms_dec
    p_star = None
    for p in np.linspace(0.0, 1.0, 100001):
        if sum(p ** i for i in range(k)) >= ratio:
            p_star = p
            break
    acc = (sum(p_star ** i for i in range(1, k + 1)) / k
           if p_star is not None else None)
    print(f"speculative iteration pieces (batch {n}, k {k}, int8 KV, lens 200-256; "
          f"8B target, Llama-3.2-1B-shaped draft), device ms a replay: draft step "
          f"{ms_draft:.3f} (x{k} = {k * ms_draft:.3f}), verify of {k} tokens "
          f"{ms_verify:.3f}, acceptance {ms_accept:.3f}; whole iteration "
          f"{ms_iter:.3f}; target decode step {ms_dec:.3f} (verify / decode "
          f"{ms_verify / ms_dec:.3f})", flush=True)
    print(f"break-even: an iteration must emit {ratio:.3f} tokens a row; "
          + (f"per-token acceptance p = {p_star:.4f}, acceptance rate "
             f"(spec_accepted / spec_proposed) {acc:.4f}" if p_star is not None
             else f"more than k = {k}: no acceptance rate breaks even"), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="file for the full profiler tables")
    ap.add_argument("--phases", default="bf16,chunk,train,int8,gemma3",
                    help="comma-separated subset of bf16 (wave + decode), "
                         "pipeline (bursts of 8 with and without the "
                         "pipeline), chunk, train, int8 (wave + decode on "
                         "int8 weights), gemma3, fp8kv, int4kv (wave + decode "
                         "on fp8 / int4 KV pages), sampling (the sampled "
                         "mix's decode steps, the sampler alone), spec (a "
                         "speculative iteration's pieces), train_fp32 (a "
                         "train step of the fp32 model), decode_fp32 (the "
                         "fp32 model's wave and decode steps on fp32 and "
                         "int8 KV), split_decode (decode steps on the paged "
                         "kernel's split route: 8B at batch 2, Mistral-7B "
                         "sinks, Gemma3-4B)")
    ap.add_argument("--root", default=ROOT,
                    help="checkout to import mfa_tpu_torch from")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    sys.path.insert(0, os.path.abspath(args.root))

    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("profile_torch_engine: needs a CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    _build.build_all()
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=args.layers)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        open(args.out, "w").close()
    if phases & {"bf16", "pipeline", "chunk", "train", "fp8kv", "int4kv",
                  "sampling", "spec"}:
        bf16_phases(cfg, phases, args, acts)
        torch.cuda.empty_cache()
    if "int8" in phases:
        params = llama.init_params(cfg, seed=0, device="cuda", quantize="int8")
        serve_phase(params, cfg, args.steps, acts, args.out, "int8 weights, ")
        del params
        torch.cuda.empty_cache()
    if "gemma3" in phases:
        gemma3_waves(acts, args.out, args.steps)
    if "train_fp32" in phases:
        train_fp32_phase(cfg, args, acts)
    if "decode_fp32" in phases:
        decode_fp32_phase(cfg, args, acts)
    if "split_decode" in phases:
        split_decode_phase(cfg, args, acts)
    print(f"card: {smi}", flush=True)
    return 0


def train_fp32_phase(cfg, args, acts) -> None:
    """One traced SGD train step of the fp32 model (4 x 2048 tokens, remat),
    after one untraced warm step and one timed untraced step."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import profile

    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device="cuda")
    tokens = torch.as_tensor(
        np.random.RandomState(2).randint(0, cfg.vocab_size, (4, 2049)),
        device="cuda")

    def train():
        llama.train_step(params, tokens, cfg, lr=1.0, remat=True)
        torch.cuda.synchronize()

    train()  # warm-up: autograd, the kernels, gradient buffers
    t0 = time.perf_counter()
    train()
    plain = (time.perf_counter() - t0) * 1e3
    with open(args.out or os.devnull, "a") as out:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            train()
            wall = (time.perf_counter() - t0) * 1e3
        _report(f"fp32 train step (4 x 2048 tokens, remat, SGD, {cfg.n_layers} "
                f"layers, mfa_tpu_torch from {os.path.abspath(args.root)})", prof,
                wall, plain, 1, "step", out)
    print(f"fp32 train step: {plain:.1f} ms untraced, "
          f"{4 * 2048 / plain * 1e3:.1f} tok/s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del params
    torch.cuda.empty_cache()


def split_decode_phase(cfg, args, acts) -> None:
    """decode_steps on the paged kernel's split route (one launch a layer
    that merges its splits; before, a second, combine, launch a layer): the
    8B model at batch 2, Mistral-7B with sinks, Gemma3-4B's text stack."""
    import dataclasses

    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import paged
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine

    root = os.path.abspath(args.root)
    runs = (
        ("8B", cfg, [1000, 1100], dict(num_pages=2 * 32 + 1, pages_per_seq=32,
                                       quant_dtype="int8")),
        ("Mistral-7B, 4 sinks", dataclasses.replace(
            llama.LlamaConfig.mistral_7b(), attn_sinks=4, n_layers=args.layers),
         list(np.random.RandomState(0).randint(4200, 6001, 8)),
         dict(num_pages=8 * 128 + 8, pages_per_seq=128)),
        ("Gemma3-4B text", llama.LlamaConfig.gemma3_4b(),
         [300 + (1500 * i) // 3 for i in range(4)],
         dict(num_pages=4 * 32 + 1, pages_per_seq=32, quant_dtype="int8")),
    )
    for name, c, lens, kw in runs:
        params = llama.init_params(c, seed=0, device="cuda")
        kv = kw.get("quant_dtype") or "bf16"
        splits = paged.split_plan(len(lens), c.n_kv_heads, kw["pages_per_seq"], 64)[0]

        def engine(c=c, params=params, lens=lens, kw=kw):
            eng = Engine(params, c, page_size=64, max_seqs=len(lens), device="cuda",
                         **kw)
            rng = np.random.RandomState(1)
            for n in lens:
                eng.submit(list(rng.randint(0, c.vocab_size, int(n))),
                           2 * args.steps + 4)
            return eng

        engine().run()  # warm-up
        decode_steps(engine, args.steps, acts, args.out,
                     f"{name} decode step (batch {len(lens)}, {c.n_layers} layers, "
                     f"{kv} KV, kernel 6 at {splits} splits, mfa_tpu_torch from "
                     f"{root})")
        del params
        torch.cuda.empty_cache()


def decode_fp32_phase(cfg, args, acts) -> None:
    """serve_phase of the fp32 model (fp32 weights from seed 0) on fp32 KV
    pages, then on int8 KV pages."""
    import dataclasses

    import torch

    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device="cuda")
    for kv in (None, "int8"):
        serve_phase(params, cfg, args.steps, acts, args.out,
                    f"fp32, {kv or 'fp32'} KV (mfa_tpu_torch from "
                    f"{os.path.abspath(args.root)}), ", kv)
    del params
    torch.cuda.empty_cache()


def bf16_phases(cfg, phases, args, acts) -> None:
    """The bf16 8B model: a wave and decode steps, a chunk batch, a train
    step (those of `phases`)."""
    import numpy as np
    import torch
    from torch.profiler import profile

    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine

    params = llama.init_params(cfg, seed=0, device="cuda")
    if "bf16" in phases:
        serve_phase(params, cfg, args.steps, acts, args.out, "")
    for kv in ("fp8", "int4"):
        if f"{kv}kv" in phases:
            serve_phase(params, cfg, args.steps, acts, args.out, f"{kv} KV, ", kv)
    if "pipeline" in phases:
        pipeline_phase(params, cfg, acts, args.out)
    if "sampling" in phases:
        sampling_phase(params, cfg, args.steps, acts, args.out)
    if "spec" in phases:
        spec_phase(params, cfg)

    def chunk_engine():
        """4 prompts of 4000 tokens, advanced by 3 chunks of 512 (the
        chunk batch's shapes are then warm); the next chunk starts at
        q_start 1536."""
        e = Engine(params, cfg, num_pages=4 * 64 + 1, page_size=64,
                   max_seqs=16, pages_per_seq=64, quant_dtype="int8",
                   prefill_chunk=512, device="cuda")
        rng = np.random.RandomState(1)
        for _ in range(4):
            e.submit(list(rng.randint(0, cfg.vocab_size, 4000)), 1)
        e._prefill_admitted(e.sched.admit())
        for _ in range(3):
            e._advance_chunked_prefill()
        torch.cuda.synchronize()
        return e

    if "chunk" in phases:
        eng = chunk_engine()
        t0 = time.perf_counter()
        eng._advance_chunked_prefill()
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        del eng
        eng = chunk_engine()
        with open(args.out or os.devnull, "a") as out:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                eng._advance_chunked_prefill()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            _report(f"chunk batch (4 x 512 tokens at q_start 1536, "
                    f"{cfg.n_layers} layers)", prof, wall, plain, 1, "batch", out)
        del eng
        torch.cuda.empty_cache()
    if "train" not in phases:
        return

    tokens = torch.as_tensor(
        np.random.RandomState(2).randint(0, cfg.vocab_size, (4, 2049)),
        device="cuda")

    def train():
        llama.train_step(params, tokens, cfg, lr=1.0, remat=True)
        torch.cuda.synchronize()

    train()  # warm-up: autograd, the backward kernel, gradient buffers
    t0 = time.perf_counter()
    train()
    plain = (time.perf_counter() - t0) * 1e3
    with open(args.out or os.devnull, "a") as out:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            train()
            wall = (time.perf_counter() - t0) * 1e3
        _report(f"train step (4 x 2048 tokens, remat, SGD, {cfg.n_layers} "
                f"layers)", prof, wall, plain, 1, "step", out)


if __name__ == "__main__":
    sys.exit(main())
