#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mfa_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Build every kernel from mfa_tpu_torch/csrc with nvcc (sm_90a).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes: max/mean abs error within bf16 tolerances (max < 2e-2,
   mean < 2e-3, SURVEY.md §4; the plain version runs on the same inputs
   upcast to fp32), and times with CUDA events: kernel, plain version, one
   PyTorch library call for the same function where one exists (a
   yardstick only: the port never calls it), and the least time the card
   could take (bytes over 3.35 TB/s vs operations over 989 TFLOP/s).
3. The main path, with every launch count zeroed just before it and read
   just after: the library surface (flash_attn_func, flash_attn_with_kvcache
   contiguous and paged), then the serving engine at Llama-3-8B width
   (32 layers, random bf16 weights from a seed, int8 paged KV, page 64)
   answering 16 requests of 200-256 prompt tokens and 32 new tokens each.
4. The same model cut to 2 layers, on the card (kernels) and on the CPU
   (plain versions) with the same weights: prefill and decode logits agree.
5. A JSON line of per-kernel numbers, the card's name and power limit, and
   last the {"ok": true, "device": ...} line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
SEED = 0


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
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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
        o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True)
        ro, rl = prefill._prefill_plain(q.float(), k.float(), v.float(), scale,
                                        -1, 0, 0.0, True)
        tag = f"prefill causal b={b} hq={hq} hkv={hkv} s={s} d={d} bf16"
        print(tag, flush=True)
        mx, good = _err(o, ro, what="O")
        ok &= good and _lse_err(lse, rl, "")
        ms = _time_ms(lambda: prefill.prefill_attention(q, k, v, causal=True))
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

    # -- kernel 2: split-KV decode + combine (b=16, S=8192)
    from mfa_tpu_torch.kernels import _build

    b, hq, hkv, S = 16, 32, 8, 8192
    q, kc, vc = rn(b, hq, d), rn(b, hkv, S, d), rn(b, hkv, S, d)
    lens = torch.full((b,), S, dtype=torch.int32, device=dev)
    heur = decode.num_splits_heuristic(b, hkv, S, decode.TILE)
    kv_bytes = 2 * b * hkv * S * d * 2
    bound_ms, by = _bound(kv_bytes + 2 * b * hq * d * 2 + b * hq * 4,
                          4 * b * hq * S * d)
    for ns in (1, heur):
        nsp, tps = decode.split_layout(S, ns)
        o, lse = decode.decode_attention(q, kc, vc, lens, num_splits=ns,
                                         return_lse=True)
        po, pl = decode._decode_partials_plain(q.float(), kc.float(), vc.float(),
                                               lens, d ** -0.5, nsp, tps, -1, 0.0)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        print(f"decode b={b} hq={hq} hkv={hkv} S={S} d={d} num_splits={nsp} bf16",
              flush=True)
        mx, good = _err(o, ro.reshape(b, hq, d), what="O")
        ok &= good and _lse_err(lse, rl.reshape(b, hq), "")
        for name in ("decode", "combine"):
            records[name]["max_abs_err"] = max(
                records[name].get("max_abs_err", 0.0), mx)
        # each launch alone through its C function, the plain versions, and
        # one library call computing the whole decode
        o_part = torch.empty((b, hkv, nsp, hq // hkv, d), device=dev)
        lse_part = torch.empty((b, hkv, nsp, hq // hkv), device=dev)
        out, lse_o = torch.empty_like(q), torch.empty((b, hq), device=dev)
        fn1 = _build.function("decode", "mfa_decode_partials",
                              decode._PARTIALS_ARGTYPES)
        fn2 = _build.function("decode", "mfa_decode_combine",
                              decode._COMBINE_ARGTYPES)
        stream = _build.stream_of(q)
        scale_log2e = d ** -0.5 * math.log2(math.e)
        ms1 = _time_ms(lambda: fn1(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                   lens.data_ptr(), o_part.data_ptr(),
                                   lse_part.data_ptr(), 1, b, hq, hkv, S, d,
                                   nsp, tps, -1, scale_log2e, 0.0, 0.0, stream))
        ms2 = _time_ms(lambda: fn2(o_part.data_ptr(), lse_part.data_ptr(),
                                   out.data_ptr(), lse_o.data_ptr(), 1, b, hq,
                                   hkv, nsp, d, stream))
        plain_ms = _time_ms(lambda: decode._decode_partials_plain(
            q, kc, vc, lens, d ** -0.5, nsp, tps, -1, 0.0), iters=3)
        plain_comb = _time_ms(lambda: decode.combine_splits(o_part, lse_part))
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True))
        print(f"  launch 1 ms {ms1:.4f} (plain {plain_ms:.4f}), combine launch "
              f"ms {ms2:.4f} (plain {plain_comb:.4f}), library_ms(sdpa) "
              f"{lib_ms:.4f}, bound_ms {bound_ms:.4f} ({by})", flush=True)
        if ns == heur:
            records["decode"].update(ms=ms1, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=by,
                                     library_ms=lib_ms)
            part_bytes = b * hkv * nsp * (hq // hkv) * (d + 1) * 4
            cb, cby = _bound(part_bytes + b * hq * (d * 2 + 4),
                             3 * b * hq * nsp * d)
            records["combine"].update(ms=ms2, plain_ms=plain_comb,
                                      bound_ms=cb, bound_by=cby,
                                      library_ms=None)

    # -- kernel 3: paged decode (page 64, pos_offset=1, LSE)
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
    return ok


def library_surface(counts):
    """Main path, part 1: the reference library's own entry points."""
    import torch

    import mfa_tpu_torch
    from mfa_tpu_torch.kernels import _build

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    _build.reset_launches()
    q, k, v = rn(16, 256, 32, 128), rn(16, 256, 8, 128), rn(16, 256, 8, 128)
    o1 = mfa_tpu_torch.flash_attn_func(q, k, v, causal=True)
    qd = rn(16, 1, 32, 128)
    kc, vc = rn(16, 8192, 8, 128), rn(16, 8192, 8, 128)
    o2 = mfa_tpu_torch.flash_attn_with_kvcache(qd, kc, vc, cache_seqlens=8192)
    kp, vp = rn(256, 64, 8, 128), rn(256, 64, 8, 128)
    table = torch.arange(1, 1 + 16 * 4, device="cuda",
                         dtype=torch.int32).reshape(16, 4)
    o3 = mfa_tpu_torch.flash_attn_with_kvcache(qd, kp, vp, cache_seqlens=200,
                                               block_table=table)
    torch.cuda.synchronize()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    print(f"library surface launches {got}", flush=True)
    ok = all(bool(torch.isfinite(o.float()).all()) for o in (o1, o2, o3))
    ok &= o1.shape == q.shape and o2.shape == qd.shape and o3.shape == qd.shape
    ok &= all(got.get(n, 0) >= 1 for n in ("prefill", "decode", "combine", "paged"))
    return ok


def engine_phase(counts, ident):
    """Main path, part 2: the serving engine at Llama-3-8B width."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device="cuda")
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
    ok = all(len(r.generated) == gen_tokens for r in reqs)
    ok &= all(all(math.isfinite(x) for x in r.logprobs) for r in reqs)
    ok &= eng.sched.allocator.free_pages == free0
    ok &= got.get("prefill", 0) == cfg.n_layers * stats.prefill_batches
    ok &= got.get("paged", 0) == cfg.n_layers * stats.steps
    step_tokens = stats.decode_tokens - n_req  # first tokens come from prefill
    print(f"engine launches {got}: prefill = {cfg.n_layers} layers x "
          f"{stats.prefill_batches} waves, paged = {cfg.n_layers} layers x "
          f"{stats.steps} decode steps", flush=True)
    print(f"engine: {n_req} requests finished with {gen_tokens} tokens: "
          f"{all(len(r.generated) == gen_tokens for r in reqs)}; free pages "
          f"{eng.sched.allocator.free_pages} of {free0} returned", flush=True)
    print(f"engine: prefill {stats.prefill_tokens / stats.prefill_s:.1f} tok/s "
          f"({stats.prefill_tokens} tokens in {stats.prefill_s:.3f} s), decode "
          f"{step_tokens / stats.decode_s:.1f} tok/s ({step_tokens} tokens in "
          f"{stats.steps} steps, {stats.decode_s:.3f} s), peak memory "
          f"{peak_gb:.2f} GB [{ident}]", flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return ok


def cpu_vs_cuda_phase():
    """Phase 4: 2 layers at the 8B widths, kernels on the card vs plain
    versions on the CPU, same weights and prompts."""
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
    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = llama.build_kv_caches(cfg, 16, 64, 2, 4, "int8", device=dev)
        cache, lg1 = llama.prefill_batch(params, cfg, cache, [0, 1], pages, prompts)
        toks = out["toks"] if "toks" in out else lg1.argmax(-1).cpu()
        out["toks"] = toks
        cache, lg2 = llama.decode_step(params, cfg, cache, [0, 1], toks)
        out[dev] = (lg1.float().cpu(), lg2.float().cpu())
    ok = True
    for i, name in enumerate(("prefill_batch", "decode_step")):
        a, r = out["cuda"][i], out["cpu"][i]
        d = (a - r).abs()
        # bf16 activations rounded in other summation orders on the two
        # devices, through 2 layers and the 4096 x 128256 lm_head; the
        # logits have unit scale (random weights, std 1)
        tol_max, tol_mean = 0.25, 0.02
        good = bool(torch.isfinite(a).all()) and float(d.max()) < tol_max \
            and float(d.mean()) < tol_mean
        print(f"cuda vs cpu {name} logits [{tuple(a.shape)}]: max_abs "
              f"{float(d.max()):.3e} (< {tol_max}) mean_abs {float(d.mean()):.3e} "
              f"(< {tol_mean}), |ref| max {float(r.abs().max()):.2f}, argmax "
              f"agree {bool(torch.equal(a.argmax(-1), r.argmax(-1)))} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


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
        "decode": ("mfa_tpu_torch/csrc/decode.cu",
                   "mfa_tpu/kernels/decode.py:53"),
        "combine": ("mfa_tpu_torch/csrc/decode.cu",
                    "mfa_tpu/kernels/decode.py:148"),
        "paged": ("mfa_tpu_torch/csrc/paged.cu",
                  "mfa_tpu/kernels/paged.py:122"),
    }
    records = {n: {"name": n, "route": "cuda", "source": s, "replaces": r}
               for n, (s, r) in sources.items()}
    phases = {}
    counts = {}
    for name, fn in (("kernels", lambda: kernel_phase(records)),
                     ("library_surface", lambda: library_surface(counts)),
                     ("engine_8b", lambda: engine_phase(counts, ident)),
                     ("cuda_vs_cpu", cpu_vs_cuda_phase)):
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
