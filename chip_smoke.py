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
   Kernels: prefill, split-KV decode + combine (b16 S8192 d128 at the
   default split count and 2; then a long cache, b1 S32768, at d 64, 128 and
   256, groups 1, 2, 4 and 8, window and softcap, lengths 0, 1 and off the
   64-token tile, rows past a length NaN), paged decode, varlen (at d
   128 and 256; on equal lengths bit for bit equal to kernel 1, O and LSE)
   and paged prefill; the five backward launches (fused, the dK/dV + dQ
   split, the varlen split) within max |a - r| <= 2e-2 max |r| and mean |a -
   r| <= 2e-2 mean |r| for each of dq, dk, dv, and fused against split; at
   Gemma3-4B's head_dim 256, prefill (causal, window 1023 and none) and
   paged decode (int8 and bf16 pages, group 2, window 1023: 40 blocks, so
   the paged kernel splits each sequence and kernel 5's combine merges),
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
   dequantized bf16 weight as the yardstick).
3. The main path, each part with every launch count zeroed just before it
   and read just after: the library surface (flash_attn_func,
   flash_attn_varlen_func packed and paged, flash_attn_with_kvcache
   contiguous and paged, and the gradient functions flash_attn_func_grad,
   flash_attention_bwd(fused=False), flash_attn_varlen_func_grad); the
   serving engine at Llama-3-8B width (32 layers, random bf16 weights from
   a seed, int8 paged KV, page 64) answering 16 requests of 200-256 prompt
   tokens and 32 new tokens each (every engine's decode steps replay the
   CUDA graph of their batch bucket, serve/graphs.py; the launch counts
   include the replays), and once more with the graphs off for the eager
   decode rate (same tokens); then, with the same weights, an engine
   with chunked prefill (chunks of 512) and the prefix cache answering 4
   long prompts, 9 prompts that share a 1024-token system prompt and 4
   short ones; then the first engine's traffic with run(burst=8,
   pipeline=False) and run(burst=8) (up to 8 decode steps a readback, two
   bursts in flight): tokens identical to the stepwise engine's, every
   page returned, nothing in flight; then, with the same weights and the
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
   Llama-3-8B again with int8 weights (init_params(quantize="int8")) and
   the traffic of the first engine: every projection through kernel 10.
   The library surface also calls flash_attn_func with a softcap and in
   fp16 (kernel 1) and at head_dim 64 (kernel 4); every bf16 prompt wave
   runs kernels 2 + 3.
4. The 8B model cut to 2 layers, on the card (kernels) and on the CPU
   (plain versions) with the same weights: prefill, decode, chunked prefill
   and prefix-hit suffix logits agree, and one SGD train step gives the
   same loss and gradients; then Gemma3-4B cut to 2 layers (one sliding,
   one global) with a 2-layer tower at 224 px: image-prompt prefill and
   the next decode step's logits agree; then the 2-layer 8B with int8
   weights: prefill and decode logits agree, argmax equal.
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
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _visible_pairs(sq: int, sk: int, q_start: int = 0, wl: int = -1,
                   wr: int = -1) -> int:
    """(row, column) pairs a band lets through: row r (position q_start + r)
    sees columns c < sk with pos - wl <= c <= pos + wr (-1 = unbounded)."""
    import numpy as np

    pos = q_start + np.arange(sq)
    hi = np.full(sq, sk - 1) if wr < 0 else np.minimum(sk - 1, pos + wr)
    lo = np.zeros(sq, np.int64) if wl < 0 else np.maximum(0, pos - wl)
    return int(np.maximum(0, hi - lo + 1).sum())


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


def _wave_launches(got, n):
    """A bf16 prompt wave runs the default engine: n zero-shift launches,
    each followed by its repair launch, and kernel 1 not at all."""
    return got.get("flagged", 0) == n and got.get("repair", 0) == n \
        and not got.get("prefill", 0)


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

    # -- kernel 5: split-KV decode + combine (b=16, S=8192)
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
        records["paged"]["max_abs_err"] = max(records["paged"]["max_abs_err"], mx)
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
    chunk batch (int8 pages) and the varlen paged route's shape (bf16)."""
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
    split, and each launch timed alone. The bound counts 10 * hq * d flops
    per visible pair for the whole backward (5 products), 8 for the dK/dV
    launch, 6 for the dQ launch; bytes read q, k, v, O (or delta), dO, LSE
    once and write the launch's gradients once."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import backward, prefill, varlen

    dev, bf = "cuda", torch.bfloat16
    ok = True
    #        tag, b, hq, hkv, sq, sk, d, window (left, right), record
    dense = (("training shape, causal", 4, 32, 8, 2048, 2048, 128, (-1, 0), True),
             ("d 64, causal", 2, 32, 8, 1024, 1024, 64, (-1, 0), False),
             ("sq 128 < sk 512, causal", 1, 32, 8, 128, 512, 128, (-1, 0), False),
             ("sq 300, sk 8, window (4, -1) causal: dead rows", 1, 32, 8, 300, 8,
              128, (4, 0), False))
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
        if (wl, wr) == (-1, 0) and sq == sk:
            # SDPA's backward alone: autograd.grad over the retained graph of
            # one SDPA call (is_causal, enable_gqa) at the same shape
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                enable_gqa=True)
            lib_ms = _time_ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), do, retain_graph=True), iters=5)
            split_ms = ms["bwd_dkv"] + ms["bwd_dq"]
            lib = (f" library_ms(sdpa backward alone) {lib_ms:.4f}; fused / sdpa "
                   f"{ms['bwd_fused'] / lib_ms:.2f}x, split 12 + 13 / sdpa "
                   f"{split_ms / lib_ms:.2f}x")
            del ql, kl, vl, ol
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
             ("8 packed causal, softcap 30", lens_a, lens_a, (-1, 0), 30.0))
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
        print(f"  dkv ms {ms_kv:.4f} + dq ms {ms_q:.4f} = {ms_kv + ms_q:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {b_all[0]:.4f} ({b_all[1]}; dkv "
              f"{b_kv[0]:.4f}, dq {b_q[0]:.4f}) library_ms n/a (ragged)", flush=True)
        if i == 0:
            records["varlen_bwd_dkv"].update(ms=ms_kv, plain_ms=plain_ms,
                                             bound_ms=b_kv[0], bound_by=b_kv[1],
                                             library_ms=None)
            records["varlen_bwd_dq"].update(ms=ms_q, plain_ms=plain_ms,
                                            bound_ms=b_q[0], bound_by=b_q[1],
                                            library_ms=None)
    return ok


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
    torch.cuda.synchronize()
    got = dict(_build.launches)
    counts.update({k_: counts.get(k_, 0) + n for k_, n in got.items()})
    print(f"library surface launches {got}", flush=True)
    outs = (o1, o1c, o1h, o1d, o2, o3, o4, o5, o6, o7) + grads
    ok = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    ok &= o1.shape == q.shape and o2.shape == qd.shape and o3.shape == qd.shape
    ok &= o4.shape == qv.shape and o5.shape == qp.shape
    ok &= all(g.shape == t.shape for g, t in zip(grads, leaves + [qt, kt, vt]))
    ok &= all(got.get(n, 0) >= 1 for n in (
        "prefill", "flagged", "repair", "bound", "decode", "combine", "paged",
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


def chunked_engine_phase(counts, ident, state):
    """Main path, part 3: the same weights behind an engine with chunked
    prefill (chunks of 512) and the prefix cache. (a) 4 long prompts take
    the chunked path; (b) a request with a 1024-token system prompt runs
    until its prefill completes, then 8 more with the same system prompt
    hit its 16 cached pages and prefill only their suffix; (c) 4 short
    prompts take whole-prompt prefill (kernels 2 + 3)."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.serve.engine import Engine

    params, cfg = state.pop("params"), state.pop("cfg")
    torch.cuda.reset_peak_memory_stats()
    gen_tokens, page = 32, 64
    eng = Engine(params, cfg, num_pages=512, page_size=page, max_seqs=16,
                 pages_per_seq=64, quant_dtype="int8", prefill_chunk=512,
                 prefix_cache=True, device="cuda")
    free0 = eng.sched.allocator.free_pages
    rng = np.random.RandomState(SEED)

    def toks(n):
        return [int(t) for t in rng.randint(0, cfg.vocab_size, int(n))]

    system = toks(1024)
    longs = [toks(n) for n in rng.randint(2500, 4001, 4)]
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
    ok &= got.get("paged_prefill", 0) == cfg.n_layers * stats.chunk_batches
    ok &= _wave_launches(got, cfg.n_layers * stats.prefill_batches)
    ok &= got.get("paged", 0) == cfg.n_layers * stats.steps
    step_tokens = stats.decode_tokens - len(reqs)  # first tokens come from prefill
    print(f"chunked engine launches {got}: paged_prefill = {cfg.n_layers} "
          f"layers x {stats.chunk_batches} chunk batches, flagged = repair = "
          f"{cfg.n_layers} x {stats.prefill_batches} waves, paged = "
          f"{cfg.n_layers} x {stats.steps} decode steps", flush=True)
    print(f"chunked engine: {len(reqs)} requests finished with {gen_tokens} "
          f"tokens: {all(len(r.generated) == gen_tokens for r in reqs)}; "
          f"system prompt done after {steps_to_first} steps; prefilled "
          f"{stats.prefill_tokens} of {prompt_tokens} prompt tokens (<= "
          f"{prompt_tokens - 8 * 1024}); free pages {eng.sched.allocator.free_pages}"
          f" + {retained} held by the prefix cache of {free0}", flush=True)
    print(f"chunked engine: prefill {stats.prefill_tokens / stats.prefill_s:.1f} "
          f"tok/s ({stats.prefill_tokens} tokens in {stats.prefill_s:.3f} s, "
          f"{stats.chunk_batches} chunk batches + {stats.prefill_batches} "
          f"whole waves), decode {_decode_rates(stats, step_tokens)}, "
          f"{wall:.3f} s wall, peak memory {peak_gb:.2f} GB [{ident}]",
          flush=True)
    del eng
    state.update(params=params, cfg=cfg)
    torch.cuda.empty_cache()
    return ok


def train_phase(counts, ident, state):
    """Main path, part 4: three SGD train steps of the full Llama-3-8B
    (32 layers, the engines' random bf16 weights, their KV pools freed) on
    4 x 2049 tokens from numpy.random.RandomState(SEED) (benchmark/train.py's
    batch and sequence), remat on. Each layer's attention runs kernels 2 + 3
    in the forward and again in the remat recompute, and the fused backward
    kernel. SGD, not AdamW: AdamW's two moments would add 32-64 GB to the
    16 GB of weights and 16 GB of gradients on an 80 GB card."""
    import numpy as np
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama

    params, cfg = state.pop("params"), state.pop("cfg")
    lr, b, s = 1.0, 4, 2048
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
        good = got.get("bwd_fused", 0) == cfg.n_layers \
            and _wave_launches(got, 2 * cfg.n_layers)
        print(f"train step {step + 1}: loss {losses[-1]:.6f}, {times[-1] * 1e3:.1f} "
              f"ms, launches {got} (bwd_fused = {cfg.n_layers} layers, flagged = "
              f"repair = 2 x {cfg.n_layers}: forward + remat recompute) "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    changed = {n: not torch.equal(t, params["layers"][i][n])
               for (n, t), i in zip(before.items(), (0, cfg.n_layers - 1))}
    ok &= all(math.isfinite(x) for x in losses) and losses[2] < losses[0]
    ok &= all(changed.values())
    n_mat = sum(p.numel() for p in llama.param_tensors(params) if p.dim() == 2) \
        - params["embed"].numel()
    pairs = b * s * (s + 1) // 2
    model_flops = 6 * n_mat * b * s + 12 * cfg.n_layers * cfg.n_heads * \
        cfg.head_dim * pairs
    step_s = sum(times[1:]) / 2
    print(f"train: Llama-3-8B, {cfg.n_layers} layers, b {b} x {s} tokens, remat, "
          f"SGD lr {lr}: losses {losses} (falling: {losses[2] < losses[0]}), "
          f"weights changed {changed}", flush=True)
    print(f"train: step {step_s * 1e3:.1f} ms (mean of steps 2-3; step 1 "
          f"{times[0] * 1e3:.1f} ms), {b * s / step_s:.1f} train tokens/s, peak "
          f"memory {peak_gb:.2f} GB; model-FLOPs share {model_flops / step_s / PEAK_BF16_FLOPS:.4f} "
          f"= (6 N T + 12 L hq d P) / step time / 989 TFLOP/s with N = {n_mat} "
          f"weights in matmuls (layers + lm_head, not the embedding table), T = "
          f"{b * s} tokens, P = {pairs} causal pairs, remat recompute not "
          f"counted [{ident}]", flush=True)
    for p in llama.param_tensors(params):
        p.grad = None
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


def engine_gemma3_phase(counts, ident):
    """Main path, part 5: Gemma3-4B multimodal serving at full width and
    depth (the 8B weights are freed by then): 34 text layers and the
    27-layer tower, random bf16 weights from SEED, int8 paged KV with
    64-token pages, 6 image prompts (7 random 896 x 896 images) and 4 text
    prompts of 300-1800 tokens, 32 new tokens each. Launches: kernel 9 34
    per image wave, kernels 2 + 3 34 each per text wave, the paged kernel 34 per
    decode step."""
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
    del eng, params, vparams, every
    torch.cuda.empty_cache()
    return ok


def cpu_vs_cuda_gemma3_phase():
    """Phase 4, Gemma3: 2 text layers (one sliding, one global) at
    Gemma3-4B widths and a 2-layer tower at 224 px (16 x 16 patches, 256
    soft tokens), kernels on the card vs plain versions on the CPU, same
    weights: a wave of two image prompts (one run after 1100 text tokens,
    past the window) and the next decode step."""
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
        out[dev] = tuple(x.float().cpu() for x in (lg1, lg2))
    ok = True
    for i, name in enumerate(("image prefill_batch", "decode_step")):
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


def cpu_vs_cuda_phase():
    """Phase 4: 2 layers at the 8B widths, kernels on the card vs plain
    versions on the CPU, same weights and prompts: whole-prompt prefill, a
    decode step, a 256-token prompt in 2 chunks of 128, and a prefix hit
    (its first 2 pages shared) prefilling only a 60-token suffix chunk."""
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
    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = llama.build_kv_caches(cfg, 16, 64, 2, 4, "int8", device=dev)
        cache, lg1 = llama.prefill_batch(params, cfg, cache, [0, 1], pages, prompts)
        toks = out["toks"] if "toks" in out else lg1.argmax(-1).cpu()
        out["toks"] = toks
        cache, lg2 = llama.decode_step(params, cfg, cache, [0, 1], toks)
        cc = llama.build_kv_caches(cfg, 16, 64, 2, 8, "int8", device=dev)
        for off in (0, 128):
            cc, lg3 = llama.prefill_chunk_batch(params, cfg, cc, [0], [[6, 7, 8, 9]],
                                                [long[off:off + 128]], [off], [256],
                                                128)
        cc, lg4 = llama.prefill_chunk_batch(params, cfg, cc, [1], [[6, 7, 10]],
                                            [hit[128:]], [128], [188], 64)
        out[dev] = tuple(x.float().cpu() for x in (lg1, lg2, lg3, lg4))
    ok = True
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
        print(f"cuda vs cpu {name} logits [{tuple(a.shape)}]: max_abs "
              f"{float(d.max()):.3e} (< {tol_max}) mean_abs {float(d.mean()):.3e} "
              f"(< {tol_mean}), |ref| max {float(r.abs().max()):.2f}, argmax "
              f"agree {bool(torch.equal(a.argmax(-1), r.argmax(-1)))} "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
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


def cpu_vs_cuda_int8w_phase():
    """Phase 4, int8 weights: the 8B model cut to 2 layers with
    init_params(quantize="int8"), kernel 10 on the card against its plain
    version on the CPU with the same weights: whole-prompt prefill and the
    next decode step's logits within max 0.25 / mean 0.02 (as the bf16
    model above), argmax equal."""
    import numpy as np
    import torch

    from mfa_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    p_gpu = llama.init_params(cfg, seed=SEED + 4, device="cuda", quantize="int8")
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
    ok = True
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
        "combine": ("mfa_tpu_torch/csrc/decode.cu",
                    "mfa_tpu/kernels/decode.py:148"),
        "paged": ("mfa_tpu_torch/csrc/decode_sm90.cuh",
                  "mfa_tpu/kernels/paged.py:122"),
        "varlen": ("mfa_tpu_torch/csrc/flash_fwd_sm90.cuh",
                   "mfa_tpu/kernels/varlen.py:53"),
        "paged_prefill": ("mfa_tpu_torch/csrc/paged_prefill.cu",
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
    }
    records = {n: {"name": n, "route": "cuda", "source": s, "replaces": r}
               for n, (s, r) in sources.items()}
    phases = {}
    counts = {}
    state = {}
    for name, fn in (("kernels", lambda: kernel_phase(records)),
                     ("library_surface", lambda: library_surface(counts)),
                     ("engine_8b", lambda: engine_phase(counts, ident, state)),
                     ("chunked_prefix_engine_8b",
                      lambda: chunked_engine_phase(counts, ident, state)),
                     ("engine_8b_burst",
                      lambda: burst_engine_phase(counts, ident, state)),
                     ("train_8b", lambda: train_phase(counts, ident, state)),
                     ("engine_gemma3_4b_vision",
                      lambda: engine_gemma3_phase(counts, ident)),
                     ("engine_8b_int8w", lambda: engine_int8w_phase(counts, ident)),
                     ("cuda_vs_cpu", cpu_vs_cuda_phase),
                     ("cuda_vs_cpu_gemma3", cpu_vs_cuda_gemma3_phase),
                     ("cuda_vs_cpu_int8w", cpu_vs_cuda_int8w_phase)):
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
