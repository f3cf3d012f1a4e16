#!/usr/bin/env python3
"""Time kernel 6 (paged decode) and kernels 12 and 13 (the deterministic
split backward) against their bounds, on one GPU.

    python3 scripts/time_paged_decode_dkv.py [--root DIR] [--label NAME]

Kernel 6 at chip_smoke.py's three shapes: the Llama-3-8B serve step (b16
hq32 hkv8 d128, int8 pages of 64, lengths 195-300, pos_offset 1), Gemma3-4B's
decode step (b10 hq8 hkv4 d256, int8 pages of 64, lengths 300-2000, window
1023, pos_offset 1) and lengths 8192 (the 8B heads, int8 pages of 64); and
the 8B serve step on bf16 pages of 64 (the int8 conversion's share). The
time is the whole call at the split count the wrapper picks (one launch;
a checkout before the split merge moved into it: past one split, a
combine launch too). Kernels 12 (dK/dV) and 13 (dQ) at the training
shape (causal b4 hq32 hkv8 s2048 d128 bf16), each launch alone. No single
PyTorch call computes any of them. Kernel 5 (split-KV decode, whose tile
kernel 6 shares) at chip_smoke.py's main shape, b16 hq32 hkv8 S8192 d128
at its default split count, beside SDPA. All bf16 from seed 0; each output held
against its plain version (kernel 6: max 2e-2, mean 2e-3, LSE 1e-3 with the
same -inf rows; the backward: chip_smoke._bwd_close's limits; kernel 5: max
2e-2 from SDPA in fp32). Times are
CUDA-event means (chip_smoke._time_ms), beside kernel 6's host time a call
(200 calls queued back to back, host clock: the wrapper's checks, the
tensor maps' encoding and the launches); the bound is the larger of the bytes
(each input once, each output once) over 3.35 TB/s and the operations (4 d
flops per visible (row, key) pair of every q head; 8 and 6 d for the dK/dV
and dQ launches) over 989 TFLOP/s.
--root imports mfa_tpu_torch from another checkout (e.g. the parent
commit unpacked with git archive), so two versions compare in one call.
Prints one line per kernel and shape, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAGED_CASES = (  # tag, int8 pages, b, hq, hkv, d, lens, window
    ("8B serve step, int8 pages of 64", True, 16, 32, 8, 128,
     [300 - 7 * i for i in range(16)], -1),
    ("8B serve step, bf16 pages of 64", False, 16, 32, 8, 128,
     [300 - 7 * i for i in range(16)], -1),
    ("Gemma3-4B decode, int8 pages of 64, window 1023", True, 10, 8, 4, 256,
     [300 + (1700 * i) // 9 for i in range(10)], 1023),
    ("lens 8192, int8 pages of 64", True, 16, 32, 8, 128, [8192] * 16, -1),
)


def paged_cases(cs, label, gen):
    import torch

    from mfa_tpu_torch.kernels import _build, paged
    from mfa_tpu_torch.kernels.quant import quantize_rows

    page, ok = 64, True
    for tag, quant, b, hq, hkv, d, lens, wl in PAGED_CASES:
        pps = max(lens) // page + 1
        P = b * pps + 1
        q = torch.randn(b, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
        kf, vf = (torch.randn(hkv, P, page, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        if quant:
            (kp, ks), (vp, vs) = quantize_rows(kf, "int8"), quantize_rows(vf, "int8")
        else:
            kp, vp, ks, vs = kf, vf, None, None
        table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
                 ).reshape(b, pps).to(torch.int32)
        L = torch.tensor(lens, dtype=torch.int32, device="cuda")

        def run():
            return paged.paged_attention(q, kp, vp, L, table, k_scales=ks, v_scales=vs,
                                         window_left=wl, pos_offset=1, return_lse=True)

        _build.reset_launches()
        o, lse = run()
        launches = dict(_build.launches)
        ro, rl = paged._paged_plain(q.float(), kp, vp, ks, vs, L, table, d ** -0.5, wl,
                                    0.0, 1)
        err = (o.float() - ro.float()).abs()
        fin = torch.isfinite(rl)
        good = bool(torch.isfinite(o.float()).all()) and float(err.max()) < 2e-2 \
            and float(err.mean()) < 2e-3 \
            and torch.equal(torch.isneginf(lse), torch.isneginf(rl)) \
            and float((lse[fin] - rl[fin]).abs().max()) < 1e-3
        ok &= good
        ms = cs._time_ms(run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            run()
        host_us = (time.perf_counter() - t0) / 200 * 1e6  # the host's side of a call
        torch.cuda.synchronize()
        rows = sum(min(n, wl) if wl >= 0 else n for n in lens) * hkv  # visible, pos_offset 1
        nbytes = 2 * rows * d * kp.element_size() + (8 * rows if quant else 0) \
            + b * pps * 4 + 2 * b * hq * d * 2 + b * hq * 4
        bound_ms, by = cs._bound(nbytes, 4 * hq // hkv * rows * d)
        print(f"{label} kernel 6 {tag}: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) bound "
              f"share {bound_ms / ms:.3f} host_us {host_us:.1f} launches {launches} "
              f"library_ms none "
              f"max_abs_err {float(err.max()):.3e}{'' if good else ' FAIL'}", flush=True)
        del q, kf, vf, kp, vp, o, ro
        torch.cuda.empty_cache()
    return ok


def decode_case(cs, label, gen):
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import decode

    b, hq, hkv, s, d = 16, 32, 8, 8192, 128
    q, kc, vc = (torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for shape in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)))
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    o = decode.decode_attention(q, kc, vc, lens)
    ref = F.scaled_dot_product_attention(q[:, :, None].float(), kc.float(), vc.float(),
                                         enable_gqa=True)[:, :, 0]
    err = float((o.float() - ref).abs().max())
    ms = cs._time_ms(lambda: decode.decode_attention(q, kc, vc, lens))
    lib_ms = cs._time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, enable_gqa=True))
    bound_ms, by = cs._bound(2 * kc.numel() * 2 + 2 * q.numel() * 2 + b * hq * 4,
                             4 * b * hq * s * d)
    good = err < 2e-2
    print(f"{label} kernel 5 b{b} hq{hq} hkv{hkv} S{s} d{d}: ms {ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({by}) bound share {bound_ms / ms:.3f} library_ms(sdpa) "
          f"{lib_ms:.4f} max_abs_err {err:.3e}{'' if good else ' FAIL'}", flush=True)
    return good


def backward_cases(cs, label, gen):
    import torch

    from mfa_tpu_torch.kernels import backward, prefill

    b, hq, hkv, s, d = 4, 32, 8, 2048, 128
    scale = d ** -0.5
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (hq, hkv, hkv, hq))
    o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True)
    ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                              scale, -1, 0, 0.0)
    args = backward._dense_cuda_inputs(q, k, v, o, lse, do) + (scale, -1, 0, 0.0)
    dk, dv = backward._launch_dkv(*args)
    dq = backward._launch_dq(*args)
    _, good_kv = cs._bwd_close((None, dk, dv), ref, "dkv")
    _, good_q = cs._bwd_close((dq, None, None), ref, "dq")
    again = backward._launch_dkv(*args)
    same = torch.equal(again[0], dk) and torch.equal(again[1], dv)
    pairs = b * hq * cs._visible_pairs(s, s, 0, -1, 0)
    qb, kb, row_b = b * hq * s * d * 2, b * hkv * s * d * 2, b * hq * s * 4
    bounds = {"12 (dK/dV)": cs._bound(2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d),
              "13 (dQ)": cs._bound(2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)}
    launch = {"12 (dK/dV)": backward._launch_dkv, "13 (dQ)": backward._launch_dq}
    total = 0.0
    for name, fn in launch.items():
        ms = cs._time_ms(lambda fn=fn: fn(*args), iters=10)
        total += ms
        bound_ms, by = bounds[name]
        print(f"{label} kernel {name} train shape causal b{b} hq{hq} hkv{hkv} s{s} d{d}: "
              f"ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) bound share {bound_ms / ms:.3f} "
              f"library_ms none", flush=True)
    print(f"{label} split 12 + 13: ms {total:.4f}; dK/dV bit-equal over two launches "
          f"{same}{'' if good_kv and good_q and same else ' FAIL'}", flush=True)
    return good_kv and good_q and same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # timing and bound helpers of this checkout

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import paged

    print(f"mfa_tpu_torch from {os.path.dirname(paged.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        ok = paged_cases(cs, args.label, gen)
        ok &= decode_case(cs, args.label, gen)
        ok &= backward_cases(cs, args.label, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
