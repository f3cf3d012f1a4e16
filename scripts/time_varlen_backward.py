#!/usr/bin/env python3
"""Time kernel 7 (packed varlen) and the backward kernels 11-14 against
SDPA and their bound, on one GPU.

    python3 scripts/time_varlen_backward.py [--root DIR] [--label NAME]

Shapes, all causal bf16 from seed 0: kernel 7 on 8 x 512 packed rows
(hq 32, hkv 8, d 128; SDPA is_causal on the same data batched as the
yardstick) and on the ragged 4096-token pack of chip_smoke.py (lengths 200
to 1100, no single PyTorch call); kernel 11 (fused), kernel 12 (the
split's dK/dV) and kernel 13 (its dQ), each launch alone, and the split
pair 12 + 13, at the Llama-3-8B train shape (b 4, hq 32, hkv 8, s 2048, d
128; the yardstick is SDPA's backward alone, autograd.grad over one
retained is_causal call); kernel 14's two launches (dK/dV, dQ) on the
ragged pack and on 8 x 512 packed rows (the same heads; no single PyTorch
call). Each kernel's output is held against its plain version (forward:
max 2e-2, mean 2e-3; backward: chip_smoke._bwd_close), and the split and
kernel 14 against a second run, bit for bit. Times are CUDA-event means
(chip_smoke._time_ms); bounds as chip_smoke.py phase 2: the larger of the
bytes read and written once over 3.35 TB/s and 4 d (forward) or 10 d
(fused backward; 8 d dK/dV, 6 d dQ) flops per visible (row, key) pair
and q head over 989 TFLOP/s. --root imports mfa_tpu_torch from another
checkout (e.g. the parent commit unpacked with git archive), so two
versions compare in one call. Prints one line per kernel and shape, and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS_RAGGED = [200, 1100, 512, 300, 700, 384, 450, 450]  # chip_smoke.py's pack


def varlen_shapes(cs, varlen, label, gen):
    import torch
    import torch.nn.functional as F

    hq, hkv, d = 32, 8, 128
    ok = True
    for tag, lens in (("packed 8 x 512", [512] * 8), ("ragged 4096", LENS_RAGGED)):
        n = sum(lens)
        q, k, v = (torch.randn(n, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        cu = torch.tensor([0] + lens, device="cuda").cumsum(0).int()

        def run():
            return varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens), causal=True)

        ref = varlen._varlen_plain(q.float(), k.float(), v.float(), cu, cu, d ** -0.5, -1, 0,
                                   0.0, False)
        err = (run().float() - ref).abs()
        good = bool(torch.isfinite(err).all()) and float(err.max()) < 2e-2 \
            and float(err.mean()) < 2e-3
        ok &= good
        ms = cs._time_ms(run)
        pairs = sum(cs._visible_pairs(s, s, 0, -1, 0) for s in lens)
        bound_ms, by = cs._bound(2 * (2 * n * hq * d + 2 * n * hkv * d), 4 * hq * pairs * d)
        lib = "sdpa n/a (ragged)"
        if len(set(lens)) == 1:
            qb, kb, vb = (t.view(len(lens), lens[0], t.shape[1], d).transpose(1, 2)
                          for t in (q, k, v))
            lib_ms = cs._time_ms(lambda: F.scaled_dot_product_attention(
                qb, kb, vb, is_causal=True, enable_gqa=True))
            lib = f"sdpa {lib_ms:.4f} ms, kernel / sdpa {ms / lib_ms:.2f}x"
        print(f"{label} kernel 7 {tag}: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) "
              f"bound share {bound_ms / ms:.3f}; {lib}; max_abs_err {float(err.max()):.3e}"
              f"{'' if good else ' FAIL'}", flush=True)
        del q, k, v, ref, err
        torch.cuda.empty_cache()
    return ok


def backward_shape(cs, backward, prefill, label, gen):
    import torch
    import torch.nn.functional as F

    b, hq, hkv, s, d = 4, 32, 8, 2048, 128
    scale = d ** -0.5
    q, do = (torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = prefill.prefill_attention(q, k, v, causal=True, return_lse=True)
    fused = backward.flash_attention_bwd(q, k, v, o, lse, do, causal=True, fused=True)
    ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                              scale, -1, 0, 0.0)
    _, ok = cs._bwd_close(fused, ref, f"{label} kernel 11")
    split = backward.flash_attention_bwd(q, k, v, o, lse, do, causal=True, fused=False)
    _, good = cs._bwd_close(split, ref, f"{label} kernels 12 + 13")
    again = backward.flash_attention_bwd(q, k, v, o, lse, do, causal=True, fused=False)
    same = all(torch.equal(x, y) for x, y in zip(split, again))
    ok &= good and same
    del fused, ref, split, again
    args = backward._dense_cuda_inputs(q, k, v, o, lse, do) + (scale, -1, 0, 0.0)
    launch = {"11 (fused)": backward._launch_fused, "12 (dK/dV)": backward._launch_dkv,
              "13 (dQ)": backward._launch_dq}
    ms = {n: cs._time_ms(lambda fn=fn: fn(*args), iters=10) for n, fn in launch.items()}
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    lib_ms = cs._time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
                         iters=10)
    pairs = b * hq * cs._visible_pairs(s, s, 0, -1, 0)
    qb, kb, row_b = b * hq * s * d * 2, b * hkv * s * d * 2, b * hq * s * 4
    bounds = {"11 (fused)": cs._bound(4 * qb + 4 * kb + row_b, 10 * pairs * d),
              "12 (dK/dV)": cs._bound(2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d),
              "13 (dQ)": cs._bound(2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)}
    for name, t in ms.items():
        bound_ms, by = bounds[name]
        print(f"{label} kernel {name} train shape b{b} hq{hq} hkv{hkv} s{s} d{d}: ms {t:.4f} "
              f"bound_ms {bound_ms:.4f} ({by}) bound share {bound_ms / t:.3f}; sdpa backward "
              f"{lib_ms:.4f} ms, kernel / sdpa {t / lib_ms:.2f}x", flush=True)
    pair = ms["12 (dK/dV)"] + ms["13 (dQ)"]
    print(f"{label} split 12 + 13 train shape: ms {pair:.4f}; sdpa backward {lib_ms:.4f} ms, "
          f"split / sdpa {pair / lib_ms:.2f}x; bit-equal over two runs {same}"
          f"{'' if good and same else ' FAIL'}", flush=True)
    return ok


def varlen_backward_shapes(cs, backward, varlen, label, gen):
    import torch

    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5
    ok = True
    for tag, lens in (("ragged 4096", LENS_RAGGED), ("packed 8 x 512", [512] * 8)):
        n = sum(lens)
        q, do = (torch.randn(n, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(n, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        cu = torch.tensor([0] + lens, device="cuda").cumsum(0).int()
        o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens), causal=True,
                                         return_lse=True)
        got = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu, causal=True)
        ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), cu, cu, scale, -1, 0, 0.0)
        _, good = cs._bwd_close(got, ref, f"{label} kernel 14 {tag}")
        again = backward.varlen_attention_bwd(q, k, v, o, lse, do, cu, cu, causal=True)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ok &= good and same
        del got, ref, again
        args = backward._varlen_cuda_inputs(q, k, v, o, lse, do, cu, cu) + (cu, cu, max(lens))
        tail = (scale, -1, 0, 0.0)
        ms_kv = cs._time_ms(lambda: backward._launch_varlen_dkv(*args, *tail), iters=10)
        ms_q = cs._time_ms(lambda: backward._launch_varlen_dq(*args, *tail), iters=10)
        pairs = hq * sum(cs._visible_pairs(x, x, 0, -1, 0) for x in lens)
        qb, kb, row_b = n * hq * d * 2, n * hkv * d * 2, n * hq * 4
        b_kv = cs._bound(2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d)
        b_q = cs._bound(2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)
        print(f"{label} kernel 14 {tag} causal hq{hq} hkv{hkv} d{d}: dK/dV ms {ms_kv:.4f} "
              f"bound_ms {b_kv[0]:.4f} ({b_kv[1]}) bound share {b_kv[0] / ms_kv:.3f}; dQ ms "
              f"{ms_q:.4f} bound_ms {b_q[0]:.4f} ({b_q[1]}) bound share {b_q[0] / ms_q:.3f}; "
              f"pair {ms_kv + ms_q:.4f} ms; library none (ragged); bit-equal over two runs "
              f"{same}{'' if good and same else ' FAIL'}", flush=True)
        del q, k, v, do, o, lse, args
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # timing, bound and tolerance helpers of this checkout

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import backward, prefill, varlen

    print(f"mfa_tpu_torch from {os.path.dirname(varlen.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = varlen_shapes(cs, varlen, args.label, gen)
    ok &= backward_shape(cs, backward, prefill, args.label, gen)
    ok &= varlen_backward_shapes(cs, backward, varlen, args.label, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
