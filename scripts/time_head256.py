#!/usr/bin/env python3
"""Time kernels 8 and 11-14 at head_dim 128 and 256 against their bounds,
on one GPU.

    python3 scripts/time_head256.py [--root DIR] [--label NAME]

head_dim 128 (the shapes of chip_smoke.py's earlier rows): kernels 11
(fused), 12 (dK/dV) and 13 (dQ) at the Llama-3-8B train shape (causal b4
hq32 hkv8 s2048); kernel 14's two launches on the ragged pack (8
sequences of 200-1100, causal) and on 8 x 512; kernel 8 at the 8B chunk
batch (4 x 512 at q_start 0/1024/2048/3072, hq32 hkv8, int8 pages of 64
and 16, bf16 pages of 64). head_dim 256 (Gemma3-4B: hq8 hkv4): kernels 11, 12 and 13
at b4 s2048, causal and with the sliding layers' window (1023, 0);
kernel 14 on 4 x 2048 with the window and on a ragged pack; kernel 8 at
the Gemma3 chunk batch (4 x 512 at q_start 1536, pages of 64), causal
and window 1023 on int8 pages, and causal on bf16, fp8 and int4 pages.
A checkout that refuses head_dim 256 prints "not taken" for those rows.
Beside each kernel time, the plain version's on the same inputs
(`plain_ms`; the backward's is the whole backward's).

All inputs bf16 from seed 0. Each output is held against its plain
version (the backward: chip_smoke._bwd_close's limits; kernel 8: max
2e-2, mean 2e-3, LSE within 1e-3 with the same -inf rows). Times are
CUDA-event means (chip_smoke._time_ms), each launch alone. The bound is
the larger of the bytes (each input once, each output once) over 3.35
TB/s and the operations over 989 TFLOP/s: 10, 8 and 6 hq d flops per
visible (row, key) pair for the fused, dK/dV and dQ launches, 4 hq d for
kernel 8. The library time is SDPA's backward alone (autograd.grad over
one retained SDPA call; the window as a boolean band mask) where one
PyTorch call computes the same function. --root imports mfa_tpu_torch
from another checkout (the parent commit unpacked with git archive), so
two versions compare in one call. Prints one line per kernel and shape,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sdpa_bwd_ms(cs, q, k, v, do, wl):
    """SDPA's backward alone at the same shape: is_causal, or a boolean
    band mask for a window."""
    import torch
    import torch.nn.functional as F

    s = q.shape[2]
    with torch.enable_grad():
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        if wl < 0:
            ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
        else:
            r = torch.arange(s, device="cuda")
            band = (r[None] <= r[:, None]) & (r[None] >= r[:, None] - wl)
            ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=band, enable_gqa=True)
        return cs._time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                                       retain_graph=True), iters=5)


def dense_cases(cs, label, gen, d, hq, hkv, windows, with_lib):
    """Kernels 11, 12 and 13 at b4 s2048, each window of `windows`."""
    import torch

    from mfa_tpu_torch.kernels import backward, prefill

    b, s = 4, 2048
    scale = d ** -0.5
    ok = True
    for wl in windows:
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        o, lse = prefill.prefill_attention(q, k, v, causal=True, window_size=(wl, -1),
                                           return_lse=True)
        tag = f"b{b} hq{hq} hkv{hkv} s{s} d{d} causal" + (f" window {wl}" if wl >= 0 else "")
        try:
            args = backward._dense_cuda_inputs(q, k, v, o, lse, do) + (scale, wl, 0, 0.0)
        except NotImplementedError:
            print(f"{label} kernels 11-13 {tag}: not taken", flush=True)
            return ok
        ref = backward._bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                  do.float(), scale, wl, 0, 0.0)
        fused = backward._launch_fused(*args)
        dk, dv = backward._launch_dkv(*args)
        dq = backward._launch_dq(*args)
        _, g1 = cs._bwd_close((fused[0].to(q.dtype),) + fused[1:], ref, "fused")
        _, g2 = cs._bwd_close((dq, dk, dv), ref, "split")
        again = backward._launch_dkv(*args)
        same = torch.equal(again[0], dk) and torch.equal(again[1], dv) \
            and torch.equal(backward._launch_dq(*args), dq)
        ok &= g1 and g2 and same
        pairs = b * hq * cs._visible_pairs(s, s, 0, wl, 0)
        qb, kb, row_b = b * hq * s * d * 2, b * hkv * s * d * 2, b * hq * s * 4
        bounds = {"11 (fused)": cs._bound(4 * qb + 4 * kb + row_b, 10 * pairs * d),
                  "12 (dK/dV)": cs._bound(2 * qb + 2 * kb + 2 * row_b + 2 * kb,
                                          8 * pairs * d),
                  "13 (dQ)": cs._bound(2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)}
        launch = {"11 (fused)": backward._launch_fused, "12 (dK/dV)": backward._launch_dkv,
                  "13 (dQ)": backward._launch_dq}
        lib_ms = _sdpa_bwd_ms(cs, q, k, v, do, wl) if with_lib else None
        plain_ms = cs._time_ms(lambda: backward._bwd_plain(
            q, k, v, o, lse, do, scale, wl, 0, 0.0), iters=2)
        ms = {}
        for name, fn in launch.items():
            ms[name] = cs._time_ms(lambda fn=fn: fn(*args), iters=10)
            bound_ms, by = bounds[name]
            print(f"{label} kernel {name} {tag}: ms {ms[name]:.4f} bound_ms {bound_ms:.4f} "
                  f"({by}) bound share {bound_ms / ms[name]:.3f}", flush=True)
        split = ms["12 (dK/dV)"] + ms["13 (dQ)"]
        lib = "none" if lib_ms is None else (
            f"{lib_ms:.4f} (sdpa backward alone); fused / sdpa "
            f"{ms['11 (fused)'] / lib_ms:.2f}x, split / sdpa {split / lib_ms:.2f}x")
        print(f"{label} kernels 11-13 {tag}: split 12 + 13 ms {split:.4f}; plain_ms "
              f"{plain_ms:.4f}; library_ms "
              f"{lib}; split bit-equal over two runs {same}"
              f"{'' if g1 and g2 and same else ' FAIL'}", flush=True)
        del q, k, v, do, o, ref, fused, args
        torch.cuda.empty_cache()
    return ok


def varlen_cases(cs, label, gen, d, hq, hkv, cases):
    """Kernel 14's two launches on packed sequences."""
    import torch

    from mfa_tpu_torch.kernels import backward, varlen

    scale, ok = d ** -0.5, True
    for tag, lens, wl in cases:
        total = sum(lens)
        q, do = (torch.randn(total, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(total, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        cu = torch.tensor([0] + lens, device="cuda").cumsum(0).int()
        o, lse = varlen.varlen_attention(q, k, v, cu, cu, max(lens), max(lens),
                                         window_size=(wl, 0), return_lse=True)
        try:
            args = backward._varlen_cuda_inputs(q, k, v, o, lse, do, cu, cu)
        except NotImplementedError:
            print(f"{label} kernel 14 {tag}: not taken", flush=True)
            return ok
        tail = (scale, wl, 0, 0.0)
        dk, dv = backward._launch_varlen_dkv(*args, cu, cu, max(lens), *tail)
        dq = backward._launch_varlen_dq(*args, cu, cu, max(lens), *tail)
        ref = backward._varlen_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                         do.float(), cu, cu, scale, wl, 0, 0.0)
        _, good = cs._bwd_close((dq, dk, dv), ref, "varlen")
        ok &= good
        pairs = hq * sum(cs._visible_pairs(n, n, 0, wl, 0) for n in lens)
        qb, kb, row_b = total * hq * d * 2, total * hkv * d * 2, total * hq * 4
        b_kv = cs._bound(2 * qb + 2 * kb + 2 * row_b + 2 * kb, 8 * pairs * d)
        b_q = cs._bound(2 * qb + 2 * kb + 2 * row_b + qb, 6 * pairs * d)
        ms_kv = cs._time_ms(lambda: backward._launch_varlen_dkv(
            *args, cu, cu, max(lens), *tail), iters=10)
        ms_q = cs._time_ms(lambda: backward._launch_varlen_dq(
            *args, cu, cu, max(lens), *tail), iters=10)
        plain_ms = cs._time_ms(lambda: backward._varlen_bwd_plain(
            q, k, v, o, lse, do, cu, cu, scale, wl, 0, 0.0), iters=2)
        print(f"{label} kernel 14 {tag} hq{hq} hkv{hkv} d{d}: dK/dV ms {ms_kv:.4f} bound_ms "
              f"{b_kv[0]:.4f} ({b_kv[1]}) share {b_kv[0] / ms_kv:.3f}; dQ ms {ms_q:.4f} "
              f"bound_ms {b_q[0]:.4f} ({b_q[1]}) share {b_q[0] / ms_q:.3f}; plain_ms "
              f"{plain_ms:.4f}; library_ms none{'' if good else ' FAIL'}", flush=True)
        del q, k, v, do, o, ref, args
        torch.cuda.empty_cache()
    return ok


def paged_prefill_cases(cs, label, gen, d, hq, hkv, q_start, cases, softcap=0.0):
    """Kernel 8 on a chunk batch of 4 x 512 rows; cases (format, window,
    page size); softcap > 0: Gemma2's tanh cap on the scores."""
    import torch

    from mfa_tpu_torch.kernels import paged_prefill
    from mfa_tpu_torch.kernels.quant import pack_int4, quantize_rows

    sq, ok = 512, True
    b = len(q_start)
    lens = [s + sq for s in q_start]
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    L = torch.tensor(lens, dtype=torch.int32, device="cuda")
    QS = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    QL = torch.full((b,), sq, dtype=torch.int32, device="cuda")
    for fmt, wl, page in cases:
        pps = max(lens) // page + 1
        P = b * pps + 1
        kf, vf = (torch.randn(hkv, P, page, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        table = (torch.randperm(P - 1, generator=gen, device="cuda")[: b * pps] + 1
                 ).reshape(b, pps).to(torch.int32)
        if fmt == "bf16":
            kp, vp, ks, vs = kf, vf, None, None
        else:
            (kp, ks), (vp, vs) = quantize_rows(kf, fmt), quantize_rows(vf, fmt)
            if fmt == "int4":
                kp, vp = pack_int4(kp), pack_int4(vp)
        quant = None if fmt == "bf16" else fmt

        def run(lse=False):
            return paged_prefill.paged_prefill_attention(
                q, kp, vp, L, QS, table, q_lens=QL, k_scales=ks, v_scales=vs,
                causal=True, window_left=wl, logit_softcap=softcap, quant_dtype=quant,
                return_lse=lse)

        tag = (f"chunk batch 4 x {sq} at q_start {q_start}, hq{hq} hkv{hkv} d{d}, "
               f"{fmt} pages of {page}" + (f", window {wl}" if wl >= 0 else "")
               + (f", softcap {softcap}" if softcap else ""))
        try:
            o, lse = run(True)
        except NotImplementedError:
            print(f"{label} kernel 8 {tag}: not taken", flush=True)
            continue
        ro, rl = paged_prefill._paged_prefill_plain(
            q.float(), kp, vp, ks, vs, L, QS, QL, table, d ** -0.5, wl, 0, softcap,
            quant_dtype=quant)
        err = (o.float() - ro.float()).abs()
        fin = torch.isfinite(rl)
        good = bool(torch.isfinite(o.float()).all()) and float(err.max()) < 2e-2 \
            and float(err.mean()) < 2e-3 \
            and torch.equal(torch.isneginf(lse), torch.isneginf(rl)) \
            and float((lse[fin] - rl[fin]).abs().max()) < 1e-3
        ok &= good
        ms = cs._time_ms(run)
        plain_ms = cs._time_ms(lambda: paged_prefill._paged_prefill_plain(
            q, kp, vp, ks, vs, L, QS, QL, table, d ** -0.5, wl, 0, softcap,
            quant_dtype=quant), iters=3)
        kv_rows = sum(-(-n // page) * page for n in lens) * hkv
        nbytes = 2 * kv_rows * kp.shape[-1] * kp.element_size() \
            + (8 * kv_rows if quant else 0) + b * pps * 4 + 2 * b * sq * hq * d * 2
        pairs = sum(cs._visible_pairs(sq, n, s, wl, 0) for s, n in zip(q_start, lens))
        bound_ms, by = cs._bound(nbytes, 4 * hq * pairs * d)
        print(f"{label} kernel 8 {tag}: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) bound "
              f"share {bound_ms / ms:.3f} plain_ms {plain_ms:.4f} library_ms none max_abs_err "
              f"{float(err.max()):.3e}{'' if good else ' FAIL'}", flush=True)
    return ok


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
    from mfa_tpu_torch.kernels import backward

    print(f"mfa_tpu_torch from {os.path.dirname(backward.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lab = args.label
    ragged = [200, 1100, 512, 300, 700, 384, 450, 450]
    with torch.no_grad():
        ok = dense_cases(cs, lab, gen, 128, 32, 8, (-1,), True)
        ok &= varlen_cases(cs, lab, gen, 128, 32, 8, (("ragged pack, causal", ragged, -1),
                                                      ("8 x 512, causal", [512] * 8, -1)))
        ok &= paged_prefill_cases(cs, lab, gen, 128, 32, 8, [0, 1024, 2048, 3072],
                                  (("int8", -1, 64), ("int8", -1, 16), ("bf16", -1, 64)))
        ok &= dense_cases(cs, lab, gen, 256, 8, 4, (-1, 1023), True)
        ok &= varlen_cases(cs, lab, gen, 256, 8, 4,
                           (("4 x 2048, window 1023", [2048] * 4, 1023),
                            ("ragged pack, causal", ragged, -1)))
        ok &= paged_prefill_cases(cs, lab, gen, 256, 8, 4, [1536] * 4,
                                  (("int8", -1, 64), ("int8", 1023, 64), ("bf16", -1, 64),
                                   ("fp8", -1, 64), ("int4", -1, 64)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
