#!/usr/bin/env python3
"""Time the dense prefill kernels 1-4 against SDPA and their bound, on one GPU.

    python3 scripts/time_dense_prefill.py [--root DIR] [--label NAME]
        [--dtype bfloat16|float32] [--kernels 1,4,7,5]

At the shapes chip_smoke.py phase 2 times them (the 8B wave b16 hq32 hkv8
s256 d128, a long prompt b1 s4096 d128, Gemma3-4B's text wave b4 hq8 hkv4
s2048 d256 with window 1023 and without), all causal bf16 from seed 0:
kernel 1 (bound_softmax=False), the kernel 2 launch alone, the kernel 3
launch with no tile flagged, kernel 4 ("prepass" bits precomputed), and
torch's scaled_dot_product_attention (is_causal, or a band mask for the
window) as the yardstick. Each kernel's output is held against kernel 1's
plain version (max 2e-2, mean 2e-3). Times are CUDA-event means
(chip_smoke._time_ms); the bound is the larger of q/k/v/o bytes over
3.35 TB/s and 4 d flops per visible (row, key) pair over 989 TFLOP/s.
--root imports mfa_tpu_torch from another checkout (e.g. the parent
commit unpacked with git archive), so two versions compare in one call.
Prints one line per kernel and shape, and the card's name and power limit.

--dtype float32 times the fp32 tiles instead, at PERF.md's fp32 rows:
kernels 1, 2 (alone) and 3 (every tile flagged) at the 8B wave and b1
s4096, kernel 4 "unchecked" at d 64 on the 8B wave's heads, kernel 7 on 8
x 512 packed rows (hq 32, hkv 8, d 128, causal) and kernel 5 (the whole
call, b16 hq32 hkv8 S8192 d128) beside SDPA on the same fp32
tensors. Each is held against its plain fp32 version within atol = rtol
= 1e-4 (chip_smoke._err32: O and LSE), kernel 3 against kernel 1 bit for
bit; bounds of 4-byte rows at 3.35 TB/s against 4 d flops a visible pair
at 165 TFLOP/s (3xTF32, chip_smoke._bound32). TF32 stays off for the plain
versions and SDPA. --kernels keeps some of the fp32 rows: 1 (kernels 1-3),
4, 7, 5.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = (  # tag, b, hq, hkv, s, d, window left
    ("8B wave", 16, 32, 8, 256, 128, -1),
    ("b1 s4096", 1, 32, 8, 4096, 128, -1),
    ("Gemma3 d256 window 1023", 4, 8, 4, 2048, 256, 1023),
    ("Gemma3 d256 causal", 4, 8, 4, 2048, 256, -1),
)


def _line32(cs, label, tag, name, ms, nbytes, flops, lib_ms=None, note=""):
    bound_ms, by = cs._bound32(nbytes, flops)
    lib = f" sdpa_ms {lib_ms:.4f} (/ sdpa {ms / lib_ms:.2f}x)" if lib_ms else ""
    print(f"{label} float32 {tag}: {name} ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) "
          f"share {bound_ms / ms:.3f}{lib}{note}", flush=True)


def fp32_shapes(cs, label, gen, kernels=("1", "4", "7", "5")) -> bool:
    """The fp32 rows of kernels 1-5 and 7 (see the module docstring), of
    the groups in `kernels`."""
    import torch
    import torch.nn.functional as F

    from mfa_tpu_torch.kernels import decode, prefill, varlen

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    ok = True
    hq, hkv, d = 32, 8, 128
    for tag, b, s in (("8B wave", 16, 256), ("b1 s4096", 1, 4096)) if "1" in kernels else ():
        q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
        scale = d ** -0.5
        nbytes = 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        flops = 4 * b * hq * s * (s + 1) / 2 * d
        lib_ms = cs._time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        ro, rl = prefill._prefill_plain(q, k, v, scale, -1, 0, 0.0, True)
        o1, l1 = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                           bound_softmax=False)
        _, good = cs._err32(o1, ro, "kernel 1", l1, rl)
        ok &= good
        _line32(cs, label, tag, "kernel 1", cs._time_ms(lambda: prefill.prefill_attention(
            q, k, v, causal=True, bound_softmax=False)), nbytes, flops, lib_ms)
        nt = -(-s // 64)
        out, lse = torch.empty_like(q), torch.empty_like(l1)
        flags = torch.zeros((b, hq, nt), dtype=torch.int32, device="cuda")
        zo, zl, zf = prefill._zero_shift_plain(q, k, v, scale, -1, 0)
        prefill._zs_launch("flagged", q, k, v, out, lse, flags, scale, -1, 0)
        _, good = cs._err32(out, zo, "kernel 2", lse, zl)
        ok &= good and torch.equal(flags.bool(), zf)
        _line32(cs, label, tag, "kernel 2", cs._time_ms(lambda: prefill._zs_launch(
            "flagged", q, k, v, out, lse, flags, scale, -1, 0)), nbytes, flops, lib_ms)
        every = torch.ones_like(flags)
        prefill._zs_launch("repair", q, k, v, out, lse, every, scale, -1, 0)
        same = torch.equal(out, o1) and torch.equal(lse, l1)
        ok &= same
        _line32(cs, label, tag, "kernel 3 (every tile)", cs._time_ms(
            lambda: prefill._zs_launch("repair", q, k, v, out, lse, every, scale, -1, 0)),
            nbytes, flops, None, f"; equals kernel 1 bit for bit: {same}")
        del q, k, v, ro, out, o1, zo
        torch.cuda.empty_cache()
    if "4" in kernels:
        b, s, dk = 16, 256, 64  # kernel 4 at d 64, "unchecked" (zero shift everywhere)
        q, k, v = rn(b, hq, s, dk), rn(b, hkv, s, dk), rn(b, hkv, s, dk)
        o4, l4 = prefill.prefill_attention(q, k, v, causal=True, return_lse=True,
                                           bound_softmax="unchecked")
        zo, zl, _ = prefill._engine_plain("bound", "unchecked", q, k, v, dk ** -0.5, -1, 0)
        _, good = cs._err32(o4, zo, "kernel 4", l4, zl)
        ok &= good
        _line32(cs, label, "d64 8B wave", "kernel 4 (unchecked)", cs._time_ms(
            lambda: prefill.prefill_attention(q, k, v, causal=True, bound_softmax="unchecked")),
            4 * (2 * b * hq * s * dk + 2 * b * hkv * s * dk), 4 * b * hq * s * (s + 1) / 2 * dk,
            cs._time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                               enable_gqa=True)))
    if "7" in kernels:
        lens = [512] * 8  # kernel 7
        n = sum(lens)
        q, k, v = rn(n, hq, d), rn(n, hkv, d), rn(n, hkv, d)
        cu = torch.tensor([0] + lens, device="cuda").cumsum(0).int()
        ro, rl = varlen._varlen_plain(q, k, v, cu, cu, d ** -0.5, -1, 0, 0.0, True)
        o7, l7 = varlen.varlen_attention(q, k, v, cu, cu, 512, 512, causal=True, return_lse=True)
        _, good = cs._err32(o7, ro, "kernel 7", l7, rl)
        ok &= good
        qb, kb, vb = (x.view(8, 512, -1, d).transpose(1, 2) for x in (q, k, v))
        _line32(cs, label, "packed 8 x 512", "kernel 7", cs._time_ms(
            lambda: varlen.varlen_attention(q, k, v, cu, cu, 512, 512, causal=True)),
            4 * (2 * n * hq * d + 2 * n * hkv * d), 4 * hq * 8 * 512 * 513 / 2 * d,
            cs._time_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True,
                                                               enable_gqa=True)))
        del q, k, v, qb, kb, vb
    if "5" in kernels:
        b, S = 16, 8192  # kernel 5: the whole call
        q, kc, vc = rn(b, hq, d), rn(b, hkv, S, d), rn(b, hkv, S, d)
        L = torch.full((b,), S, dtype=torch.int32, device="cuda")
        o5, l5 = decode.decode_attention(q, kc, vc, L, return_lse=True)
        ns, tps = decode.split_layout(S, decode.default_splits(b, hkv, S, hq // hkv))
        po, pl = decode._decode_partials_plain(q, kc, vc, L, d ** -0.5, ns, tps, -1, 0.0)
        ro, rl = decode.combine_splits(po, pl, axis=2, return_lse=True)
        _, good = cs._err32(o5, ro.reshape(b, hq, d), "kernel 5", l5, rl.reshape(b, hq))
        ok &= good
        _line32(cs, label, "b16 S8192", f"kernel 5 ({ns} splits)", cs._time_ms(
            lambda: decode.decode_attention(q, kc, vc, L)),
            4 * (2 * b * hkv * S * d + 2 * b * hq * d), 4 * b * hq * S * d,
            cs._time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                               enable_gqa=True)))
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--kernels", default="1,4,7,5", help="fp32 rows to time")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # timing and bound helpers of this checkout

    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import prefill

    print(f"mfa_tpu_torch from {os.path.dirname(prefill.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    if args.dtype == "float32":
        with torch.no_grad():
            ok = fp32_shapes(cs, args.label, gen, args.kernels.split(","))
    for tag, b, hq, hkv, s, d, wl in SHAPES if args.dtype == "bfloat16" else ():
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        scale = d ** -0.5
        kw = dict(causal=True, window_size=(wl, -1))
        ro = prefill._prefill_plain(q.float(), k.float(), v.float(), scale, wl, 0, 0.0,
                                    False)
        nt = -(-s // 64)
        out = torch.empty_like(q)
        flags = torch.zeros((b, hq, nt), dtype=torch.int32, device="cuda")
        bits = prefill._risky_bits(q, k, scale * prefill._LOG2E)
        runs = {
            "kernel 1": lambda: prefill.prefill_attention(q, k, v, bound_softmax=False, **kw),
            "kernel 2": lambda: prefill._zs_launch("flagged", q, k, v, out, None, flags,
                                                   scale, wl, 0),
            "kernel 3 (no flag)": lambda: prefill._zs_launch("repair", q, k, v, out, None,
                                                              torch.zeros_like(flags), scale,
                                                              wl, 0),
            "kernel 4": lambda: prefill._zs_launch("bound", q, k, v, out, None, bits, scale,
                                                   wl, 0),
        }
        if wl < 0:
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                  enable_gqa=True)
        else:
            band = prefill._band(s, s, wl, 0, "cuda")[0]
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                                  enable_gqa=True)
        bound_ms, by = cs._bound(2 * (2 * b * hq * s * d + 2 * b * hkv * s * d),
                                 4 * b * hq * cs._visible_pairs(s, s, 0, wl, 0) * d)
        times = {}
        for name, fn in runs.items():
            if name.startswith(("kernel 1", "kernel 2", "kernel 4")):
                got = fn() if name == "kernel 1" else (fn(), out)[1]
                err = (got.float() - ro).abs()
                good = bool(torch.isfinite(got.float()).all()) and float(err.max()) < 2e-2 \
                    and float(err.mean()) < 2e-3
                ok &= good
                note = f" max_abs_err {float(err.max()):.3e}{'' if good else ' FAIL'}"
            else:
                note = ""
            times[name] = cs._time_ms(fn)
            print(f"{args.label} {tag}: {name} ms {times[name]:.4f} bound share "
                  f"{bound_ms / times[name]:.3f}{note}", flush=True)
        print(f"{args.label} {tag}: bound_ms {bound_ms:.4f} ({by}); kernel 1 / sdpa "
              f"{times['kernel 1'] / times['sdpa']:.2f}x, kernel 2 / sdpa "
              f"{times['kernel 2'] / times['sdpa']:.2f}x, kernel 2 / kernel 1 "
              f"{times['kernel 2'] / times['kernel 1']:.3f}", flush=True)
        del q, k, v, ro, out
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
