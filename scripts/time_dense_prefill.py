#!/usr/bin/env python3
"""Time the dense prefill kernels 1-4 against SDPA and their bound, on one GPU.

    python3 scripts/time_dense_prefill.py [--root DIR] [--label NAME]

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
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
    for tag, b, hq, hkv, s, d, wl in SHAPES:
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
