#!/usr/bin/env python3
"""Time kernel 10 (the int8-weight matmul) and kernel 5 (split-KV decode)
against their library yardsticks, their plain versions and their bound, on
one GPU.

    python3 scripts/time_wmatmul_decode.py [--root DIR] [--label NAME]

Shapes, bf16 from seed 0: kernel 10 at the Llama-3-8B projections for a
decode batch (m 16: wq 4096 -> 4096, wk -> 1024, w_gate -> 14336, w_down
14336 -> 4096, the lm_head -> 128256) and for a prefill wave (m 3601,
w_gate); the yardstick is torch.matmul on the dequantized bf16 weight
(cuBLAS). Kernel 5, whole calls (one launch; a checkout before the
split merge moved into it: the partials' launch and the combine launch),
at b16 hq32 hkv8 S8192 for d 64, 128 and 256 and at b1 S32768 d128, each
at the default split count, then a sweep of split counts at b16 S8192
d128 and b1 S32768 d128; the yardstick is SDPA with enable_gqa on the same
cache (chip_smoke.py phase 2). Every output is held against its plain
version (kernel 10: 2^-8 of the largest output; kernel 5: max 2e-2, mean
2e-3). Times are CUDA-event means (chip_smoke._time_ms); bounds as
chip_smoke.py phase 2 (bytes read and written once over 3.35 TB/s against
operations over 989 TFLOP/s). --root imports mfa_tpu_torch from another
checkout (e.g. the parent commit unpacked with git archive), so two
versions compare in one call. Prints one line per kernel and shape, and
the card's name and power limit. Exits non-zero if an output is off.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJECTIONS = (("wq", 16, 4096, 4096), ("wk", 16, 4096, 1024),
               ("w_gate", 16, 4096, 14336), ("w_down", 16, 14336, 4096),
               ("lm_head", 16, 4096, 128256), ("w_gate", 3601, 4096, 14336))


def wmatmul_shapes(cs, label, gen):
    import torch

    from mfa_tpu_torch.kernels import wmatmul
    from mfa_tpu_torch.models.wquant import dequantize_weight, quantize_weight

    ok = True
    for name, m, K, N in PROJECTIONS:
        x = torch.randn(m, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5)
        out = wmatmul.int8_matmul(x, w.qw, w.scale)
        ref = wmatmul._int8_matmul_plain(x.float(), w.qw, w.scale, torch.float32)
        err = float((out.float() - ref).abs().max())
        good = bool(torch.isfinite(out.float()).all()) and err <= 2 ** -8 * float(ref.abs().max())
        ok &= good
        ms = cs._time_ms(lambda: wmatmul.int8_matmul(x, w.qw, w.scale))
        plain_ms = cs._time_ms(lambda: wmatmul._int8_matmul_plain(x, w.qw, w.scale,
                                                                  torch.bfloat16), iters=5)
        wd = dequantize_weight(w, torch.bfloat16)
        lib_ms = cs._time_ms(lambda: torch.matmul(x, wd))
        bound_ms, by = cs._bound(K * N + 4 * N + 2 * m * K + 2 * m * N, 2 * m * K * N)
        print(f"{label} kernel 10 {name} m{m} K{K} N{N} splits "
              f"{wmatmul.split_k(m, K, N)[0]}: ms {ms:.4f} bound_ms {bound_ms:.4f} ({by}) "
              f"bound share {bound_ms / ms:.3f}; plain {plain_ms:.4f} ms; cublas "
              f"{lib_ms:.4f} ms, kernel / cublas {ms / lib_ms:.2f}x; max_abs_err {err:.3e}"
              f"{'' if good else ' FAIL'}", flush=True)
        if m == 16 and len(wmatmul._ARGTYPES) == 12:  # the one-launch kernel
            sweep_splits(cs, wmatmul, x, w, label)
        del x, w, wd, out, ref
        torch.cuda.empty_cache()
    return ok


def sweep_splits(cs, wmatmul, x, w, label):
    """Kernel 10 through its C function at 1, 2, 4 and 8 K splits."""
    import torch

    from mfa_tpu_torch.kernels import _build

    m, K = x.shape
    N = w.qw.shape[1]
    out = torch.empty((m, N), dtype=x.dtype, device="cuda")
    fn = _build.function("wmatmul", "mfa_int8_matmul", wmatmul._ARGTYPES)
    steps = -(-K // wmatmul.BLOCK_K)
    times = []
    for want in (1, 2, 4, 8):
        per = -(-steps // want)
        splits = -(-steps // per)
        args = (x.data_ptr(), w.qw.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
                _build.DTYPE_CODES[x.dtype], 0, m, K, N, splits, per, _build.stream_of(x))
        _build.check("wmatmul", fn(*args))
        times.append(f"{splits}: {cs._time_ms(lambda: fn(*args)):.4f}")
    print(f"{label} kernel 10 m{m} K{K} N{N} ms by K splits: {', '.join(times)}", flush=True)


def _decode_case(cs, decode, b, S, d, ns, gen, label, sweep=False):
    """One decode shape at `ns` splits (0: the default), the whole call,
    with the plain version's time unless sweep. Returns ok."""
    import torch
    import torch.nn.functional as F

    hq, hkv = 32, 8
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn(b, hkv, S, d, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    lens = torch.full((b,), S, dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    req = ns if ns else (decode.default_splits(b, hkv, S) if hasattr(decode, "default_splits")
                         else decode.num_splits_heuristic(b, hkv, S, decode.TILE))
    nsp, tps = decode.split_layout(S, req)
    o = decode.decode_attention(q, kc, vc, lens, num_splits=nsp)
    po, pl = decode._decode_partials_plain(q.float(), kc.float(), vc.float(), lens, scale,
                                           nsp, tps, -1, 0.0)
    ro = decode.combine_splits(po, pl, axis=2).reshape(b, hq, d)
    err = (o.float() - ro).abs()
    good = bool(torch.isfinite(o.float()).all()) and float(err.max()) < 2e-2 \
        and float(err.mean()) < 2e-3
    del po, pl, ro
    bound_ms, by = cs._bound(2 * b * hkv * S * d * 2 + 2 * b * hq * d * 2 + b * hq * 4,
                             4 * b * hq * S * d)
    lib_ms = cs._time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, enable_gqa=True))
    # the whole call: one launch, or (before the merge moved into it) the
    # partials' launch and the combine launch
    ms = cs._time_ms(lambda: decode.decode_attention(q, kc, vc, lens, num_splits=nsp))
    what, plain = "whole call", ""
    if not sweep:
        plain_ms = cs._time_ms(lambda: decode._decode_partials_plain(
            q, kc, vc, lens, scale, nsp, tps, -1, 0.0), iters=3)
        plain = f"; plain {plain_ms:.4f} ms"
    print(f"{label} kernel 5 b{b} hq{hq} hkv{hkv} S{S} d{d} splits {nsp} ({what}): ms "
          f"{ms:.4f} bound_ms {bound_ms:.4f} ({by}) bound share {bound_ms / ms:.3f}{plain}; "
          f"sdpa {lib_ms:.4f} ms, kernel / sdpa {ms / lib_ms:.2f}x; max_abs_err "
          f"{float(err.max()):.3e}{'' if good else ' FAIL'}", flush=True)
    del q, kc, vc, o
    torch.cuda.empty_cache()
    return good


def decode_shapes(cs, label, gen):
    from mfa_tpu_torch.kernels import decode

    ok = True
    for b, S, d in ((16, 8192, 64), (16, 8192, 128), (16, 8192, 256), (1, 32768, 128)):
        ok &= _decode_case(cs, decode, b, S, d, 0, gen, label)
    for b, S, counts in ((16, 8192, (1, 2, 3, 4)), (1, 32768, (4, 8, 15, 16, 30, 32, 64))):
        for ns in counts:
            ok &= _decode_case(cs, decode, b, S, 128, ns, gen, label, sweep=True)
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
    from mfa_tpu_torch.kernels import _build

    print(f"mfa_tpu_torch from {os.path.dirname(_build.__file__)}", flush=True)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = wmatmul_shapes(cs, args.label, gen)
    ok &= decode_shapes(cs, args.label, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
