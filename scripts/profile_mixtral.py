#!/usr/bin/env python3
"""Where the time goes in Mixtral-8x7B's serving, on one GPU.

    python3 scripts/profile_mixtral.py [--out FILE] [--steps 8]

Mixtral-8x7B at full width and depth (32 layers, 8 experts, top 2) with
int8 weights and expert banks (init_params(quantize="int8"), random from
a seed) and int8 paged KV of 64 rows, reported as
scripts/profile_torch_engine.py reports its phases (host wall with and
without the profiler, device time summed over kernels, the device busy
share, the kernel time by group and by name): the prefill wave of
chip_smoke.py's 16 prompts of 200-256 tokens (the grouped MoE form:
kernel 10's expert launch over expert-sorted rows), `--steps` decode
steps eager, graphed and in graphed bursts of 8 (the dense form: every
expert over the batch's 16 rows), and a chunk batch of 4 x 512 tokens at
q_start 1536 (kernel 8 on every layer). Beside them the least time the
card could take: a decode step streams every weight but the embedding
once (bytes over 3.35 TB/s); a wave's active weights do 2 x 12.75e9
operations a token (over 989 TFLOP/s). --out FILE also writes the full
profiler tables there. Needs a CUDA device; prints the card's name and
power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_torch_engine import _report, serve_phase

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.models.wquant import params_nbytes
    from mfa_tpu_torch.serve.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cfg = llama.LlamaConfig.mixtral_8x7b()
    params = llama.init_params(cfg, seed=6, device="cuda", quantize="int8")
    streamed = params_nbytes(params) - params_nbytes(params["embed"])
    fe = cfg.moe_ffn_dim or cfg.ffn_dim
    active = cfg.n_layers * (2 * cfg.dim * cfg.n_heads * cfg.head_dim
                             + 2 * cfg.dim * cfg.n_kv_heads * cfg.head_dim
                             + cfg.n_active_experts * 3 * cfg.dim * fe) \
        + cfg.dim * cfg.vocab_size
    print(f"Mixtral-8x7B int8: a decode step streams {streamed / 1e9:.3f} GB: "
          f"bound {streamed / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s; {active / 1e9:.3f}e9 "
          f"active weights a token: {2 * active / 989e12 * 1e3:.4f} ms a token at 989 "
          f"TFLOP/s", flush=True)
    serve_phase(params, cfg, args.steps, acts, args.out, "Mixtral-8x7B int8 ")

    def chunk_engine():
        e = Engine(params, cfg, num_pages=4 * 64 + 1, page_size=64, max_seqs=16,
                   pages_per_seq=64, quant_dtype="int8", prefill_chunk=512,
                   device="cuda")
        rng = np.random.RandomState(1)
        for _ in range(4):
            e.submit(list(rng.randint(0, cfg.vocab_size, 4000)), 1)
        e._prefill_admitted(e.sched.admit())
        for _ in range(3):
            e._advance_chunked_prefill()
        torch.cuda.synchronize()
        return e

    with open(args.out or os.devnull, "a") as out:
        eng = chunk_engine()
        t0 = time.perf_counter()
        eng._advance_chunked_prefill()
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        del eng
        eng = chunk_engine()
        _build.reset_launches()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng._advance_chunked_prefill()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        print(f"launches {dict(_build.launches)}", flush=True)
        _report(f"Mixtral-8x7B int8 chunk batch (4 x 512 tokens at q_start 1536, "
                f"{cfg.n_layers} layers, int8 KV; bound {2 * active * 2048 / 989e9:.3f} ms)",
                prof, wall, plain, 1, "batch", out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
