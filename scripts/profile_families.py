#!/usr/bin/env python3
"""Where the time goes in the chunk batches of Qwen2-7B and Gemma2-9B, on one GPU.

    python3 scripts/profile_families.py [--out FILE]

Each model at full width and depth (Qwen2-7B: 28 layers, q/k/v bias, 7 q
heads a kv head; Gemma2-9B: 42 layers, head_dim 256, softcap 50, a 4096
window on the even layers; random bf16 weights from a seed): an engine
with chunked prefill (chunks of 512, int8 paged KV, page 64) takes 4
prompts of 4000 tokens, advances them by 3 untraced chunks, and traces the
next chunk batch (4 x 512 tokens at q_start 1536: kernel 8 on every
layer), reported as scripts/profile_torch_engine.py reports its phases:
host wall time with and without the profiler, device time summed over
kernels, the device busy share and the kernel time by group and by name;
--out FILE also writes the full profiler tables there. Needs a CUDA
device; prints the card's name and power limit beside the numbers.
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
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from profile_torch_engine import _report

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.serve.engine import Engine

    _build.build_all()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with open(args.out or os.devnull, "a") as out:
        for model in cs.FAMILY_CONFIGS:
            cfg = cs._family_config(model)
            params = cs._family_params(cfg, 0)

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
            _report(f"{model} chunk batch (4 x 512 tokens at q_start 1536, "
                    f"{cfg.n_layers} layers, int8 KV)", prof, wall, plain, 1, "batch", out)
            del eng, params
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
