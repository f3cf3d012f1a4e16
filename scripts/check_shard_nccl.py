#!/usr/bin/env python3
"""The sharding layer over NCCL, one rank a card, on the cards of one host.

    python3 scripts/check_shard_nccl.py

chip_smoke.py checks the sharding layer on one card: NCCL at world size 1
and 2-4 ranks sharing the card over gloo. This script runs the same
checks where every rank has a card of its own, so the collectives are
NCCL's (the launcher's backend on CUDA, mfa_tpu_torch/shard/launch.py):

- the Llama-3-8B engine (full depth, random bf16 weights from chip_smoke's
  seed, int8 KV, chip_smoke's 16 prompts of 200-256 tokens, 32 new tokens)
  at {"model": N} with decode graphs (NCCL all-reduces in the graph): the
  ranks' tokens identical, graphs captured, the logits of all 32 steps
  teacher-forced on the ranks' tokens within relative L2 0.05 of the
  unsharded model's on the same tokens, the share of tokens
  equal to the unsharded engine's (rank 0 runs it alone on its card
  afterwards), and both engines' prefill and decode tok/s, stepwise and
  in pipelined bursts of 8 (tokens equal to the stepwise run's);
- chip_smoke.py's cp_ring_8b, ep_mixtral and pipeline_8b phases over NCCL
  ranks.

Needs at least 4 cards (N = every card, at most the 8B's 8 kv heads).
Exits non-zero if a check fails. Prints the cards' name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _tp_rank(n):
    """A rank of the {"model": n} engine over NCCL, graphs on; the mesh's
    first rank then runs the unsharded engine alone for the reference."""
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine
    from mfa_tpu_torch.shard.mesh import axis_index, make_mesh, psum

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh({"model": n})
    if mesh.get_coordinate() is None:
        return None
    # set the communicator up before anything is timed
    psum(torch.zeros(1, device="cuda"), mesh, "model")
    cfg = llama.LlamaConfig.llama3_8b()
    prompts = cs._tp_prompts(cfg)
    kw = dict(num_pages=128, page_size=64, max_seqs=16, pages_per_seq=8,
              quant_dtype="int8", device="cuda")

    def serve(params, mesh):
        eng = Engine(params, cfg, mesh=mesh, **kw)
        reqs = [eng.submit(p, 32) for p in prompts]
        _build.reset_launches()
        st = eng.run()
        out = dict(tokens=[list(r.generated) for r in reqs],
                   launches=dict(_build.launches), captures=st.captures,
                   prefill_tps=st.prefill_tokens / st.prefill_s,
                   decode_tps=(st.decode_tokens - 16) / st.decode_s,
                   decode_tps_warm=(st.decode_tokens - 16)
                   / (st.decode_s - st.capture_s))
        # the same traffic again in pipelined bursts of 8 (graphs warm):
        # one readback, and one replication check, each 8 steps
        eng2 = Engine(params, cfg, mesh=mesh, **kw)
        reqs = [eng2.submit(p, 32) for p in prompts]
        st = eng2.run(burst=8)
        out["burst_tokens"] = [list(r.generated) for r in reqs]
        out["burst_decode_tps"] = ((st.decode_tokens - 16)
                                   / (st.decode_s - st.capture_s))
        return out

    params = llama.init_params(cfg, seed=cs.SEED, device="cuda", mesh=mesh)
    out = serve(params, mesh)
    logits = cs._forced_logits(llama, cfg, params, prompts, mesh, out["tokens"])
    del params
    torch.cuda.empty_cache()
    if axis_index(mesh, "model") == 0:
        full = llama.init_params(cfg, seed=cs.SEED, device="cuda")
        out["unsharded"] = serve(full, None)
        ref = cs._forced_logits(llama, cfg, full, prompts, None, out["tokens"])
        out["rel_l2"] = max(cs._diff(a, r)[4] for a, r in zip(logits, ref))
        del full
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    from mfa_tpu_torch.kernels import _build
    from mfa_tpu_torch.shard.launch import Ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.cuda.device_count()
    if n < 4:
        print(f"needs 4 cards, found {n}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    ident = f"{n} x {smi[0].strip()}" if smi else f"{n} cards"
    print(f"cards: {smi}", flush=True)
    print(f"build: {_build.build_all():.1f} s", flush=True)
    tp = min(n, 8)
    ok = True
    counts = {}
    ranks = Ranks(n, device="cuda", timeout_s=900)
    shard = {"ranks": ranks, "label": "{n} ranks on their own cards over "
             + ranks.backend}
    try:
        t0 = time.perf_counter()
        outs = [o for o in ranks.run(_tp_rank, tp) if o is not None]
        wall = time.perf_counter() - t0
        ref = next(o for o in outs if "unsharded" in o)
        want = ref["unsharded"]["tokens"]
        agree = all(o["tokens"] == outs[0]["tokens"]
                    and o["burst_tokens"] == o["tokens"] for o in outs)
        share = sum(a == b for t, w in zip(outs[0]["tokens"], want)
                    for a, b in zip(t, w)) / (16 * 32)
        good = (ranks.backend == "nccl" and agree and len(outs) == tp
                and all(o["captures"] >= 1 for o in outs)
                and ref["rel_l2"] <= 0.05)
        o, u = outs[0], ref["unsharded"]
        print(f"tp engine model {tp} over {ranks.backend}, graphs on: ranks' "
              f"tokens identical {agree}, {o['captures']} captures a rank, "
              f"{share:.4f} of tokens equal to the unsharded engine's, the "
              f"largest relative L2 of the 32 teacher-forced steps' logits "
              f"{ref['rel_l2']:.4f} (<= 0.05); "
              f"prefill {o['prefill_tps']:.1f} tok/s, decode "
              f"{o['decode_tps']:.1f} tok/s ({o['decode_tps_warm']:.1f} without "
              f"capture_s; bursts of 8 {o['burst_decode_tps']:.1f}); the "
              f"unsharded engine on one card: prefill {u['prefill_tps']:.1f}, "
              f"decode {u['decode_tps']:.1f} ({u['decode_tps_warm']:.1f}; bursts "
              f"of 8 {u['burst_decode_tps']:.1f}); launches a rank "
              f"{o['launches']}; "
              f"{wall:.1f} s [{ident}] {'ok' if good else 'FAIL'}", flush=True)
        ok &= good
        for name, fn in (("cp_ring", cs.cp_ring_phase), ("ep", cs.ep_phase),
                         ("pipeline", cs.pipeline_phase)):
            t0 = time.perf_counter()
            good = bool(fn(counts, ident, shard))
            print(f"phase {name} over {ranks.backend}: {'ok' if good else 'FAIL'} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            ok &= good
    finally:
        cs._close_ranks(shard)
    print(f"launches over the ranks: {counts}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
