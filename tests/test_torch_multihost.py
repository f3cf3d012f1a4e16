"""The port's multi-host helpers (mfa_tpu_torch/serve/multihost.py) against
mfa_tpu's (tests/test_multihost.py, case by case): the single-process
forms in this process, and the real multi-process ones in 2 gloo ranks on
the CPU spawned once for this file (tests/torch_rank_fns.py holds their
functions, free of JAX), as mfa_tpu's two-process tests run 2
jax.distributed processes. Engine replicas must be token-identical to
mfa_tpu's engine on the same fp32 weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfa_tpu.models import llama as jl
from mfa_tpu.serve import multihost as jm
from mfa_tpu.serve.engine import Engine as JaxEngine
from mfa_tpu_torch.serve import multihost as tm
from mfa_tpu_torch.serve.engine import EngineStats
from mfa_tpu_torch.shard.launch import Ranks
from tests import torch_rank_fns as R
from tests.jax_maps import release_jax_code  # noqa: F401


@pytest.fixture(scope="module")
def ranks():
    with Ranks(2, device="cpu", threads=1, timeout_s=300) as r:
        yield r


def test_route_requests_disjoint_and_total():
    ids = list(range(37))
    parts = [tm.route_requests(ids, p, 4) for p in range(4)]
    assert parts == [jm.route_requests(ids, p, 4) for p in range(4)]
    assert sorted(x for part in parts for x in part) == ids
    for p in range(4):
        for q in range(p + 1, 4):
            assert not set(parts[p]) & set(parts[q])


def test_serving_mesh_local_model_axis(ranks):
    outs = ranks.run(R.serving_mesh_info, 2)
    assert [o["index"] for o in outs] == [0, 1]
    assert all(o["names"] == ("model",) and o["size"] == 2 for o in outs)
    one = ranks.run(R.serving_mesh_info, 1)  # two replicas of one rank
    assert all(o["names"] == ("model",) and o["size"] == 1 for o in one)
    errs = ranks.run(R.serving_mesh_info, 1024)
    assert all("exceeds 2 local ranks" in e for e in errs)


def test_hybrid_mesh_and_cross_process_psum(ranks):
    """make_hybrid_mesh({"data": 2}, {"model": 1}) across the 2 processes,
    a psum over "data" of each process's row block, and disjoint routing
    (mfa_tpu's two-process smoke: row blocks [0, 1] + [2, 3] -> [2, 4])."""
    rows = np.arange(4.0, dtype=np.float32).reshape(2, 2)
    outs = ranks.run(R.hybrid_psum, {"data": 2}, {"model": 1}, rows)
    for pid, o in enumerate(outs):
        assert o["names"] == ("data", "model") and o["sizes"] == [2, 1]
        np.testing.assert_array_equal(o["summed"].ravel(), [2.0, 4.0])
        assert o["pid"] == pid
    assert sorted(outs[0]["mine"] + outs[1]["mine"]) == list(range(10))
    assert not set(outs[0]["mine"]) & set(outs[1]["mine"])
    inner = ranks.run(R.hybrid_psum, {"data": 1}, {"model": 2}, rows[:1])
    assert all(o["sizes"] == [1, 2] for o in inner)


def test_init_distributed_single_host_noop():
    assert tm.init_distributed() == 0 == jax.process_index()


def test_aggregate_stats_single():
    s = EngineStats(prefill_tokens=10, decode_tokens=20, recoveries=1,
                    wall_s=2.0)
    agg = tm.aggregate_stats(s)
    assert isinstance(agg, tm.FleetStats)
    assert agg.prefill_tokens == 10 and agg.decode_tokens == 20
    assert agg.decode_tokens_per_s == 10.0


def test_two_process_engine_serving(ranks):
    """Each process runs a whole engine replica on a routed, disjoint share
    of 6 requests plus a control prompt both serve, then aggregates the
    fleet's stats with one all_gather. Every generation equals mfa_tpu's
    engine on the same weights; the fleet totals are the sums."""
    kw = dict(vocab=64, dim=32, layers=1, heads=2, kv_heads=2, ffn=64)
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    params = jl.init_params(jax.random.key(0), cfg)
    ekw = dict(num_pages=33, page_size=8, max_seqs=4, pages_per_seq=8)
    prompts = {i: [1 + i, 2 + i, 3, 4 + (i % 3)] for i in range(6)}
    control = [7, 8, 9]
    eng = JaxEngine(params, cfg, **ekw)
    reqs = {i: eng.submit(p, 5) for i, p in prompts.items()}
    ctl = eng.submit(control, 5)
    eng.run()
    a, b = ranks.run(R.replica_engines, R.plain(params), kw, ekw, prompts,
                     control, 5)
    assert not set(a["ids"]) & set(b["ids"])
    assert sorted(a["ids"] + b["ids"]) == list(range(6))
    for out in (a, b):
        assert out["control"] == ctl.generated
        for i, gen in out["gens"].items():
            assert gen == reqs[i].generated
        assert out["fleet_decode"] == a["local_decode"] + b["local_decode"]
    assert a["fleet_prefill"] == b["fleet_prefill"]
