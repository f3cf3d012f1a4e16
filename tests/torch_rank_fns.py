"""Rank-side functions of the port's sharding tests (tests/test_torch_shard.py,
test_torch_multihost.py, test_torch_expert_parallel.py,
test_torch_pipeline.py, test_torch_serve_sharded.py, test_torch_isolation.py).

They run in gloo ranks on the CPU (mfa_tpu_torch/shard/launch.py), which
import this module by name to unpickle them: it imports torch and the
port, never JAX, so the ranks stay free of it. Inputs and results are
numpy; a rank outside the mesh of a call returns None.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mfa_tpu_torch.shard import mesh as M


@dataclasses.dataclass
class NpQWeight:
    """A quantized leaf as numpy (read by params_from_numpy through its qw,
    scale and axis attributes), so a JAX QWeight's values reach the ranks
    without JAX."""

    qw: np.ndarray
    scale: np.ndarray
    axis: int


def plain(tree):
    """A params tree (JAX arrays, mfa_tpu QWeights) as dicts of numpy arrays
    and NpQWeight, for the ranks (called in the test process)."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if hasattr(tree, "qw") and hasattr(tree, "scale"):
        return NpQWeight(np.asarray(tree.qw), np.asarray(tree.scale),
                         int(tree.axis))
    return np.asarray(tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().numpy().copy()


def _mesh(axes):
    """-> the mesh, or None on a rank past it."""
    mesh = M.make_mesh(axes, "cpu")
    return mesh if mesh.get_coordinate() is not None else None


def _block(a, mesh, spec):
    """This rank's block of a numpy array under spec (axis names / None)."""
    t = _t(a)
    return M.shard_tensor(t, M.sharding(mesh, *spec))


def _coord(mesh):
    return {a: M.axis_index(mesh, a) for a in mesh.mesh_dim_names}


def fail_on_rank(bad_rank: int):
    """Rank bad_rank raises; the others wait in a collective it never
    joins (the launcher must end the group rather than hang)."""
    if torch.distributed.get_rank() == bad_rank:
        raise ValueError("rank failure on purpose")
    torch.distributed.barrier()
    return "unreachable"


# ---- mesh and multihost -------------------------------------------------


def mesh_info(axes):
    from mfa_tpu_torch.serve.multihost import init_distributed

    mesh = M.make_mesh(axes, "cpu")
    x = torch.tensor([float(torch.distributed.get_rank())])
    summed = {a: float(M.psum(x, mesh, a)) for a in mesh.mesh_dim_names} \
        if mesh.get_coordinate() is not None else None
    return dict(names=mesh.mesh_dim_names,
                sizes=[M.axis_size(mesh, a) for a in mesh.mesh_dim_names],
                coord=mesh.get_coordinate(), sums=summed,
                rank=init_distributed())


def make_mesh_error(axes):
    try:
        M.make_mesh(axes, "cpu")
    except ValueError as e:
        return str(e)
    return None


def collectives(axis_sizes):
    """Every helper on a 1-D ring: psum, pmax, ring_shift both ways,
    all_to_all, all_gather, send / recv, and the autograd pair."""
    (axis, n), = axis_sizes.items()
    mesh = _mesh(axis_sizes)
    if mesh is None:
        return None
    me = M.axis_index(mesh, axis)
    x = torch.arange(4, dtype=torch.float32) + 10 * me
    fwd, = M.ring_shift([x], mesh, axis, 1)
    back, = M.ring_shift([x], mesh, axis, -1)
    a2a = M.all_to_all(torch.arange(n, dtype=torch.float32)[:, None] + 10 * me,
                       mesh, axis)
    gathered = M.all_gather(x, mesh, axis)
    if me == 0:
        M.send_to(x * 2, mesh, axis, n - 1)
        got = None
    elif me == n - 1:
        got = _np(M.recv_from((4,), torch.float32, "cpu", mesh, axis, 0))
    else:
        got = None
    w = torch.ones(3, requires_grad=True)
    (M.reduce_from(w * (me + 1), mesh, axis).sum()).backward()
    g_reduce = _np(w.grad)
    w.grad = None
    (M.copy_to(w, mesh, axis) * (me + 1)).sum().backward()
    return dict(me=me, psum=_np(M.psum(x, mesh, axis)),
                pmax=_np(M.pmax(x, mesh, axis)), fwd=_np(fwd), back=_np(back),
                a2a=_np(a2a), gathered=_np(gathered), recv=got,
                g_reduce=g_reduce, g_copy=_np(w.grad))


def serving_mesh_info(tp):
    from mfa_tpu_torch.serve.multihost import serving_mesh

    try:
        mesh = serving_mesh(tp, "cpu")
    except ValueError as e:
        return str(e)
    return dict(names=mesh.mesh_dim_names, size=M.axis_size(mesh, "model"),
                index=M.axis_index(mesh, "model"))


def hybrid_psum(dcn, ici, rows):
    """make_hybrid_mesh, then each data-axis rank holds its block of rows
    and psums it over "data" (mfa_tpu's two-process smoke)."""
    from mfa_tpu_torch.serve.multihost import (init_distributed,
                                               make_hybrid_mesh,
                                               route_requests)

    mesh = make_hybrid_mesh(dcn, ici, "cpu")
    block = _block(rows, mesh, ("data", None))
    pid, n = init_distributed(), torch.distributed.get_world_size()
    return dict(names=mesh.mesh_dim_names,
                sizes=[M.axis_size(mesh, a) for a in mesh.mesh_dim_names],
                summed=_np(M.psum(block, mesh, "data")),
                mine=route_requests(list(range(10)), pid, n), pid=pid)


def replica_engines(tree, cfg_kw, engine_kw, prompts, control, n_new):
    """One engine replica per process over the same weights, a routed
    share of the requests each plus a control prompt, then the fleet's
    stats (mfa_tpu's two-process serving test)."""
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine
    from mfa_tpu_torch.serve.multihost import (aggregate_stats,
                                               init_distributed,
                                               route_requests)

    pid, n = init_distributed(), torch.distributed.get_world_size()
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    eng = Engine(llama.params_from_numpy(tree, cfg, "cpu"), cfg, device="cpu",
                 **engine_kw)
    mine = route_requests(sorted(prompts), pid, n)
    reqs = {i: eng.submit(prompts[i], n_new) for i in mine}
    ctl = eng.submit(control, n_new)
    stats = eng.run()
    fleet = aggregate_stats(stats)
    return dict(ids=mine, gens={i: r.generated for i, r in reqs.items()},
                control=ctl.generated, local_decode=stats.decode_tokens,
                fleet_decode=fleet.decode_tokens,
                fleet_prefill=fleet.prefill_tokens)


# ---- attention ------------------------------------------------------------


def sharded_prefill(axes, q, k, v, causal):
    from mfa_tpu_torch.shard.attention import sharded_flash_attn

    mesh = _mesh(axes)
    if mesh is None:
        return None
    spec = ("data", None, "model", None)
    f = sharded_flash_attn(mesh, causal=causal)
    out = f(*(_block(a, mesh, spec) for a in (q, k, v)))
    return _coord(mesh), _np(out)


def sharded_paged(axes, q, kp, vp, lens, table, ks=None, vs=None, quant=None):
    """quant: None, "int8", "fp8" (pages as their uint8 bits) or "int4"
    (the port's feature-pair bytes)."""
    from mfa_tpu_torch.kernels.quant import FP8
    from mfa_tpu_torch.shard.attention import sharded_paged_decode

    mesh = _mesh(axes)
    if mesh is None:
        return None
    f = sharded_paged_decode(mesh, quantized="int4" if quant == "int4"
                             else quant is not None)
    page = ("model", None, None, None)
    kp, vp = (_block(a, mesh, page) for a in (kp, vp))
    if quant == "fp8":
        kp, vp = kp.view(FP8), vp.view(FP8)
    args = [_block(q, mesh, ("data", "model", None)), kp, vp,
            _block(lens, mesh, ("data",)), _block(table, mesh, ("data", None))]
    if ks is not None:
        args += [_block(ks, mesh, ("model", None, None)),
                 _block(vs, mesh, ("model", None, None))]
    return _coord(mesh), _np(f(*args))


def cp_decode(axes, q, k, v, lens):
    from mfa_tpu_torch.shard.attention import context_parallel_decode

    mesh = _mesh(axes)
    if mesh is None:
        return None
    kv = (None, None, "ctx", None)
    f = context_parallel_decode(mesh)
    return _np(f(_t(q), _block(k, mesh, kv), _block(v, mesh, kv), _t(lens)))


def cp_paged_decode(axes, q, kp, vp, local_lens, local_tables):
    from mfa_tpu_torch.shard.attention import context_parallel_paged_decode

    mesh = _mesh(axes)
    if mesh is None:
        return None
    pool = (None, "ctx", None, None)
    me = M.axis_index(mesh, "ctx")
    f = context_parallel_paged_decode(mesh)
    return _np(f(_t(q), _block(kp, mesh, pool), _block(vp, mesh, pool),
                 _t(local_lens[me]), _t(local_tables[me])))


def ring_prefill(axes, q, k, v, kw):
    from mfa_tpu_torch.shard.ring import ring_attention_prefill

    mesh = _mesh(axes)
    if mesh is None:
        return None
    seq = (None, None, "ctx", None)
    f = ring_attention_prefill(mesh, **kw)
    return M.axis_index(mesh, "ctx"), _np(f(*(_block(a, mesh, seq)
                                              for a in (q, k, v))))


def ring_grad(axes, q, k, v, w, kw):
    """d/d(q, k, v) of sum(ring(q, k, v) * w) on this rank's chunks."""
    from mfa_tpu_torch.shard.ring import ring_attention_grad

    mesh = _mesh(axes)
    if mesh is None:
        return None
    seq = (None, None, "ctx", None)
    f = ring_attention_grad(mesh, **kw)
    qkv = [_block(a, mesh, seq).requires_grad_() for a in (q, k, v)]
    (f(*qkv) * _block(w, mesh, seq)).sum().backward()
    return M.axis_index(mesh, "ctx"), [_np(a.grad) for a in qkv]


def _tree_grads(params):
    from mfa_tpu_torch.models import llama

    return [None if p.grad is None else _np(p.grad)
            for p in llama.param_tensors(params)]


def sp_loss(axes, tree, cfg_kw, tokens):
    """sequence_parallel_loss_fn's value and every param's gradient
    (param_tensors order), or the refusal's message."""
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.shard.ring import sequence_parallel_loss_fn

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    params = llama.params_from_numpy(tree, cfg, "cpu")
    for p in llama.param_tensors(params):
        p.requires_grad_(True)
    try:
        loss = sequence_parallel_loss_fn(params, _t(tokens).long(), cfg, mesh)
    except ValueError as e:
        return str(e)
    loss.backward()
    return float(loss), _tree_grads(params)


# ---- expert parallelism ------------------------------------------------


def ep_moe(axes, cfg_kw, t, w_router, weg, weu, wed, a2a, capacity, dense):
    """expert_parallel_moe (t replicated) or expert_parallel_moe_a2a (t on
    "expert"); banks as numpy or NpQWeight."""
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.models.wquant import QWeight, adapt
    from mfa_tpu_torch.shard.expert import (expert_parallel_moe,
                                            expert_parallel_moe_a2a)

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    tp = "model" if "model" in axes else None
    specs = (("expert", None, tp), ("expert", None, tp), ("expert", tp, None))

    def bank(b, spec):
        if isinstance(b, NpQWeight):
            w = QWeight(_t(b.qw), _t(b.scale), b.axis)
            return llama._shard_leaf(w, adapt(M.sharding(mesh, *spec), w), "bank")
        return _block(b, mesh, spec)

    banks = [bank(b, s) for b, s in zip((weg, weu, wed), specs)]
    if a2a:
        fn = expert_parallel_moe_a2a(mesh, cfg, capacity_factor=capacity)
        out = fn(_block(t, mesh, ("expert", None)), _t(w_router), *banks)
        return M.axis_index(mesh, "expert"), _np(out)
    out = expert_parallel_moe(mesh, cfg, dense)(_t(t), _t(w_router), *banks)
    return 0, _np(out)


def ep_a2a_grads(axes, cfg_kw, t, w_router, weg, weu, wed, capacity):
    """Gradients of sum(a2a(...)^2) over the rank's banks (its E / ep
    experts) -> (expert index, [d we_gate, d we_up, d we_down])."""
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.shard.expert import expert_parallel_moe_a2a

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    banks = [_block(b, mesh, ("expert", None, None)).requires_grad_()
             for b in (weg, weu, wed)]
    fn = expert_parallel_moe_a2a(mesh, cfg, capacity_factor=capacity)
    out = fn(_block(t, mesh, ("expert", None)), _t(w_router), *banks)
    # the loss is the sum over every rank's tokens: each rank's share
    (out ** 2).sum().backward()
    return M.axis_index(mesh, "expert"), [_np(b.grad) for b in banks]


def moe_layer(axes, tree, cfg_kw, x):
    """llama._moe of layer 0 under the mesh (expert-parallel)."""
    from mfa_tpu_torch.models import llama

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    params = llama.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    return _np(llama._moe(_t(x), params["layers"][0], cfg, mesh=mesh))


# ---- pipeline -------------------------------------------------------------


def pipeline(axes, tree, cfg_kw, tokens, n_micro, what, lr=1e-3):
    """The rank's stage tree (params_from_numpy(mesh=)) through what:
    "loss" (pipeline_loss_fn), "grad" (pipeline_value_and_grad: loss and
    grads by global layer index), "step" (pipeline_train_step: loss and the
    updated stage params by global layer index) or "held" (the global
    indices of the layers the rank holds, their wq's shapes, and the
    ValueErrors of pipeline_loss_fn on the whole tree and of llama.forward
    on the stage tree)."""
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.shard import pipeline as pp

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    toks = _t(tokens).long()
    try:
        params = llama.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
        mine = llama.stage_layers(cfg, mesh)
        if what == "held":
            whole = llama.params_from_numpy(tree, cfg, "cpu")
            msgs = []
            for f in (lambda: pp.pipeline_loss_fn(whole, toks, cfg, mesh, n_micro),
                      lambda: llama.forward(params, toks, cfg)):
                try:
                    f()
                    msgs.append(None)
                except ValueError as e:
                    msgs.append(str(e))
            return (list(mine), [tuple(lp["wq"].shape) for lp in params["layers"]],
                    msgs)
        if what == "loss":
            return float(pp.pipeline_loss_fn(params, toks, cfg, mesh, n_micro))
        if what == "grad":
            loss, grads = pp.pipeline_value_and_grad(params, toks, cfg, mesh,
                                                     n_micro)
            return float(loss), {
                "layers": {i: {k: _np(g) for k, g in lg.items()}
                           for i, lg in zip(mine, grads["layers"])},
                **{k: _np(grads[k]) for k in ("embed", "final_norm", "lm_head")}}
        params, loss = pp.pipeline_train_step(params, toks, cfg, mesh, n_micro,
                                              lr)
        return float(loss), {
            "layers": {i: {k: _np(w) for k, w in lp.items()}
                       for i, lp in zip(mine, params["layers"])},
            **{k: _np(params[k]) for k in ("embed", "final_norm", "lm_head")}}
    except ValueError as e:
        return "ValueError: " + str(e)


# ---- tensor-parallel model and engine ----------------------------------


def _params(tree, cfg, mesh):
    from mfa_tpu_torch.models import llama

    return llama.params_from_numpy(tree, cfg, "cpu", mesh=mesh)


def tp_engine(axes, tree, cfg_kw, engine_kw, prompts, n_new, draft=None,
              fail_once=False, run_kw=None, first_wave=None):
    """Engine(mesh=) over the rank's shard -> tokens, the cache's kv heads,
    graph captures, recoveries and prompt tokens prefilled. draft: (tree,
    cfg_kw) of a speculative draft model, sharded too; fail_once: the
    first decode burst raises on every rank, so run(max_retries=1)
    recovers; first_wave: run the first that many prompts to the end
    before submitting the rest."""
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    kw = dict(engine_kw)
    if draft is not None:
        dcfg = llama.LlamaConfig.tiny(dtype=torch.float32, **draft[1])
        kw.update(draft_params=_params(draft[0], dcfg, mesh), draft_cfg=dcfg)
    eng = Engine(_params(tree, cfg, mesh), cfg, device="cpu", mesh=mesh, **kw)
    if fail_once:
        burst = eng.graphs.burst

        def failing(*a, **k):
            eng.graphs.burst = burst
            raise RuntimeError("injected step failure")

        eng.graphs.burst = failing
    reqs = []
    for wave in ((prompts,) if first_wave is None
                 else (prompts[:first_wave], prompts[first_wave:])):
        reqs += [eng.submit(p, n_new) for p in wave]
        eng.run(**(run_kw or {}))
    return dict(gens=[r.generated for r in reqs],
                kv_heads=int(eng.cache.k_pages.shape[0]),
                captures=eng.stats.captures, recoveries=eng.stats.recoveries,
                prefill_tokens=eng.stats.prefill_tokens)


def tp_engine_refusals(axes, tree, cfg_kw):
    """What Engine(mesh=) and the cache refuse -> their messages."""
    from mfa_tpu_torch.cache.paged_cache import (create_cache,
                                                 create_stacked_cache,
                                                 shard_cache)
    from mfa_tpu_torch.models import llama
    from mfa_tpu_torch.serve.engine import Engine

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    out = {}
    kw = dict(num_pages=8, page_size=16, num_kv_heads=3, head_dim=32,
              max_seqs=2, pages_per_seq=4, device="cpu")
    cache = create_stacked_cache(n_layers=1, **kw)
    layer = create_cache(quant_dtype="int8", **kw)
    for name, fn in (
            ("cache", lambda: shard_cache(cache, mesh, "model")),
            ("layer_cache", lambda: shard_cache(layer, mesh, "model")),
            ("full_params", lambda: Engine(llama.params_from_numpy(
                tree, cfg, "cpu"), cfg, device="cpu", mesh=mesh))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def layer_cache_shard(axes, k, v):
    """A per-layer int4 cache of k/v's kv heads holding the prompt k/v
    [s, hkv, d] -> (this rank's shard's tensors, the full cache's slice of
    this rank's kv heads): the shard is a copy of that slice."""
    from mfa_tpu_torch.cache.paged_cache import (create_cache, shard_cache,
                                                 write_prompt)

    mesh = _mesh(axes)
    if mesh is None:
        return None
    s, hkv, d = k.shape
    full = create_cache(num_pages=8, page_size=16, num_kv_heads=hkv, head_dim=d,
                        max_seqs=2, pages_per_seq=4, dtype=torch.float32,
                        quant_dtype="int4", device="cpu")
    write_prompt(full, 1, [3, 5], _t(k), _t(v))
    part = shard_cache(full, mesh, "model")
    n = hkv // M.axis_size(mesh, "model")
    lo = M.axis_index(mesh, "model") * n
    names = ("k_pages", "v_pages", "k_scales", "v_scales", "block_tables",
             "lengths")
    heads = ("k_pages", "v_pages", "k_scales", "v_scales")
    return ({f: _np(getattr(part, f)) for f in names},
            {f: _np(getattr(full, f)[lo: lo + n] if f in heads
                    else getattr(full, f)) for f in names},
            type(part).__name__)


def tp_decode_step(axes, tree, cfg_kw, prompt, token):
    """prefill on a full cache, then its kv-head shard and decode_step with
    the mesh -> logits and lengths."""
    from mfa_tpu_torch.cache.paged_cache import shard_cache
    from mfa_tpu_torch.models import llama

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    full = llama.params_from_numpy(tree, cfg, "cpu")
    cache = llama.build_kv_caches(cfg, 16, 16, 2, 4, device="cpu")
    cache, _ = llama.prefill_batch(full, cfg, cache, [0], [[1]], [prompt])
    cache = shard_cache(cache, mesh, "model")
    cache, logits = llama.decode_step(llama.shard_params(full, cfg, mesh), cfg,
                                      cache, [0], [token], mesh=mesh)
    return _np(logits), _np(cache.lengths)


def tp_train(axes, tree, cfg_kw, tokens, lr):
    """loss_fn and train_step under the mesh -> loss, and every updated
    param gathered back to its full shape over "model" (and checked equal
    across "data")."""
    from mfa_tpu_torch.models import llama

    mesh = _mesh(axes)
    if mesh is None:
        return None
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw)
    params = _params(tree, cfg, mesh)
    toks = _t(tokens).long()
    with torch.no_grad():
        loss = float(llama.loss_fn(params, toks, cfg, mesh=mesh))
    params, step_loss = llama.train_step(params, toks, cfg, lr=lr, mesh=mesh)
    specs = llama.param_shardings(cfg, mesh)
    full = []
    for lp, sp in zip(params["layers"], specs["layers"]):
        for k, w in lp.items():
            w = w.detach()
            for dim, entry in enumerate(sp[k].spec):
                if entry is not None:
                    w = torch.cat(list(M.all_gather(w, mesh, entry)), dim=dim)
            full.append(_np(w))
    full += [_np(params[k]) for k in ("embed", "final_norm", "lm_head")]
    M.assert_replicated(torch.tensor(full[-1]), mesh, "data", "lm_head")
    return loss, float(step_loss), full
