"""Llama-style transformer: serving and training (counterpart of mfa_tpu/models/llama.py).

Params are a plain dict of tensors: `layers` is a list of per-layer dicts
(wq, wk, wv, wo, attn_norm, mlp_norm, w_gate, w_up, w_down), plus embed,
final_norm and lm_head. Projections are plain `@` (as the JAX package
leaves them to XLA); attention runs through the port's kernels:
prefill_batch -> kernels/prefill.py (kernel 1), prefill_chunk_batch ->
kernels/paged_prefill.py (kernel 5), decode_step -> kernels/paged.py
(kernel 3), over the int8 or bf16 paged cache; forward / loss_fn /
train_step -> kernels/autodiff.flash_attention_grad (kernel 1 forward, the
fused backward kernel).

decode_step keeps the JAX package's DEFERRED-APPEND structure: each layer
attends over the stored cache with pos_offset=1 and return_lse=True, the
token's own K/V row is merged by exact LSE (_merge_deferred: the quantized
row contracts in bf16 and its scale applies after the contraction), and
ONE append after the layer loop writes every layer's row. In PyTorch the
XLA copy-insertion reason for it does not exist, but it defines the
reference numerics.

Not ported yet (raise NotImplementedError): MoE, qk_norm, sliding layer
patterns, int8 weights, meshes, vision.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from mfa_tpu_torch.cache.paged_cache import (StackedKVCache,
                                             create_stacked_cache,
                                             pack_pages_payload,
                                             scatter_span_rows)
from mfa_tpu_torch.dispatch.config import resolve_device
from mfa_tpu_torch.kernels.autodiff import flash_attention_grad
from mfa_tpu_torch.kernels.paged import paged_attention
from mfa_tpu_torch.kernels.paged_prefill import paged_prefill_attention
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.kernels.quant import quantize_rows


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # Mistral-style uniform sliding window (None = full causal).
    sliding_window: Optional[int] = None
    # linear RoPE position scaling, and the non-linear inv_freq rescale
    # tuple ("llama3", ...) / ("yarn", ...) of mfa_tpu's LlamaConfig
    rope_scale: float = 1.0
    rope_scaling: Optional[tuple] = None
    # family knobs of the JAX config that this slice does not serve yet
    n_experts: int = 0
    qk_norm: bool = False
    layer_pattern: Optional[tuple] = None

    def __post_init__(self):
        if self.n_experts or self.qk_norm or self.layer_pattern:
            raise NotImplementedError(
                "MoE, qk_norm and sliding layer patterns are not ported yet")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def attn_scale(self) -> float:
        return self.head_dim ** -0.5

    @property
    def window_left(self) -> int:
        return -1 if self.sliding_window is None else self.sliding_window - 1

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """meta-llama/Meta-Llama-3-8B config.json: 32 layers, dim 4096,
        32 q / 8 kv heads, ffn 14336, vocab 128256, rope_theta 5e5."""
        return LlamaConfig(vocab_size=128256)

    @staticmethod
    def tiny(vocab=256, dim=128, layers=2, heads=4, kv_heads=2, ffn=256,
             dtype=torch.float32, **kw) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab, dim=dim, n_layers=layers, n_heads=heads,
            n_kv_heads=kv_heads, ffn_dim=ffn, dtype=dtype, **kw,
        )


Params = Dict[str, Any]
_NORMS = ("attn_norm", "mlp_norm", "final_norm")
_LAYER_KEYS = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm", "w_gate",
               "w_up", "w_down")


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda",
                quantize: Optional[str] = None) -> Params:
    """Random weights in cfg.dtype from a seeded torch.Generator on the
    device (normal * fan_in^-0.5, embed * 0.02, norms at one). int8
    weights (quantize="int8") are not ported yet."""
    if quantize is not None:
        raise NotImplementedError("int8 weights are not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hd = cfg.dim, cfg.head_dim

    def dense(shape, scale=None):
        w = torch.randn(shape, generator=gen, device=dev, dtype=cfg.dtype)
        return w.mul_(scale if scale is not None else shape[-2] ** -0.5)

    def norm():
        return torch.ones((d,), dtype=torch.float32, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append(dict(
            wq=dense((d, cfg.n_heads * hd)),
            wk=dense((d, cfg.n_kv_heads * hd)),
            wv=dense((d, cfg.n_kv_heads * hd)),
            wo=dense((cfg.n_heads * hd, d)),
            attn_norm=norm(),
            mlp_norm=norm(),
            w_gate=dense((d, cfg.ffn_dim)),
            w_up=dense((d, cfg.ffn_dim)),
            w_down=dense((cfg.ffn_dim, d)),
        ))
    return dict(layers=layers, embed=dense((cfg.vocab_size, d), 0.02),
                final_norm=norm(), lm_head=dense((d, cfg.vocab_size)))


def params_from_numpy(tree, cfg: LlamaConfig, device) -> Params:
    """The JAX package's params pytree (numpy arrays; layers stacked
    [L, ...] as mfa_tpu's init_params builds them) -> this port's params,
    so both packages compute the same function in the tests."""
    dev = torch.device(device)

    def t(a, name):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        dtype = torch.float32 if name in _NORMS else cfg.dtype
        return torch.tensor(a, dtype=dtype, device=dev)

    stacked = tree["layers"]
    extra = set(stacked) - set(_LAYER_KEYS)
    if extra:
        raise NotImplementedError(f"layer params {sorted(extra)} are not "
                                  f"ported yet")
    layers = [{k: t(stacked[k][i], k) for k in _LAYER_KEYS}
              for i in range(cfg.n_layers)]
    return dict(layers=layers, embed=t(tree["embed"], "embed"),
                final_norm=t(tree["final_norm"], "final_norm"),
                lm_head=t(tree["lm_head"], "lm_head"))


def _rms_norm(x, w, cfg: LlamaConfig):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + cfg.norm_eps) * w).to(x.dtype)


def _qkv(h, lp, cfg: LlamaConfig, *lead):
    hd = cfg.head_dim
    q = (h @ lp["wq"]).reshape(*lead, cfg.n_heads, hd)
    k = (h @ lp["wk"]).reshape(*lead, cfg.n_kv_heads, hd)
    v = (h @ lp["wv"]).reshape(*lead, cfg.n_kv_heads, hd)
    return q, k, v


def _mlp(x, lp, cfg: LlamaConfig):
    h = _rms_norm(x, lp["mlp_norm"], cfg)
    gate = torch.nn.functional.silu(h @ lp["w_gate"])
    return x + (gate * (h @ lp["w_up"])) @ lp["w_down"]


def _attn_residual(x, attn_flat, lp, cfg: LlamaConfig):
    """o-projection + residual. attn_flat: [..., n_heads*head_dim]."""
    return x + attn_flat.to(x.dtype) @ lp["wo"]


def _embed(params, tokens, cfg: LlamaConfig):
    return params["embed"][tokens]


def _unembed(params, x, cfg: LlamaConfig):
    return (x @ params["lm_head"]).float()


def _scaled_inv_freq(scaling: tuple, inv_freq: np.ndarray, hd: int,
                     theta: float):
    """Rescale base inv_freq per LlamaConfig.rope_scaling (pure numpy).
    Returns (inv_freq, mscale) where mscale multiplies cos/sin. Mirrors
    transformers' "llama3" and "yarn" rope init functions."""
    kind = scaling[0]
    if kind == "llama3":
        _, factor, low_ff, high_ff, orig_ctx = scaling
        low_wavelen = orig_ctx / low_ff
        high_wavelen = orig_ctx / high_ff
        wavelen = 2 * math.pi / inv_freq
        smooth = (orig_ctx / wavelen - low_ff) / (high_ff - low_ff)
        blended = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        out = np.where(wavelen < high_wavelen, inv_freq,
                       np.where(wavelen > low_wavelen, inv_freq / factor,
                                blended))
        return out.astype(np.float32), 1.0
    if kind == "yarn":
        _, factor, attention_factor, beta_fast, beta_slow, orig_ctx = scaling
        half = hd // 2

        def correction_dim(num_rot):
            return (hd * math.log(orig_ctx / (num_rot * 2 * math.pi))
                    ) / (2 * math.log(theta))

        low = max(math.floor(correction_dim(beta_fast)), 0)
        high = min(math.ceil(correction_dim(beta_slow)), hd - 1)
        ramp = (np.arange(half, dtype=np.float32) - low) / max(high - low,
                                                               0.001)
        extrapolation_factor = 1 - np.clip(ramp, 0, 1)
        out = (inv_freq / factor * (1 - extrapolation_factor)
               + inv_freq * extrapolation_factor)
        return out.astype(np.float32), float(attention_factor)
    raise NotImplementedError(f"rope_scaling kind {kind!r}")


@functools.lru_cache(maxsize=None)
def _inv_freq(hd: int, theta: float, scale: float, scaling: Optional[tuple],
              device: torch.device):
    """(inv_freq [hd/2] fp32 on device, mscale), computed once in numpy
    fp32 exactly as the JAX package does, then kept on the device (a
    per-call host-to-device copy would stall the stream every layer)."""
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    mscale = 1.0
    if scaling is not None:
        freqs, mscale = _scaled_inv_freq(scaling, freqs, hd, theta)
    if scale != 1.0:
        freqs = freqs / scale
    return torch.as_tensor(np.asarray(freqs, np.float32), device=device), mscale


def _rope_tables(positions, hd: int, theta: float, scale: float = 1.0,
                 scaling: Optional[tuple] = None):
    """(cos, sin) [..., seq, 1, hd/2] fp32 for positions [..., seq]."""
    freqs, mscale = _inv_freq(hd, theta, scale, scaling, positions.device)
    angles = positions[..., None].float() * freqs
    return (torch.cos(angles)[..., None, :] * mscale,
            torch.sin(angles)[..., None, :] * mscale)


def _apply_rope(x, cos, sin):
    """Split-half rotation in fp32. x: [..., seq, heads, head_dim]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _rope(x, positions, theta: float, scale: float = 1.0,
          scaling: Optional[tuple] = None):
    """Rotary embedding, split-half rotation with fp32 angles.
    x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta, scale,
                                        scaling))


def _rope_args(cfg: LlamaConfig):
    return (cfg.rope_theta, cfg.rope_scale, cfg.rope_scaling)


# ---------------- training path ----------------


def param_tensors(params: Params) -> list:
    """Every weight tensor of the params, in a fixed order (what an
    optimizer is built over)."""
    return ([lp[k] for lp in params["layers"] for k in _LAYER_KEYS]
            + [params[k] for k in ("embed", "final_norm", "lm_head")])


def _train_layer(x, lp, rope, cfg: LlamaConfig):
    """One decoder layer on the full sequence x [b, s, dim]: causal flash
    attention through the differentiable kernels (_attention_sharded of the
    JAX package without a mesh), then the MLP."""
    b, s, _ = x.shape
    h = _rms_norm(x, lp["attn_norm"], cfg)
    q, k, v = _qkv(h, lp, cfg, b, s)
    q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
    attn = flash_attention_grad(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
        softmax_scale=cfg.attn_scale, window_size=(cfg.window_left, -1)
    ).transpose(1, 2)
    x = _attn_residual(x, attn.reshape(b, s, cfg.n_heads * cfg.head_dim), lp,
                       cfg)
    return _mlp(x, lp, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False, input_embeds=None,
            image_block_ids=None) -> torch.Tensor:
    """Full-sequence causal forward: tokens [b, s] -> logits [b, s, vocab]
    fp32. remat=True checkpoints each layer (torch.utils.checkpoint,
    non-reentrant): the backward recomputes the layer, so its attention
    forward runs twice. input_embeds / image_block_ids (vision) are not
    ported yet."""
    if input_embeds is not None or image_block_ids is not None:
        raise NotImplementedError("input_embeds and image_block_ids (vision) "
                                  "are not ported yet")
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)[None]
    rope = _rope_tables(positions, cfg.head_dim, *_rope_args(cfg))
    for lp in params["layers"]:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _train_layer, x, lp, rope, cfg, use_reentrant=False)
        else:
            x = _train_layer(x, lp, rope, cfg)
    x = _rms_norm(x, params["final_norm"], cfg)
    return _unembed(params, x, cfg)


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy of tokens [b, s] (tokens[:, :-1]
    predict tokens[:, 1:])."""
    logits = forward(params, tokens[:, :-1], cfg, remat=remat)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))


def train_step(params: Params, tokens, cfg: LlamaConfig, lr: float = 1e-3,
               remat: bool = False, optimizer=None):
    """One training step -> (params, loss).

    Unlike the pure JAX version this updates the weight tensors IN PLACE
    (under torch.no_grad()) and returns the same dict: without an optimizer
    by plain SGD, p - lr * g in p's dtype (the JAX default); with a
    torch.optim.Optimizer built over param_tensors(params) (the counterpart
    of an optax transformation, its state held by the optimizer object) by
    optimizer.step(). The weights become leaf tensors that require grad;
    on return each holds this step's gradient in .grad (cleared at the
    start of the next step)."""
    leaves = param_tensors(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    tokens = torch.as_tensor(tokens, device=leaves[0].device).long()
    loss = loss_fn(params, tokens, cfg, remat=remat)
    loss.backward()
    with torch.no_grad():
        if optimizer is None:
            for p in leaves:
                p.sub_(lr * p.grad.to(p.dtype))
        else:
            optimizer.step()
    return params, loss.detach()


# ---------------- serving path (paged cache) ----------------


def build_kv_caches(cfg: LlamaConfig, num_pages: int, page_size: int,
                    max_seqs: int, pages_per_seq: int,
                    quant_dtype: Optional[str] = None,
                    device="cuda") -> StackedKVCache:
    """One StackedKVCache covering every layer (shared block table and
    lengths; merged page pool)."""
    return create_stacked_cache(
        n_layers=cfg.n_layers, num_pages=num_pages, page_size=page_size,
        num_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        max_seqs=max_seqs, pages_per_seq=pages_per_seq, dtype=cfg.dtype,
        quant_dtype=quant_dtype, device=resolve_device(device),
    )


def _store_rows(quant_dtype: Optional[str], store_dtype, x):
    """-> (payload in cache storage dtype, per-row scales or None)."""
    if quant_dtype is None:
        return x.to(store_dtype), None
    return quantize_rows(x, quant_dtype)


def _merge_deferred(o_c, lse_c, q, kq, ks_new, vq, vs_new, cfg: LlamaConfig):
    """Exact LSE merge of the query's OWN K/V row into the paged-cache
    attention result (the row is appended after the layer loop).

    Numerics mirror the kernel's treatment had the row been stored: the
    payload contracts in bf16 when quantized, the per-row scale applies
    AFTER the contraction, fp32 softmax algebra.

    o_c: [n, 1, heads, d] normalized cache output; lse_c: [n, 1, heads]
    natural-log LSE (-inf for an empty cache row); q: [n, 1, heads, d];
    kq/vq: [hkv, n, d] payload rows; ks/vs: [hkv, n] fp32 or None.
    Returns [n, 1, heads, d] in o_c's dtype.
    """
    n, span, heads, d = q.shape
    hkv = cfg.n_kv_heads
    group = heads // hkv
    kr = kq.reshape(hkv, n, span, d).permute(1, 2, 0, 3)  # [n, span, hkv, d]
    vr = vq.reshape(hkv, n, span, d).permute(1, 2, 0, 3)
    quantized = ks_new is not None
    qg = q.reshape(n, span, hkv, group, d)
    if quantized:  # int8 -> bf16 is exact; q rounds to bf16 as in the kernel
        qg, kr_c = qg.to(torch.bfloat16), kr.to(torch.bfloat16)
    else:
        kr_c = kr
    s = torch.einsum("nihgd,njhd->nhgij", qg.float(), kr_c.float())
    if quantized:
        s = s * ks_new.reshape(hkv, n, span).permute(1, 0, 2)[:, :, None, None, :]
        vd = vr.float() * vs_new.reshape(hkv, n, span).permute(1, 2, 0)[..., None]
    else:
        vd = vr.float()
    s = s * cfg.attn_scale
    m_loc = s.amax(dim=-1)  # [n, hkv, group, span]
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("nhgij,njhd->nhgid", p, vd)
    lse = lse_c.reshape(n, span, hkv, group).permute(0, 2, 3, 1)
    m = torch.maximum(lse, m_loc)
    a = torch.where(torch.isneginf(lse), torch.zeros_like(lse),
                    torch.exp(lse - m))
    b = torch.exp(m_loc - m) * l_loc
    oc = o_c.reshape(n, span, hkv, group, d).permute(0, 2, 3, 1, 4).float()
    o = (oc * a[..., None] + o_loc * torch.exp(m_loc - m)[..., None]) / (
        a + b)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(n, span, heads, d).to(o_c.dtype)


def _append_all_layers(cache: StackedKVCache, kq_all, ks_all, vq_all, vs_all,
                       page_ids, offs) -> None:
    """IN PLACE: ONE scatter appending every layer's deferred K/V rows.
    kq_all/vq_all: [L, hkv, R, d]; ks/vs: [L, hkv, R] or None;
    page_ids/offs: [R] LOGICAL page + row offset (layer l adds
    l * num_pages)."""
    L, hkv, R, d = kq_all.shape
    dev = kq_all.device
    lids = (page_ids.long()[None, :]
            + torch.arange(L, device=dev)[:, None] * cache.num_pages
            ).reshape(-1)
    loffs = offs.long().repeat(L)
    scatter_span_rows(cache.k_pages, lids, loffs,
                      kq_all.transpose(0, 1).reshape(hkv, L * R, d))
    scatter_span_rows(cache.v_pages, lids, loffs,
                      vq_all.transpose(0, 1).reshape(hkv, L * R, d))
    if ks_all is not None:
        cache.k_scales[:, lids, loffs] = ks_all.transpose(0, 1).reshape(hkv, L * R)
        cache.v_scales[:, lids, loffs] = vs_all.transpose(0, 1).reshape(hkv, L * R)


def prefill_batch(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                  pages_list, token_lists):
    """Prefill n prompts in one batched pass; writes their K/V pages and
    table rows IN PLACE. Prompts are padded to a shared power-of-two page
    count (as in the JAX package); padded rows write into the null page 0
    and are never attended (causal mask + true-length logits gather).

    seq_slots: [n] slot ids; pages_list: per-request page id lists;
    token_lists: per-request token lists. Returns (cache, logits [n, vocab]
    fp32) at each prompt's last position.
    """
    page = cache.page_size
    pps = cache.pages_per_seq
    token_lists = [np.asarray(t, np.int64) for t in token_lists]
    lens = [int(t.shape[0]) for t in token_lists]
    n_need = max(-(-l // page) for l in lens)
    if n_need > pps:
        raise ValueError("prompt longer than the block table width")
    n_bucket = min(max(1 << max(n_need - 1, 0).bit_length(), 1), pps)
    s_pad = n_bucket * page
    n = len(token_lists)
    toks = np.zeros((n, s_pad), np.int64)
    page_ids = np.zeros((n, n_bucket), np.int64)
    table_rows = np.zeros((n, pps), np.int32)
    for i, (t, pgs) in enumerate(zip(token_lists, pages_list)):
        toks[i, : lens[i]] = t
        need_i = -(-lens[i] // page)
        page_ids[i, :need_i] = np.asarray(list(pgs[:need_i]), np.int64)
        table_rows[i, : len(pgs)] = np.asarray(list(pgs), np.int32)
    dev = cache.lengths.device

    def dev_t(a):
        return torch.as_tensor(a, device=dev)

    return _prefill(params, cfg, cache, dev_t(np.asarray(seq_slots, np.int64)),
                    dev_t(table_rows), dev_t(page_ids), dev_t(toks),
                    dev_t(np.asarray(lens, np.int32)))


def _prefill(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
             table_rows, page_ids, tokens, true_lens):
    n, s = tokens.shape
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    page = cache.page_size
    npg = page_ids.shape[1]
    x = _embed(params, tokens, cfg)  # [n, s, d]
    positions = torch.arange(s, device=x.device)[None]
    store = cache.k_pages.dtype
    rope = _rope_tables(positions, hd, *_rope_args(cfg))
    ys = []
    for lp in params["layers"]:
        h = _rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(h, lp, cfg, n, s)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        # page payload [n, s, hkv, d] -> [hkv, n*npg, page, d]; appended
        # for all layers by one scatter after the loop, as in JAX
        kq, ks_new = _store_rows(cache.quant_dtype, store, k.permute(2, 0, 1, 3))
        vq, vs_new = _store_rows(cache.quant_dtype, store, v.permute(2, 0, 1, 3))
        kq = pack_pages_payload(kq, n * npg, page)
        vq = pack_pages_payload(vq, n * npg, page)
        attn = prefill_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, softmax_scale=cfg.attn_scale,
            window_size=(cfg.window_left, -1)).transpose(1, 2)
        x = _attn_residual(x, attn.reshape(n, s, cfg.n_heads * hd), lp, cfg)
        x = _mlp(x, lp, cfg)
        if ks_new is not None:
            ks_new = ks_new.reshape(hkv, n * npg, page)
            vs_new = vs_new.reshape(hkv, n * npg, page)
        ys.append((kq, ks_new, vq, vs_new))
    # ONE page-level scatter for every layer's pages
    L = cfg.n_layers
    lids = (page_ids.reshape(-1)[None, :]
            + torch.arange(L, device=x.device)[:, None] * cache.num_pages
            ).reshape(-1)

    def flat(i):  # L x [hkv, n*npg, ...] -> [hkv, L*n*npg, ...]
        a = torch.stack([y[i] for y in ys], dim=1)
        return a.reshape(a.shape[0], -1, *a.shape[3:])

    cache.k_pages[:, lids] = flat(0)
    cache.v_pages[:, lids] = flat(2)
    if cache.k_scales is not None:
        cache.k_scales[:, lids] = flat(1)
        cache.v_scales[:, lids] = flat(3)
    x = _rms_norm(x, params["final_norm"], cfg)
    last = x[torch.arange(n, device=x.device), (true_lens.long() - 1).clamp(min=0)]
    logits = _unembed(params, last, cfg)
    cache.block_tables[seq_slots] = table_rows
    cache.lengths[seq_slots] = true_lens
    return cache, logits


def prefill_chunk_batch(params, cfg: LlamaConfig, cache: StackedKVCache,
                        reqs_slots, reqs_pages, chunk_tokens, offsets, totals,
                        chunk: int):
    """Advance n prompts by one chunk each, in one batched pass (chunked
    prefill and prefix-cache suffixes). chunk_tokens[i]: THIS chunk's
    tokens (len <= chunk); offsets[i]: absolute, page-aligned position of
    its first token; totals[i]: the full prompt length. Writes the chunk's
    K/V pages, and for rows that finish their prompt the lengths, IN
    PLACE. Returns (cache, logits [n, vocab] fp32): row i is meaningful iff
    the row finished (offsets[i] + len(chunk_tokens[i]) >= totals[i])."""
    page = cache.page_size
    if chunk % page:
        raise ValueError(f"chunk {chunk} is not a multiple of the page size "
                         f"{page}")
    n = len(reqs_slots)
    toks = np.zeros((n, chunk), np.int64)
    offs = np.zeros((n,), np.int64)
    table_rows = np.zeros((n, cache.pages_per_seq), np.int32)
    finals = np.zeros((n,), bool)
    final_lens = np.zeros((n,), np.int64)
    for i in range(n):
        ct = np.asarray(chunk_tokens[i], np.int64)
        if int(offsets[i]) % page or ct.shape[0] > chunk:
            raise ValueError(f"row {i}: offset {offsets[i]} must be page "
                             f"aligned and the chunk at most {chunk} tokens")
        toks[i, : ct.shape[0]] = ct
        offs[i] = int(offsets[i])
        finals[i] = int(offsets[i]) + ct.shape[0] >= int(totals[i])
        final_lens[i] = int(totals[i])
        table_rows[i, : len(reqs_pages[i])] = np.asarray(
            list(reqs_pages[i]), np.int32)
    dev = cache.lengths.device

    def dev_t(a):
        return torch.as_tensor(a, device=dev)

    return _prefill_chunk(params, cfg, cache,
                          dev_t(np.asarray(reqs_slots, np.int64)),
                          dev_t(table_rows), dev_t(toks), dev_t(offs),
                          dev_t(finals), dev_t(final_lens))


def _prefill_chunk(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                   table_rows, tokens, offsets, final_mask, final_lens):
    """One chunk for each of n prompts (mfa_tpu's _prefill_chunk_jit).

    WRITE-THEN-ATTEND, as in the JAX package: each layer first writes the
    chunk's (quantized) K/V rows into its pages, then the paged prefill
    kernel reads the prefix and the chunk back through the block table
    with kv_len = min(final_lens, offsets + chunk) and q_start = offsets,
    so the chunk attends to its own rows after quantization. Padded chunk
    rows past the table width write into the null page 0."""
    n, chunk = tokens.shape
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    page = cache.page_size
    pps = cache.pages_per_seq
    chunk_pages = chunk // page
    P = cache.num_pages  # merged-pool per-layer stride
    dev = tokens.device
    x = _embed(params, tokens, cfg)  # [n, chunk, d]
    positions = offsets[:, None] + torch.arange(chunk, device=dev)[None]
    pidx = offsets[:, None] // page + torch.arange(chunk_pages, device=dev)[None]
    page_ids = torch.where(
        pidx < pps, table_rows.long().gather(1, pidx.clamp(max=pps - 1)),
        torch.zeros((), dtype=torch.long, device=dev)).reshape(-1)
    kv_len = torch.minimum(final_lens, offsets + chunk)
    store = cache.k_pages.dtype
    rope = _rope_tables(positions, hd, *_rope_args(cfg))
    for li, lp in enumerate(params["layers"]):
        h = _rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(h, lp, cfg, n, chunk)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        ids_l = page_ids + li * P
        kq, ks_new = _store_rows(cache.quant_dtype, store,
                                 k.permute(2, 0, 1, 3).reshape(hkv, -1, hd))
        vq, vs_new = _store_rows(cache.quant_dtype, store,
                                 v.permute(2, 0, 1, 3).reshape(hkv, -1, hd))
        cache.k_pages[:, ids_l] = pack_pages_payload(kq, n * chunk_pages, page)
        cache.v_pages[:, ids_l] = pack_pages_payload(vq, n * chunk_pages, page)
        if ks_new is not None:
            cache.k_scales[:, ids_l] = ks_new.reshape(hkv, n * chunk_pages, page)
            cache.v_scales[:, ids_l] = vs_new.reshape(hkv, n * chunk_pages, page)
        attn = paged_prefill_attention(
            q.to(cfg.dtype), cache.k_pages, cache.v_pages, kv_len, offsets,
            table_rows + li * P, k_scales=cache.k_scales,
            v_scales=cache.v_scales, softmax_scale=cfg.attn_scale,
            causal=True, window_left=cfg.window_left,
            quant_dtype=cache.quant_dtype)
        x = _attn_residual(x, attn.reshape(n, chunk, cfg.n_heads * hd), lp, cfg)
        x = _mlp(x, lp, cfg)
    x = _rms_norm(x, params["final_norm"], cfg)
    last_idx = torch.clamp(final_lens - 1 - offsets, 0, chunk - 1)
    logits = _unembed(params, x[torch.arange(n, device=dev), last_idx], cfg)
    cache.lengths[seq_slots] = torch.where(
        final_mask, final_lens, cache.lengths[seq_slots].long()
    ).to(cache.lengths.dtype)
    cache.block_tables[seq_slots] = table_rows
    return cache, logits


def prefill_chunk(params, cfg: LlamaConfig, cache: StackedKVCache,
                  seq_slot: int, pages, tokens_1d, offset: int,
                  total_len: int):
    """Single-request convenience over prefill_chunk_batch: prefill this
    chunk (tokens_1d, starting at absolute page-aligned `offset`) into slot
    seq_slot. Returns (cache, logits [vocab] on the final chunk, else
    None)."""
    tokens_1d = np.asarray(tokens_1d, np.int64)
    n_tok = int(tokens_1d.shape[0])
    chunk = -(-n_tok // cache.page_size) * cache.page_size
    cache, logits = prefill_chunk_batch(
        params, cfg, cache, [seq_slot], [list(pages)], [tokens_1d], [offset],
        [total_len], chunk)
    return cache, (logits[0] if offset + n_tok >= total_len else None)


def decode_step(params, cfg: LlamaConfig, cache: StackedKVCache, seq_slots,
                tokens):
    """One decode step for the active batch (DEFERRED-APPEND design).

    seq_slots: [n] cache rows; tokens: [n] current tokens. Returns (cache,
    logits [n, vocab] fp32); the cache is updated IN PLACE. On return the
    consumed token's K/V is in the cache and lengths include it (engine
    invariant lengths == prompt + generated[:-1]).
    """
    dev = cache.lengths.device
    slots = torch.as_tensor(seq_slots, device=dev).long()
    tokens = torch.as_tensor(tokens, device=dev).long()
    n = tokens.shape[0]
    hd = cfg.head_dim
    page = cache.page_size
    lens = cache.lengths[slots]  # [n] int32
    write_pages = cache.block_tables[slots, (lens // page).long()]
    offs = lens % page
    tables = cache.block_tables[slots]
    x = _embed(params, tokens, cfg)[:, None]  # [n, 1, d]
    positions = lens[:, None]
    store = cache.k_pages.dtype
    rope = _rope_tables(positions, hd, *_rope_args(cfg))
    ys = []
    for li, lp in enumerate(params["layers"]):
        h = _rms_norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(h, lp, cfg, n, 1)
        q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        kq, ks_new = _store_rows(cache.quant_dtype, store, k[:, 0].transpose(0, 1))
        vq, vs_new = _store_rows(cache.quant_dtype, store, v[:, 0].transpose(0, 1))
        o_c, lse_c = paged_attention(
            q[:, 0].to(cfg.dtype), cache.k_pages, cache.v_pages, lens,
            tables + li * cache.num_pages, k_scales=cache.k_scales,
            v_scales=cache.v_scales, softmax_scale=cfg.attn_scale,
            window_left=cfg.window_left, quant_dtype=cache.quant_dtype,
            pos_offset=1, return_lse=True,
        )  # [n, heads, hd], [n, heads]
        attn = _merge_deferred(o_c[:, None], lse_c[:, None], q, kq, ks_new,
                               vq, vs_new, cfg)[:, 0]
        x = _attn_residual(x, attn.reshape(n, 1, cfg.n_heads * hd), lp, cfg)
        x = _mlp(x, lp, cfg)
        ys.append((kq, ks_new, vq, vs_new))
    kq_all, vq_all = (torch.stack([y[i] for y in ys]) for i in (0, 2))
    ks_all = vs_all = None
    if cache.k_scales is not None:
        ks_all, vs_all = (torch.stack([y[i] for y in ys]) for i in (1, 3))
    _append_all_layers(cache, kq_all, ks_all, vq_all, vs_all, write_pages, offs)
    x = _rms_norm(x, params["final_norm"], cfg)
    logits = _unembed(params, x[:, 0], cfg)
    cache.lengths[slots] = lens + 1
    return cache, logits
