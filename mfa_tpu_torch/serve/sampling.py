"""Token sampling (counterpart of mfa_tpu/serve/sampling.py): greedy,
temperature, top-k, top-p (nucleus), min-p, the repetition penalty, per-row
parameters, and the rejection rule of speculative sampling.

Everything runs on the logits' device as PyTorch ops, so a decode step and
its draw can be captured into one CUDA graph (serve/graphs.py). The filter
order is JAX's: repetition penalty on the raw logits, temperature, top-k,
min-p, top-p.

Randomness comes from an explicit torch.Generator. JAX's
`categorical(key, l)` is `argmax(l + gumbel(key, l.shape))`; here the draw
is `_categorical(l, gumbel)` with Gumbel noise made from uniforms of the
caller's generator (`uniform_noise` -> `gumbel_from_uniform`). The draws
take their noise as an argument, so the same noise gives the same tokens
on any device, and JAX's own noise gives JAX's tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy argmax (top_k/top_p ignored).
    top_k == 0 -> no top-k truncation. top_p >= 1 -> no nucleus cut.
    min_p > 0 -> drop tokens whose probability is below min_p times the
    top token's (after temperature). repetition_penalty != 1 -> the HF
    penalty on every token present in the context (positive logits
    divided, negative multiplied); needs a presence mask."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def needs_presence(self) -> bool:
        return self.repetition_penalty != 1.0


def uniform_noise(shape, generator: Optional[torch.Generator], device,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 uniforms in [0, 1) from `generator`: one launch, the only place
    the sampler consumes randomness (into `out` when given)."""
    if out is not None:
        return torch.rand(out.shape, generator=generator, out=out)
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) with u clamped to [tiny, 1), as jax.random.gumbel."""
    return -torch.log(-torch.log(u.clamp(min=_TINY)))


def _categorical(l: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical given its Gumbel noise: the first index of
    the largest l + gumbel."""
    return torch.argmax(gumbel + l, dim=-1)


def _penalize(l: torch.Tensor, presence: torch.Tensor, pen) -> torch.Tensor:
    """The repetition penalty on present tokens (pen a float or [n, 1])."""
    penalized = torch.where(l > 0, l / pen, l * pen)
    return torch.where(presence, penalized, l)


def _top_k_mask(l: torch.Tensor, top_k: int) -> torch.Tensor:
    if top_k and top_k < l.shape[-1]:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = l.masked_fill(l < kth, float("-inf"))
    return l


def _top_p_cutoff(l: torch.Tensor, top_p) -> torch.Tensor:
    """The smallest kept logit of each row's nucleus: tokens are kept while
    the mass before them is < top_p."""
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    probs = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p
    return torch.where(keep, sorted_l, torch.full_like(sorted_l, float("inf"))
                       ).amin(dim=-1, keepdim=True)


def filtered_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature-scaled, truncation-masked fp32 logits: softmax of them is
    exactly what sample() draws from for stochastic params (shared with
    speculative_accept)."""
    l = logits.float() / params.temperature
    l = _top_k_mask(l, params.top_k)
    if params.min_p > 0.0:
        probs = torch.softmax(l, dim=-1)
        floor = params.min_p * probs.amax(dim=-1, keepdim=True)
        l = l.masked_fill(probs < floor, float("-inf"))
    if params.top_p < 1.0:
        l = l.masked_fill(l < _top_p_cutoff(l, params.top_p), float("-inf"))
    return l


def sample(logits: torch.Tensor, params: Optional[SamplingParams] = None,
           presence: Optional[torch.Tensor] = None,
           gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [n, vocab] -> token ids [n] int64.

    params None or greedy: argmax (first maximum on ties, as jnp.argmax).
    presence: optional [n, vocab] bool context mask for the repetition
    penalty. gumbel: [n, vocab] fp32 Gumbel noise, needed for stochastic
    params (gumbel_from_uniform of uniform_noise)."""
    params = params or SamplingParams()
    l = logits.float()
    if params.repetition_penalty != 1.0 and presence is not None:
        l = _penalize(l, presence, params.repetition_penalty)
    if params.greedy:
        return torch.argmax(l, dim=-1)
    if gumbel is None:
        raise ValueError("stochastic sampling needs Gumbel noise")
    return _categorical(filtered_logits(l, params), gumbel)


def sample_dynamic(logits: torch.Tensor, gumbel: torch.Tensor,
                   temperature: torch.Tensor, top_p: torch.Tensor,
                   min_p: torch.Tensor, rep_penalty: torch.Tensor,
                   top_k: int = 0,
                   presence: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row parameters ([n] fp32 each; temperature 0 = greedy row,
    rep_penalty 1 = none) in one sampler; top_k is static and batch-wide.
    presence: optional [n, vocab] bool. Every row draws from `gumbel`."""
    l = logits.float()
    if presence is not None:
        l = _penalize(l, presence, rep_penalty[:, None])
    greedy_ids = torch.argmax(l, dim=-1)
    ls = l / torch.clamp(temperature, min=1e-6)[:, None]
    ls = _top_k_mask(ls, top_k)
    probs = torch.softmax(ls, dim=-1)
    floor = min_p[:, None] * probs.amax(dim=-1, keepdim=True)
    ls = ls.masked_fill((min_p[:, None] > 0.0) & (probs < floor), float("-inf"))
    cutoff = _top_p_cutoff(ls, top_p[:, None])
    ls = ls.masked_fill((top_p[:, None] < 1.0) & (ls < cutoff), float("-inf"))
    sampled = _categorical(ls, gumbel)
    return torch.where(temperature <= 0.0, greedy_ids, sampled)


def _accept(ql: torch.Tensor, pl: torch.Tensor, d_toks: torch.Tensor,
            u: torch.Tensor, gumbel: torch.Tensor):
    """The rejection rule (mfa_tpu's _accept_jit) given its noise: u [n, k]
    uniforms for the acceptance tests, gumbel [n, vocab] for the residual
    draw. ql / pl: [n, k, vocab] filtered draft / target logits; d_toks
    [n, k]. -> (tokens [n, k] int64, m [n] int64)."""
    n, k, _ = ql.shape
    d_toks = d_toks.long()
    q = torch.softmax(ql, dim=-1)
    p = torch.softmax(pl, dim=-1)
    qx = torch.gather(q, -1, d_toks[..., None])[..., 0]
    px = torch.gather(p, -1, d_toks[..., None])[..., 0]
    acc = u * qx <= px  # accept iff u < p(x) / q(x)
    m = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    # the residual norm(max(p - q, 0)) at the first rejection, or p itself
    # where it vanishes numerically (p ~= q)
    mi = torch.clamp(m, max=k - 1)
    rows = torch.arange(n, device=ql.device)
    p_m, q_m = p[rows, mi], q[rows, mi]
    res = torch.clamp(p_m - q_m, min=0.0)
    res = torch.where(res.sum(-1, keepdim=True) > 1e-9, res, p_m)
    r_tok = _categorical(torch.log(res + 1e-30), gumbel)
    cols = torch.arange(k, device=ql.device)[None]
    toks = torch.where(cols == m[:, None], r_tok[:, None], d_toks)
    return toks, m


def speculative_accept(draft_logits: torch.Tensor, target_logits: torch.Tensor,
                       d_toks: torch.Tensor, params: SamplingParams,
                       generator: Optional[torch.Generator] = None):
    """Speculative-sampling acceptance (the Leviathan/Chen rejection rule).

    draft_logits / target_logits: [n, k, vocab] raw logits of the k span
    positions; d_toks: [n, k] tokens the draft sampled from
    softmax(filtered_logits(draft_logits)). Returns (tokens [n, k], m [n]):
    tokens[:, :m] are accepted draft tokens, tokens[:, m] (m < k) the
    residual draw; columns past m are dead.

    Greedy params: exact-match acceptance with the target argmax as the
    residual (no randomness)."""
    d_toks = d_toks.long()
    k = d_toks.shape[-1]
    if params.greedy:
        tgt = torch.argmax(target_logits.float(), dim=-1)  # [n, k]
        ok = d_toks == tgt
        m = torch.cumprod(ok.long(), dim=-1).sum(dim=-1)
        return tgt, m
    ql = filtered_logits(draft_logits, params)
    pl = filtered_logits(target_logits, params)
    n, _, vocab = ql.shape
    u = uniform_noise((n, k), generator, ql.device)
    g = gumbel_from_uniform(uniform_noise((n, vocab), generator, ql.device))
    return _accept(ql, pl, d_toks, u, g)


def token_logprobs(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Log-probability of the chosen ids under the unfiltered distribution.
    logits [..., vocab], ids [...] -> [...] fp32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, ids.long()[..., None])[..., 0]
