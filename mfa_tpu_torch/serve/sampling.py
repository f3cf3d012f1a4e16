"""Token sampling (counterpart of mfa_tpu/serve/sampling.py), greedy only.

Temperature, top-k, top-p, min-p and the repetition penalty come in a
later slice; SamplingParams accepts only their neutral values for now.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy argmax (the only mode ported)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0

    def __post_init__(self):
        if (self.temperature != 0.0 or self.top_k or self.top_p < 1.0
                or self.min_p > 0.0 or self.repetition_penalty != 1.0):
            raise NotImplementedError(
                "only greedy sampling is ported (temperature, top-k, top-p, "
                "min-p and repetition penalty come later)")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def sample(logits: torch.Tensor) -> torch.Tensor:
    """logits [n, vocab] -> greedy token ids [n] (first maximum on ties,
    as jnp.argmax)."""
    return torch.argmax(logits.float(), dim=-1)


def token_logprobs(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Log-probability of the chosen ids under the unfiltered distribution.
    logits [n, vocab], ids [n] -> [n] fp32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, ids.long()[..., None])[..., 0]
