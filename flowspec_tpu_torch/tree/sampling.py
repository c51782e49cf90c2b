"""Logits warping + token sampling.

Port of `flowspec_tpu/tree/sampling.py`: temperature -> top-p -> top-k (the
HF warper order), then argmax (greedy) or a categorical draw. `jax.random`
keys become an explicit `torch.Generator`; the two give different draws
from one seed, so only the sampling law is comparable across packages.
"""

from __future__ import annotations

import torch

from flowspec_tpu_torch.config import SamplingConfig

_FILTER = -float("inf")


def warp_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Apply temperature / top-p / top-k filters to a (..., V) logits array."""
    if cfg.is_greedy:
        return logits
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    if 1e-8 <= cfg.top_p < 1.0:
        logits = _top_p_filter(logits, cfg.top_p)
    if cfg.top_k > 0:
        logits = _top_k_filter(logits, cfg.top_k)
    return logits


def _top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, _FILTER, logits)


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens until the cumulative prob exceeds top_p, at least one
    cutoff_mask = cum - probs > top_p
    threshold = torch.where(cutoff_mask, torch.inf, sorted_logits).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < threshold, _FILTER, logits)


def sample_token(generator: torch.Generator | None,
                 probs_or_logits: torch.Tensor, cfg: SamplingConfig,
                 is_probs: bool) -> torch.Tensor:
    """() int32 token (first index of the max when greedy)."""
    if cfg.is_greedy:
        return torch.argmax(probs_or_logits, dim=-1).to(torch.int32)
    if is_probs:
        logp = torch.log(probs_or_logits.clamp_min(1e-30))
    else:
        logp = warp_logits(probs_or_logits, cfg)
    p = torch.softmax(logp.float(), dim=-1)
    # a categorical draw as an exponential race, argmax p_i / E_i with
    # E_i ~ Exp(1) (P(i) = p_i): unlike torch.multinomial it checks nothing
    # on the host, so it can run inside a captured CUDA graph
    race = torch.empty_like(p).exponential_(generator=generator)
    return torch.argmax(p / race, dim=-1).to(torch.int32)
