"""Logits warping + token sampling.

Port of `flowspec_tpu/tree/sampling.py`: temperature -> top-p -> top-k (the
HF warper order), then argmax (greedy) or a categorical draw. `jax.random`
keys become `Draws`: one counter-based stream a lane (`lane_rng`), on the
device, for one request (one lane) as for requests served together; the
two packages give different draws from one seed, so only the sampling law
is comparable across them.
"""

from __future__ import annotations

import torch

from flowspec_tpu_torch.config import SamplingConfig

_FILTER = -float("inf")
_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply rounds) of int64 values in
    [0, 2^32); multipliers below 2^31 keep every product inside int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def lane_rng(seeds: torch.Tensor) -> torch.Tensor:
    """(B, 2) int64 per-lane stream state (seed, draw counter) for (B,)
    `seeds`, counters at 0."""
    seeds = seeds.to(torch.int64).reshape(-1, 1)
    return torch.cat([seeds, torch.zeros_like(seeds)], dim=1)


class Draws:
    """The random draws of one round from a (B, 2) `lane_rng` state: each
    lane's draws are a hash of its (seed, counter, index), so a lane's
    stream is its own whatever its neighbours do, and the state lives on
    the device: a captured CUDA graph replays it, and a lane is reseeded by
    a plain tensor write. Each draw advances every lane's counter by one;
    `rng` is the state after the draws made so far."""

    def __init__(self, rng: torch.Tensor):
        self.rng = rng

    def uniform(self, shape, device) -> torch.Tensor:
        """`shape` (lane axis first) f32 uniforms strictly inside (0, 1):
        23 bits of the hash and a half step, so the largest, 1 - 2^-24, is
        a float32 (24 bits and a half step round the top value to 1.0)."""
        n = 1
        for d in shape[1:]:
            n *= d
        seed, count = self.rng[:, :1], self.rng[:, 1:]
        k1 = _mix32(seed & _M32)
        k2 = _mix32(k1 ^ (count & _M32))
        idx = torch.arange(n, device=device, dtype=torch.int64)
        h = _mix32(_mix32((k2 + idx * 0x9E3779B9) & _M32) ^ k1)
        self.rng = torch.cat([seed, count + 1], dim=1)
        u = ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
        return u.reshape(shape)

    def exponential(self, shape, device) -> torch.Tensor:
        """`shape` (lane axis first) Exp(1) draws, all > 0."""
        return -torch.log(self.uniform(shape, device))


def as_draws(source) -> Draws:
    """`source` (a Draws or a lane_rng state) as Draws."""
    return source if isinstance(source, Draws) else Draws(source)


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


def sample_token(draws, probs_or_logits: torch.Tensor, cfg: SamplingConfig,
                 is_probs: bool) -> torch.Tensor:
    """() int32 token from (V,), or (B,) from (B, V), one a lane (first
    index of the max when greedy); `draws` a `Draws` or a `lane_rng` state
    of one lane (for (V,)) or of B."""
    if cfg.is_greedy:
        return torch.argmax(probs_or_logits, dim=-1).to(torch.int32)
    if is_probs:
        logp = torch.log(probs_or_logits.clamp_min(1e-30))
    else:
        logp = warp_logits(probs_or_logits, cfg)
    p = torch.softmax(logp.float(), dim=-1)
    # a categorical draw as an exponential race, argmax p_i / E_i with
    # E_i ~ Exp(1) (P(i) = p_i): unlike torch.multinomial it checks nothing
    # on the host, so it can run inside a captured CUDA graph. A token of p
    # 0 (filtered out, or underflowed) never wins, whatever its draw.
    race = as_draws(draws).exponential(p.reshape(-1, p.shape[-1]).shape,
                                       p.device).reshape(p.shape)
    return torch.argmax(torch.where(p > 0, p / race, _FILTER),
                        dim=-1).to(torch.int32)
