"""Acceptance: greedy longest-prefix match and stochastic rejection sampling.

Port of `flowspec_tpu/tree/posterior.py`. Works on per-node logits
(N_cap, V): `logits[n]` is the base model's next-token distribution at tree
node n. `accept_len` counts accepted tree tokens beyond the root;
`sample_p` is the (V,) distribution the next root token is drawn from.

The stochastic path draws from an explicit `torch.Generator`; its bits
cannot match `jax.random`'s, its sampling law does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flowspec_tpu_torch.config import SamplingConfig
from flowspec_tpu_torch.tree.sampling import warp_logits
from flowspec_tpu_torch.tree.types import TokenTree, take


class PosteriorResult(NamedTuple):
    best_leaf: torch.Tensor     # () int32 — row into retrieve
    accept_len: torch.Tensor    # () int32 — accepted tokens beyond root
    sample_p: torch.Tensor      # (V,) float32 — next-token distribution


def evaluate_posterior_greedy(node_logits: torch.Tensor,
                              tree: TokenTree) -> PosteriorResult:
    """A path entry at depth d is accepted iff its token equals the argmax
    of the logits at its parent on the same path (first max on ties)."""
    node_cap = tree.node_cap
    node_argmax = torch.argmax(node_logits, dim=-1).to(torch.int32)   # (N,)

    cand = tree.candidates()                                          # (L, D)
    safe_ri = tree.retrieve.clamp(0, node_cap - 1).long()
    parent_pred = node_argmax[safe_ri]
    match = (cand[:, 1:] == parent_pred[:, :-1]) & (tree.retrieve[:, 1:] >= 0)
    accept_lens = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    accept_lens = torch.where(tree.leaf_valid(), accept_lens, -1)

    accept_len = accept_lens.max().clamp_min(0).to(torch.int32)
    best = torch.where(accept_len == 0, 0,
                       torch.argmax(accept_lens)).to(torch.int32)
    last_node = take(tree.retrieve, best, accept_len).clamp(0, node_cap - 1)
    sample_p = torch.softmax(take(node_logits, last_node).float(), dim=-1)
    return PosteriorResult(best, accept_len, sample_p)


def evaluate_posterior_stochastic(
        node_logits: torch.Tensor, tree: TokenTree, cfg: SamplingConfig,
        generator: torch.Generator | None,
        max_trials: int | None = None) -> PosteriorResult:
    """EAGLE/SpecInfer-style sequential rejection sampling.

    At each depth along the accepted path: try the distinct sibling tokens in
    leaf-row order; accept token x with probability p(x) (draft q == 1); on
    rejection zero p(x) and renormalize. Trial tokens are distinct, so that
    is p(x_m) / (1 - sum_{j<m} p(x_j)) and one vector of uniforms decides a
    whole depth. If the walk ends on rejections, the residual distribution
    is returned for sampling. Like the JAX scan (`flowspec_tpu/tree/
    posterior.py:182`) the walk runs every depth with masks instead of
    stopping, drawing all its uniforms at once: on the card it reads
    nothing back to the host, so a round that samples can be captured as a
    CUDA graph; the CPU runs the same body."""
    node_cap, vocab = node_logits.shape
    leaf_cap, depth_cap = tree.retrieve.shape
    m_trials = leaf_cap if max_trials is None else min(max_trials, leaf_cap)
    dev = node_logits.device
    cand = tree.candidates()
    leaf_valid = tree.leaf_valid()
    warped = warp_logits(node_logits.float(), cfg)
    rows = torch.arange(leaf_cap, device=dev)
    earlier = rows[None, :] < rows[:, None]
    slots = torch.arange(m_trials, device=dev)
    uniforms = torch.rand((max(depth_cap - 1, 1), m_trials),
                          generator=generator, device=dev)
    no_mass = torch.zeros((1,), device=dev)

    is_eq = leaf_valid.clone()      # rows matching the accepted prefix
    active = torch.ones((), dtype=torch.bool, device=dev)
    accept_len = torch.zeros((), dtype=torch.int32, device=dev)
    best = torch.zeros((), dtype=torch.int64, device=dev)
    residual = torch.zeros((vocab,), device=dev)
    ended_rejected = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(1, depth_cap):
        fi = torch.argmax(is_eq.to(torch.int8))
        path_node = take(tree.retrieve[:, i - 1], fi).clamp(0, node_cap - 1)
        gtp0 = torch.softmax(take(warped, path_node), dim=-1)

        # first-occurrence dedup of sibling tokens among matching rows
        x = cand[:, i]
        eligible = is_eq & (x >= 0) & leaf_valid & (tree.retrieve[:, i] >= 0)
        dup = ((x[None, :] == x[:, None]) & earlier
               & eligible[None, :]).any(dim=1)
        trial = eligible & ~dup
        t_rows = torch.argsort((~trial).to(torch.int8),
                               stable=True)[:m_trials]
        t_valid = trial[t_rows]
        t_tok = torch.where(t_valid, x[t_rows], 0).clamp(0, vocab - 1).long()
        p_t = torch.where(t_valid, gtp0[t_tok], 0.0)

        denom = (1.0 - (torch.cumsum(p_t, 0) - p_t)).clamp_min(1e-30)
        acc = t_valid & (uniforms[i - 1] * denom <= p_t)
        first = torch.argmax(acc.to(torch.int8))
        any_acc = acc.any()
        rej = t_valid & (~any_acc | (slots < first))
        # the residual: rejected tokens zeroed (index vocab: a spare slot)
        gtp_res = torch.cat([gtp0, no_mass]).index_fill(
            0, torch.where(rej, t_tok, vocab), 0.0)[:vocab]
        gtp_res = gtp_res / gtp_res.sum().clamp_min(1e-30)

        step = active & eligible.any()
        accepted = step & any_acc
        stopped_rejected = step & ~any_acc & rej.any()
        residual = torch.where(stopped_rejected, gtp_res, residual)
        ended_rejected = torch.where(step, stopped_rejected, ended_rejected)
        pick = take(t_rows, first)
        best = torch.where(accepted, pick, best)
        is_eq = torch.where(accepted, is_eq & (x == take(x, pick)), is_eq)
        accept_len = accept_len + accepted.to(torch.int32)
        active = accepted

    last_node = take(tree.retrieve, best, accept_len).clamp(0, node_cap - 1)
    p_node = torch.softmax(take(warped, last_node), dim=-1)
    sample_p = torch.where(ended_rejected & (accept_len < depth_cap - 1),
                           residual, p_node)
    return PosteriorResult(best.to(torch.int32), accept_len, sample_p)
