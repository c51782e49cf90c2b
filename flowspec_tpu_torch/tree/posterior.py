"""Acceptance: greedy longest-prefix match and stochastic rejection sampling.

Port of `flowspec_tpu/tree/posterior.py`. Works on per-node logits
(N_cap, V): `logits[n]` is the base model's next-token distribution at tree
node n. `accept_len` counts accepted tree tokens beyond the root;
`sample_p` is the (V,) distribution the next root token is drawn from.

The stochastic path draws from per-lane streams (`tree/sampling.py
Draws`); its bits cannot match `jax.random`'s, its sampling law does.

Both walks run over a leading lane axis: (B, N_cap, V) logits and a tree of
B lanes give (B,) results, each lane on its own tree. A one-request call
(no lane axis) is the B = 1 case.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flowspec_tpu_torch.config import SamplingConfig
from flowspec_tpu_torch.tree.sampling import as_draws, warp_logits
from flowspec_tpu_torch.tree.types import TokenTree, lane_take


class PosteriorResult(NamedTuple):
    best_leaf: torch.Tensor     # ([B]) int32 — row into retrieve
    accept_len: torch.Tensor    # ([B]) int32 — accepted tokens beyond root
    sample_p: torch.Tensor      # ([B,] V) float32 — next-token distribution


def _lane0(res: PosteriorResult) -> PosteriorResult:
    return PosteriorResult(*(x[0] for x in res))


def evaluate_posterior_greedy(node_logits: torch.Tensor,
                              tree: TokenTree) -> PosteriorResult:
    """A path entry at depth d is accepted iff its token equals the argmax
    of the logits at its parent on the same path (first max on ties)."""
    if node_logits.dim() == 2:
        return _lane0(evaluate_posterior_greedy(node_logits[None],
                                                tree.lanes()))
    node_cap = tree.node_cap
    n_l = tree.retrieve.shape[1]
    node_argmax = torch.argmax(node_logits, dim=-1).to(torch.int32)  # (B, N)

    cand = tree.candidates()                                      # (B, L, D)
    safe_ri = tree.retrieve.clamp(0, node_cap - 1).long()
    parent_pred = torch.gather(
        node_argmax[:, None, :].expand(-1, n_l, node_cap), 2, safe_ri)
    match = (cand[..., 1:] == parent_pred[..., :-1]) \
        & (tree.retrieve[..., 1:] >= 0)
    accept_lens = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
    accept_lens = torch.where(tree.leaf_valid(), accept_lens, -1)  # (B, L)

    accept_len = accept_lens.amax(dim=-1).clamp_min(0).to(torch.int32)
    best = torch.where(accept_len == 0, 0,
                       torch.argmax(accept_lens, dim=-1)).to(torch.int32)
    last_node = lane_take(tree.retrieve, best, accept_len).clamp(
        0, node_cap - 1)
    sample_p = torch.softmax(lane_take(node_logits, last_node).float(),
                             dim=-1)
    return PosteriorResult(best, accept_len, sample_p)


def evaluate_posterior_stochastic(
        node_logits: torch.Tensor, tree: TokenTree, cfg: SamplingConfig,
        draws, max_trials: int | None = None) -> PosteriorResult:
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
    CUDA graph; the CPU runs the same body. `draws` is a
    `tree/sampling.py Draws` or a `lane_rng` state (one stream a lane)."""
    draws = as_draws(draws)
    if node_logits.dim() == 2:
        return _lane0(evaluate_posterior_stochastic(
            node_logits[None], tree.lanes(), cfg, draws, max_trials))
    b_lanes, node_cap, vocab = node_logits.shape
    leaf_cap, depth_cap = tree.retrieve.shape[1:]
    m_trials = leaf_cap if max_trials is None else min(max_trials, leaf_cap)
    dev = node_logits.device
    cand = tree.candidates()                                      # (B, L, D)
    leaf_valid = tree.leaf_valid()
    warped = warp_logits(node_logits.float(), cfg)
    rows = torch.arange(leaf_cap, device=dev)
    earlier = rows[None, :] < rows[:, None]
    slots = torch.arange(m_trials, device=dev)
    uniforms = draws.uniform((b_lanes, max(depth_cap - 1, 1), m_trials),
                             dev)
    no_mass = torch.zeros((b_lanes, 1), device=dev)

    is_eq = leaf_valid.clone()      # rows matching the accepted prefix
    active = torch.ones((b_lanes,), dtype=torch.bool, device=dev)
    accept_len = torch.zeros((b_lanes,), dtype=torch.int32, device=dev)
    best = torch.zeros((b_lanes,), dtype=torch.int64, device=dev)
    residual = torch.zeros((b_lanes, vocab), device=dev)
    ended_rejected = torch.zeros((b_lanes,), dtype=torch.bool, device=dev)
    for i in range(1, depth_cap):
        fi = torch.argmax(is_eq.to(torch.int8), dim=-1)
        path_node = lane_take(tree.retrieve[:, :, i - 1], fi).clamp(
            0, node_cap - 1)
        gtp0 = torch.softmax(lane_take(warped, path_node), dim=-1)  # (B, V)

        # first-occurrence dedup of sibling tokens among matching rows
        x = cand[:, :, i]                                          # (B, L)
        eligible = is_eq & (x >= 0) & leaf_valid \
            & (tree.retrieve[:, :, i] >= 0)
        dup = ((x[:, None, :] == x[:, :, None]) & earlier
               & eligible[:, None, :]).any(dim=-1)
        trial = eligible & ~dup
        t_rows = torch.argsort((~trial).to(torch.int8), dim=-1,
                               stable=True)[:, :m_trials]
        t_valid = torch.gather(trial, 1, t_rows)
        t_tok = torch.where(t_valid, torch.gather(x, 1, t_rows),
                            0).clamp(0, vocab - 1).long()
        p_t = torch.where(t_valid, torch.gather(gtp0, 1, t_tok), 0.0)

        denom = (1.0 - (torch.cumsum(p_t, -1) - p_t)).clamp_min(1e-30)
        acc = t_valid & (uniforms[:, i - 1] * denom <= p_t)
        first = torch.argmax(acc.to(torch.int8), dim=-1)
        any_acc = acc.any(dim=-1)
        rej = t_valid & (~any_acc[:, None] | (slots < first[:, None]))
        # the residual: rejected tokens zeroed (index vocab: a spare slot)
        gtp_res = torch.cat([gtp0, no_mass], dim=1).scatter(
            1, torch.where(rej, t_tok, vocab), 0.0)[:, :vocab]
        gtp_res = gtp_res / gtp_res.sum(dim=-1,
                                        keepdim=True).clamp_min(1e-30)

        step = active & eligible.any(dim=-1)
        accepted = step & any_acc
        stopped_rejected = step & ~any_acc & rej.any(dim=-1)
        residual = torch.where(stopped_rejected[:, None], gtp_res, residual)
        ended_rejected = torch.where(step, stopped_rejected, ended_rejected)
        pick = torch.gather(t_rows, 1, first[:, None])[:, 0]
        best = torch.where(accepted, pick, best)
        is_eq = torch.where(accepted[:, None],
                            is_eq & (x == torch.gather(x, 1, pick[:, None])),
                            is_eq)
        accept_len = accept_len + accepted.to(torch.int32)
        active = accepted

    last_node = lane_take(tree.retrieve, best, accept_len).clamp(
        0, node_cap - 1)
    p_node = torch.softmax(lane_take(warped, last_node), dim=-1)
    sample_p = torch.where(
        (ended_rejected & (accept_len < depth_cap - 1))[:, None], residual,
        p_node)
    return PosteriorResult(best.to(torch.int32), accept_len, sample_p)
