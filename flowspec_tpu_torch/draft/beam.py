"""Beam-search draft-tree generation (the reference's `topK_genrate`).

Port of `flowspec_tpu/draft/beam.py`, `expand_tree` (`:239-273`, the
pipeline's continuous expansion) included. A Python loop over levels
replaces the `lax.scan`: each level forwards the K frontier nodes through
the draft layer against the draft KV, scores them with the fused head
top-k (`ops/head_topk.py`) and keeps the global top-K of the K*K
candidates. Every order that decides the tree is
(score desc, flat index asc), as `jax.lax.top_k` gives it. The draft KV's
length (`ctx_end`, `pos0`) stays a device scalar, so the writes and biases
of a replayed CUDA graph follow each round; the level is a host int (the
loop is unrolled).

The beam runs over a leading lane axis B (requests served together, each
with its own draft KV and root): one draft-layer forward and one head top-k
call a level serve all lanes (B*K rows). A one-request call is the B = 1
case (`topk_generate` lifts it and takes the lane axis off the result).
"""

from __future__ import annotations

import dataclasses

import torch

from flowspec_tpu_torch.config import ModelConfig, TreeConfig
from flowspec_tpu_torch.draft.eagle import (
    EagleParams, draft_view, eagle_layer, fuse, project_out,
)
from flowspec_tpu_torch.models.kv_cache import KVCache, lane_tensor
from flowspec_tpu_torch.ops.head_topk import head_logits, head_topk
from flowspec_tpu_torch.tree.build import build_tree, select_topn
from flowspec_tpu_torch.tree.types import lane_gather

__all__ = ["BeamState", "expand_tree", "head_logits", "topk_generate"]


@dataclasses.dataclass
class BeamState:
    """Frontier of every lane after `level` beam levels; frontier nodes are
    not yet in the draft KV (the next step writes them at beam block
    `level`)."""
    tokens: torch.Tensor      # (B, K) int32
    hidden: torch.Tensor      # (B, K, H) — draft output hidden of a parent
    scores: torch.Tensor      # (B, K) f32 cumulative logp
    flat_ids: torch.Tensor    # (B, K) int64 candidate flat ids
    mask: torch.Tensor        # (B, K, LVLS*K) bool — beam-block ancestors
    level: int                # next beam block index
    ctx_end: torch.Tensor     # (B,) int32 draft KV length before the beam
    pos0: torch.Tensor        # (B,) int32 rope position of beam level 0
    cand_tokens: torch.Tensor   # (B, M) pool, M = K + max_levels*K^2
    cand_scores: torch.Tensor
    cand_parents: torch.Tensor
    cand_valid: torch.Tensor
    selected: torch.Tensor


def _topk_stable(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: the k largest, ties to the
    lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_step(p: EagleParams, head, cache_k, cache_v, state: BeamState,
               cfg: ModelConfig, top_k: int, max_levels: int,
               inv_tau: float = 1.0,
               live: torch.Tensor | None = None) -> BeamState:
    """Forward every lane's frontier at beam block `state.level`
    (appending to the draft KV buffers in place), emit K*K candidates a
    lane, select the next frontiers."""
    k_beam = top_k
    b_lanes, _, s_max, _ = cache_k.shape
    lv = state.level
    dev = cache_k.device
    lk = max_levels * k_beam

    write_start = state.ctx_end + lv * k_beam                     # (B,)
    x = fuse(p, state.tokens, state.hidden)                       # (B, K, W)
    positions = (state.pos0 + lv)[:, None].expand(b_lanes, k_beam)

    lanes = torch.arange(lk, device=dev)
    eye_l = lanes[None, :] == (lv * k_beam
                               + torch.arange(k_beam, device=dev))[:, None]
    fwd_mask = state.mask | eye_l                                 # (B, K, LK)
    j = torch.arange(s_max, device=dev)
    ctx_end = state.ctx_end[:, None]                              # (B, 1)
    beam_col = (j - ctx_end).clamp(0, lk - 1)                     # (B, S)
    beam_part = torch.gather(
        fwd_mask, 2, beam_col[:, None, :].expand(b_lanes, k_beam, s_max))
    ok = torch.where((j < ctx_end)[:, None, :], True, beam_part)
    ok = ok & (j < ctx_end + lk)[:, None, :]
    bias = torch.where(ok, 0.0, -1e9).to(torch.float32)           # (B, K, S)

    out = eagle_layer(x, p, cache_k, cache_v, positions, bias, write_start,
                      draft_view(p, cfg), live)
    out = project_out(p, out, state.hidden)                       # (B, K, H)

    # per-row top-k next tokens; score_temperature scales the hidden before
    # the head, i.e. log_softmax(logits / tau); one call for all B*K rows
    row_lp, row_tok = head_topk(out * inv_tau, head, k_beam)      # (B, K, K)
    cu = row_lp + state.scores[:, :, None]

    flat_base = k_beam + lv * k_beam * k_beam
    cand_tok = row_tok.reshape(b_lanes, -1).to(torch.int32)
    cand_sc = cu.reshape(b_lanes, -1)
    cand_par = state.flat_ids[:, :, None].expand(
        -1, -1, k_beam).reshape(b_lanes, -1)

    m = state.cand_tokens.shape[1]
    am = torch.arange(m, device=dev)
    span = torch.arange(flat_base, flat_base + k_beam ** 2, device=dev)
    ct = state.cand_tokens.index_copy(1, span, cand_tok)
    cs = state.cand_scores.index_copy(1, span, cand_sc)
    cp = state.cand_parents.index_copy(1, span, cand_par)
    cv = state.cand_valid | ((am >= flat_base)
                             & (am < flat_base + k_beam ** 2))

    top_sc, sel = _topk_stable(cand_sc, k_beam)                   # (B, K)
    b = sel // k_beam
    return BeamState(
        tokens=torch.gather(cand_tok, 1, sel),
        hidden=lane_gather(out, b), scores=top_sc,
        flat_ids=flat_base + sel, mask=lane_gather(fwd_mask, b),
        level=lv + 1, ctx_end=state.ctx_end, pos0=state.pos0,
        cand_tokens=ct, cand_scores=cs, cand_parents=cp, cand_valid=cv,
        selected=state.selected)


def _init_beam(p: EagleParams, head, root_hidden: torch.Tensor, ctx_end,
               pos0, tree_cfg: TreeConfig,
               max_levels: int) -> BeamState:
    """Root expansion: top-k children of every lane's root from its draft
    hidden (B, H)."""
    k_beam = tree_cfg.top_k
    m = k_beam + max_levels * k_beam * k_beam
    b_lanes, h = root_hidden.shape
    dev = root_hidden.device
    sc, tok = head_topk(root_hidden / tree_cfg.score_temperature, head,
                        k_beam)                                   # (B, K)
    tok = tok.to(torch.int32)
    cand_tokens = torch.full((b_lanes, m), -1, dtype=torch.int32, device=dev)
    cand_tokens[:, :k_beam] = tok
    cand_scores = torch.full((b_lanes, m), -torch.inf, dtype=torch.float32,
                             device=dev)
    cand_scores[:, :k_beam] = sc
    return BeamState(
        tokens=tok, hidden=root_hidden[:, None].expand(b_lanes, k_beam, h),
        scores=sc,
        flat_ids=torch.arange(k_beam, device=dev).expand(b_lanes, k_beam),
        mask=torch.zeros((b_lanes, k_beam, max_levels * k_beam),
                         dtype=torch.bool, device=dev),
        level=0, ctx_end=lane_tensor(ctx_end, b_lanes, dev),
        pos0=lane_tensor(pos0, b_lanes, dev),
        cand_tokens=cand_tokens, cand_scores=cand_scores,
        cand_parents=torch.full((b_lanes, m), -1, dtype=torch.int64,
                                device=dev),
        cand_valid=(torch.arange(m, device=dev) < k_beam).expand(b_lanes, m),
        selected=torch.zeros((b_lanes, m), dtype=torch.bool, device=dev))


def topk_generate(p: EagleParams, head, cache: KVCache,
                  root_token: torch.Tensor, root_hidden: torch.Tensor,
                  tree_cfg: TreeConfig, cfg: ModelConfig,
                  num_select: int | None = None, depth: int | None = None,
                  max_levels: int | None = None,
                  force_deep_path: bool = False,
                  live: torch.Tensor | None = None):
    """Generate a fresh draft tree hanging off `root_token`.

    `root_hidden` (H,) is the draft output for the context pair whose token
    input was the root. Returns (tree, beam_state, cache): the cache has the
    beam region written but `length` still at ctx_end (stable_kv).
    Per lane: root_token (B,), root_hidden (B, H) and a (B,)-length draft
    cache give a tree of (B, ...) fields (`live` as in
    `models/kv_cache.py`). `force_deep_path` (the `force_accept` bench
    mode) puts the best final frontier node's whole chain into the tree, as
    `flowspec_tpu/draft/beam.py:205-229` does.
    """
    if root_token.dim() == 0:
        tree, state, cache = topk_generate(
            p, head, cache, root_token.reshape(1), root_hidden[None],
            tree_cfg, cfg, num_select, depth, max_levels, force_deep_path)
        return tree.lane(0), state, cache
    depth = depth if depth is not None else tree_cfg.depth
    num_select = (num_select if num_select is not None
                  else tree_cfg.total_tokens)
    max_levels = max_levels or (tree_cfg.depth + tree_cfg.expand_depth)
    assert depth <= max_levels

    state = _init_beam(p, head, root_hidden, cache.length, cache.length,
                       tree_cfg, max_levels)
    for _ in range(depth):
        state = _beam_step(p, head, cache.k[0], cache.v[0], state, cfg,
                           tree_cfg.top_k, max_levels,
                           inv_tau=1.0 / tree_cfg.score_temperature,
                           live=live)

    sel_force = None
    if force_deep_path and num_select > 0:
        # random-weight beam scores decay ~uniformly per level, so plain
        # top-N keeps shallow nodes: walk the best final node's parents
        # (depth steps) and force that chain in, within num_select
        m = state.cand_tokens.shape[1]
        i_m = torch.arange(m, device=root_token.device)
        sel_force = torch.zeros(state.cand_tokens.shape, dtype=torch.bool,
                                device=i_m.device)
        node = state.flat_ids[:, 0]                               # (B,)
        for _ in range(depth):
            sel_force = sel_force | (i_m == node[:, None])
            parent = torch.gather(state.cand_parents, 1,
                                  node.clamp(0, m - 1)[:, None])[:, 0]
            node = torch.where(node >= 0, parent, -1)
        num_select = max(num_select - depth, 1)
    sel = select_topn(state.cand_scores, state.cand_valid, num_select,
                      force_include=sel_force)
    tree = build_tree(state.cand_tokens, state.cand_scores,
                      state.cand_parents, sel, root_token,
                      tree_cfg.node_cap, tree_cfg.leaf_cap,
                      tree_cfg.depth_cap, sort_score=tree_cfg.sort_score)
    state = dataclasses.replace(state, selected=sel)
    return tree, state, cache


def expand_tree(p: EagleParams, head, cache: KVCache, state: BeamState,
                root_token: torch.Tensor, tree_cfg: TreeConfig,
                cfg: ModelConfig, extra_depth: int, expand_size: int,
                max_levels: int | None = None):
    """Continue the saved beam `state` `extra_depth` more levels and build
    the superset tree: the previously selected nodes force-included plus
    the top `expand_size` new candidates (ref `expand_last`,
    eagle/cnets.py:1439-1708; `flowspec_tpu/draft/beam.py:239-273`).
    Merged onto the tree `state` was selected for, it appends exactly the
    new nodes. Returns (tree, state', cache): the beam rows are written in
    place, the length stays at the beam's ctx_end. Lanes as in
    `topk_generate` (a 0-d root_token gives a one-request tree)."""
    if root_token.dim() == 0:
        tree, state, cache = expand_tree(
            p, head, cache, state, root_token.reshape(1), tree_cfg, cfg,
            extra_depth, expand_size, max_levels)
        return tree.lane(0), state, cache
    max_levels = max_levels or (tree_cfg.depth + tree_cfg.expand_depth)
    state2 = state
    for _ in range(extra_depth):
        state2 = _beam_step(p, head, cache.k[0], cache.v[0], state2, cfg,
                            tree_cfg.top_k, max_levels,
                            inv_tau=1.0 / tree_cfg.score_temperature)
    sel = select_topn(state2.cand_scores, state2.cand_valid, expand_size,
                      force_include=state.selected)
    tree = build_tree(state2.cand_tokens, state2.cand_scores,
                      state2.cand_parents, sel, root_token,
                      tree_cfg.node_cap, tree_cfg.leaf_cap,
                      tree_cfg.depth_cap, sort_score=tree_cfg.sort_score)
    return tree, dataclasses.replace(state2, selected=sel), cache
