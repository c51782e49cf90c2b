"""Beam-search draft-tree generation (the reference's `topK_genrate`).

Port of `flowspec_tpu/draft/beam.py` (`expand_tree` waits for the pipeline
port). A Python loop over levels replaces the `lax.scan`: each level
forwards the K frontier nodes through the draft layer against the draft KV,
scores them with the fused head top-k (`ops/head_topk.py`) and keeps the
global top-K of the K*K candidates. Every order that decides the tree is
(score desc, flat index asc), as `jax.lax.top_k` gives it. The draft KV's
length (`ctx_end`, `pos0`) stays a device scalar, so the writes and biases
of a replayed CUDA graph follow each round; the level is a host int (the
loop is unrolled).
"""

from __future__ import annotations

import dataclasses

import torch

from flowspec_tpu_torch.config import ModelConfig, TreeConfig
from flowspec_tpu_torch.draft.eagle import (
    EagleParams, draft_view, eagle_layer, fuse, project_out,
)
from flowspec_tpu_torch.models.kv_cache import (
    KVCache, device_scalar, write_rows,
)
from flowspec_tpu_torch.ops.head_topk import head_logits, head_topk
from flowspec_tpu_torch.tree.build import build_tree, select_topn
from flowspec_tpu_torch.tree.types import TokenTree, take

__all__ = ["BeamState", "head_logits", "topk_generate"]


@dataclasses.dataclass
class BeamState:
    """Frontier after `level` beam levels; frontier nodes are not yet in the
    draft KV (the next step writes them at beam block `level`)."""
    tokens: torch.Tensor      # (K,) int32
    hidden: torch.Tensor      # (K, H) — draft output hidden of each parent
    scores: torch.Tensor      # (K,) f32 cumulative logp
    flat_ids: torch.Tensor    # (K,) int64 candidate flat ids
    mask: torch.Tensor        # (K, LVLS*K) bool — beam-block ancestors
    level: int                # next beam block index
    ctx_end: torch.Tensor     # () int32 draft KV length before the beam region
    pos0: torch.Tensor        # () int32 rope position of beam level 0
    cand_tokens: torch.Tensor   # (M,) pool, M = K + max_levels*K^2
    cand_scores: torch.Tensor
    cand_parents: torch.Tensor
    cand_valid: torch.Tensor
    selected: torch.Tensor


def _update_slice(buf: torch.Tensor, upd: torch.Tensor, start):
    """`dynamic_update_slice` on a 1-D buffer (start, a host int or a
    device scalar, clamped to fit)."""
    rows = write_rows(start, upd.shape[0], buf.shape[0], buf.device)
    return buf.index_copy(0, rows, upd.to(buf.dtype))


def _topk_stable(x: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest, ties to the lowest index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _beam_step(p: EagleParams, head, cache_k, cache_v, state: BeamState,
               cfg: ModelConfig, top_k: int, max_levels: int,
               inv_tau: float = 1.0) -> BeamState:
    """Forward the frontier at beam block `state.level` (appending to the
    draft KV buffers in place), emit K*K candidates, select the next
    frontier."""
    k_beam = top_k
    s_max = cache_k.shape[2]
    lv = state.level
    dev = cache_k.device

    write_start = state.ctx_end + lv * k_beam
    x = fuse(p, state.tokens[None], state.hidden[None])
    positions = (state.pos0 + lv).expand(k_beam)

    lanes = torch.arange(max_levels * k_beam, device=dev)
    eye_l = lanes[None, :] == (lv * k_beam
                               + torch.arange(k_beam, device=dev))[:, None]
    fwd_mask = state.mask | eye_l                                 # (K, LVLS*K)
    j = torch.arange(s_max, device=dev)
    beam_col = (j - state.ctx_end).clamp(0, max_levels * k_beam - 1)
    beam_part = fwd_mask[:, beam_col]                             # (K, S)
    ok = torch.where(j < state.ctx_end, True, beam_part)
    ok = ok & (j < state.ctx_end + max_levels * k_beam)
    bias = torch.where(ok, 0.0, -1e9).to(torch.float32)

    out = eagle_layer(x, p, cache_k, cache_v, positions, bias, write_start,
                      draft_view(p, cfg))
    out = project_out(p, out, state.hidden[None])[0]              # (K, H)

    # per-row top-k next tokens; score_temperature scales the hidden before
    # the head, i.e. log_softmax(logits / tau)
    row_lp, row_tok = head_topk(out * inv_tau, head, k_beam)      # (K, K)
    cu = row_lp + state.scores[:, None]

    flat_base = k_beam + lv * k_beam * k_beam
    cand_tok = row_tok.reshape(-1).to(torch.int32)
    cand_sc = cu.reshape(-1)
    cand_par = state.flat_ids[:, None].expand(-1, k_beam).reshape(-1)

    m = state.cand_tokens.shape[0]
    am = torch.arange(m, device=dev)
    ct = _update_slice(state.cand_tokens, cand_tok, flat_base)
    cs = _update_slice(state.cand_scores, cand_sc, flat_base)
    cp = _update_slice(state.cand_parents, cand_par, flat_base)
    cv = state.cand_valid | ((am >= flat_base)
                             & (am < flat_base + k_beam ** 2))

    top_sc, sel = _topk_stable(cand_sc, k_beam)
    b = sel // k_beam
    return BeamState(
        tokens=cand_tok[sel], hidden=out[b], scores=top_sc,
        flat_ids=flat_base + sel, mask=fwd_mask[b], level=lv + 1,
        ctx_end=state.ctx_end, pos0=state.pos0, cand_tokens=ct,
        cand_scores=cs, cand_parents=cp, cand_valid=cv,
        selected=state.selected)


def _init_beam(p: EagleParams, head, root_hidden: torch.Tensor, ctx_end,
               pos0, tree_cfg: TreeConfig,
               max_levels: int) -> BeamState:
    """Root expansion: top-k children of the root from its draft hidden."""
    k_beam = tree_cfg.top_k
    m = k_beam + max_levels * k_beam * k_beam
    dev = root_hidden.device
    sc, tok = head_topk(root_hidden / tree_cfg.score_temperature, head,
                        k_beam)
    tok = tok.to(torch.int32)
    cand_tokens = torch.full((m,), -1, dtype=torch.int32, device=dev)
    cand_tokens[:k_beam] = tok
    cand_scores = torch.full((m,), -torch.inf, dtype=torch.float32,
                             device=dev)
    cand_scores[:k_beam] = sc
    h = root_hidden.shape[-1]
    return BeamState(
        tokens=tok, hidden=root_hidden.expand(k_beam, h),
        scores=sc, flat_ids=torch.arange(k_beam, device=dev),
        mask=torch.zeros((k_beam, max_levels * k_beam), dtype=torch.bool,
                         device=dev),
        level=0, ctx_end=device_scalar(ctx_end, dev),
        pos0=device_scalar(pos0, dev),
        cand_tokens=cand_tokens, cand_scores=cand_scores,
        cand_parents=torch.full((m,), -1, dtype=torch.int64, device=dev),
        cand_valid=torch.arange(m, device=dev) < k_beam,
        selected=torch.zeros((m,), dtype=torch.bool, device=dev))


def topk_generate(p: EagleParams, head, cache: KVCache,
                  root_token: torch.Tensor, root_hidden: torch.Tensor,
                  tree_cfg: TreeConfig, cfg: ModelConfig,
                  num_select: int | None = None, depth: int | None = None,
                  max_levels: int | None = None,
                  force_deep_path: bool = False):
    """Generate a fresh draft tree hanging off `root_token`.

    `root_hidden` (H,) is the draft output for the context pair whose token
    input was the root. Returns (tree, beam_state, cache): the cache has the
    beam region written but `length` still at ctx_end (stable_kv).
    `force_deep_path` (the `force_accept` bench mode) puts the best final
    frontier node's whole chain into the tree, as
    `flowspec_tpu/draft/beam.py:205-229` does.
    """
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
                           inv_tau=1.0 / tree_cfg.score_temperature)

    sel_force = None
    if force_deep_path and num_select > 0:
        # random-weight beam scores decay ~uniformly per level, so plain
        # top-N keeps shallow nodes: walk the best final node's parents
        # (depth steps) and force that chain in, within num_select
        m = state.cand_tokens.shape[0]
        i_m = torch.arange(m, device=root_token.device)
        sel_force = torch.zeros((m,), dtype=torch.bool, device=i_m.device)
        node = state.flat_ids[0]
        for _ in range(depth):
            sel_force = sel_force | (i_m == node)
            parent = take(state.cand_parents, node.clamp(0, m - 1))
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
