"""In-flight tree pruning after a chunk verdict.

Port of `flowspec_tpu/tree/prune.py:25-140` (ref `cal_pruning_info`,
pipeline_utils.py:944-991, `draft_stage_pruning`, :995-1056,
`token_pruning`, :1076-1151). The surviving subtree is the
descendants-or-self of the child of the last accepted node whose token
equals the newly sampled one (the new root), as a fixed-shape keep-mask
plus 0-d scalars on the tree's device. One tree, no lane axis; every order
that decides the result is JAX's: the first match wins (`argmax` of a
bool), kept ids ascend (a stable sort of an integer copy of the mask).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flowspec_tpu_torch.tree.build import finalize_tree
from flowspec_tpu_torch.tree.types import TokenTree, ancestor_matrix, take


class PruneInfo(NamedTuple):
    truncate: torch.Tensor       # () bool — round ends, no surviving tree
    new_root: torch.Tensor       # () int32 — old id of the new root, -1
    accept_len: torch.Tensor     # () int32 — accepted nodes incl. old root
    accepted_path: torch.Tensor  # (D,) int32 — old node ids, -1 padded
    keep: torch.Tensor           # (N,) bool — new_root's subtree
    kept_old_ids: torch.Tensor   # (N,) int32 — kept ids ascending, -1 pad
    n_kept: torch.Tensor         # () int32


def kept_order(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the True entries ascending, then the rest (JAX's stable
    `argsort(~mask)`)."""
    return torch.argsort((~mask).to(torch.int8), stable=True)


def compute_pruning_info(tree: TokenTree, best_leaf, accept_len,
                         sampled_token) -> PruneInfo:
    """`accept_len` counts accepted nodes including the root. Truncate when
    the accepted path reached a leaf of the current tree, or no child of
    the last accepted node carries the sampled token (ref :957-978)."""
    node_cap, depth_cap = tree.node_cap, tree.depth_cap
    dev = tree.tokens.device
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    best_leaf, accept_len = as_t(best_leaf), as_t(accept_len)
    sampled_token = as_t(sampled_token)
    d_idx = torch.arange(depth_cap, device=dev)

    path = take(tree.retrieve, best_leaf)                      # (D,)
    accepted_path = torch.where(d_idx < accept_len, path, -1)
    last_accepted = take(path, (accept_len - 1).clamp(0, depth_cap - 1))
    at_leaf = (accept_len >= depth_cap) | (
        take(path, accept_len.clamp(0, depth_cap - 1)) < 0)

    valid = tree.valid()
    tok_match = (tree.parents == last_accepted) & valid \
        & (tree.tokens == sampled_token)
    has_match = tok_match.any()
    truncate = at_leaf | ~has_match
    new_root = torch.where(
        truncate, -1, torch.argmax(tok_match.to(torch.int8))).to(torch.int32)

    anc = ancestor_matrix(tree.parents, depth_cap, valid)
    keep = anc.index_select(1, new_root.clamp(0, node_cap - 1).reshape(
        1).long())[:, 0] & (new_root >= 0)
    n_kept = keep.sum().to(torch.int32)
    ar = torch.arange(node_cap, device=dev)
    kept_old_ids = torch.where(ar < n_kept, kept_order(keep),
                               -1).to(torch.int32)
    return PruneInfo(truncate=truncate, new_root=new_root,
                     accept_len=accept_len,
                     accepted_path=accepted_path.to(torch.int32), keep=keep,
                     kept_old_ids=kept_old_ids, n_kept=n_kept)


def old_to_new(info: PruneInfo, node_cap: int) -> torch.Tensor:
    """(N,) int32: the new id of each kept old node, -1 for the rest."""
    dev = info.kept_old_ids.device
    ar = torch.arange(node_cap, device=dev, dtype=torch.int32)
    in_range = ar < info.n_kept
    # the old root is never kept, so the clamped pad entries (-1 -> 0) are
    # the only writes to slot 0 and all write -1
    return torch.full((node_cap,), -1, dtype=torch.int32, device=dev).scatter(
        0, info.kept_old_ids.clamp(0, node_cap - 1).long(),
        torch.where(in_range, ar, -1))


def prune_tree(tree: TokenTree, info: PruneInfo) -> TokenTree:
    """Re-root the tree at `info.new_root`, kept nodes compacted to the
    front in ascending old-id order (ancestors still precede descendants).
    On truncate the result is an empty 1-node tree."""
    node_cap = tree.node_cap
    kept = info.kept_old_ids.clamp(0, node_cap - 1).long()
    in_range = torch.arange(node_cap, device=kept.device) < info.n_kept
    old2new = old_to_new(info, node_cap)

    tokens = torch.where(in_range, tree.tokens[kept], -1).to(torch.int32)
    parents = torch.where(
        in_range, old2new[tree.parents[kept].clamp(0, node_cap - 1).long()],
        -1).to(torch.int32)
    parents[0].fill_(-1)                                       # new root
    root_score = take(tree.scores, info.new_root.clamp(0, node_cap - 1))
    scores = torch.where(in_range, tree.scores[kept] - root_score,
                         -torch.inf)
    return finalize_tree(tokens, parents, scores,
                         info.n_kept.clamp_min(1), tree.leaf_cap,
                         tree.depth_cap)


def kv_keep_positions(info: PruneInfo, global_offset, kv_in_tree,
                      pos_cap: int):
    """Positions to keep in a verify-stage KV cache after pruning: the
    cache holds `global_offset` committed rows, then `kv_in_tree` tree rows
    (tree node id == row - global_offset). Keep the accepted path (old root
    included) first, then the kept nodes already in the cache, compacted to
    `global_offset`. Returns (src_positions (pos_cap,), n_src)."""
    node_cap = info.keep.shape[0]
    d = info.accepted_path.shape[0]
    dev = info.keep.device
    n_acc = (info.accepted_path >= 0).sum().to(torch.int32)
    kept_in_cache = (info.kept_old_ids >= 0) \
        & (info.kept_old_ids < kv_in_tree)
    n_src = n_acc + kept_in_cache.sum().to(torch.int32)

    idx = torch.arange(pos_cap, device=dev)
    acc_part = torch.where(idx < d,
                           info.accepted_path[idx.clamp(0, d - 1)], -1)
    kept_part = info.kept_old_ids[(idx - n_acc).clamp(0, node_cap - 1)]
    entry = torch.where(idx < n_acc, acc_part, kept_part)
    entry = torch.where(idx < n_src, entry, 0)
    return (entry.clamp_min(0) + global_offset).to(torch.int32), n_src
