"""Graft a freshly drafted tree onto the pruned in-flight tree.

Port of `flowspec_tpu/tree/merge.py:27-106` (ref `merge_two_tree`,
pipeline_utils.py:1176-1303): a depth-synchronous match (two nodes are the
same token path iff their parents match and their tokens are equal; one
(N2, N1) comparison a level, a Python loop over the depth_cap - 1 levels),
then the unmatched nodes of tree2 are appended after tree1's in tree2's
order, the lowest scores spilled beyond node_cap, and an ancestor-closure
pass drops any node whose parent was spilled. One tree, no lane axis; the
first match wins (`argmax` of a bool) and every sort is stable, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flowspec_tpu_torch.tree.build import _rank, finalize_tree
from flowspec_tpu_torch.tree.prune import kept_order
from flowspec_tpu_torch.tree.types import TokenTree


class MergeResult(NamedTuple):
    tree: TokenTree
    n_appended: torch.Tensor      # () int32 — nodes appended to tree1
    map2_to_merged: torch.Tensor  # (N,) int32 — tree2 id -> merged id


def merge_trees(tree1: TokenTree, tree2: TokenTree,
                max_depth: int | None = None) -> MergeResult:
    """Both trees share the root token. Appended nodes follow tree1's in
    tree2 order, so every parent still precedes its children. `max_depth`
    bounds tree2's depth where the caller knows it (a beam of n levels
    builds a tree of depth <= n + 1): the levels past it match nothing, so
    the match stops there (JAX scans all depth_cap - 1 levels)."""
    n = tree1.node_cap
    assert tree2.node_cap == n
    dev = tree1.tokens.device
    valid1, valid2 = tree1.valid(), tree2.valid()

    p2 = tree2.parents.long()
    p2c = p2.clamp(0, n - 1)
    p1 = torch.where(tree1.parents >= 0, tree1.parents, -2)
    same_tok = (tree2.tokens[:, None] == tree1.tokens[None, :]) \
        & valid1[None, :]
    map2 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    map2[0].fill_(0)                                  # roots coincide
    levels = tree1.depth_cap if max_depth is None else \
        min(tree1.depth_cap, max_depth + 1)
    for d in range(1, levels):
        mapped_p2 = torch.where(p2 >= 0, map2[p2c], -2)
        at_d = (tree2.depth == d) & valid2
        cand = (mapped_p2[:, None] == p1[None, :]) & same_tok \
            & at_d[:, None]
        j = torch.argmax(cand.to(torch.int8), dim=1).to(torch.int32)
        map2 = torch.where(at_d, torch.where(cand.any(dim=1), j, -1), map2)

    # appended: unmatched, the best `capacity` by score, ancestor-closed
    unmatched = valid2 & (map2 < 0)
    n1 = tree1.n_nodes
    scores2 = torch.where(unmatched, tree2.scores, -torch.inf)
    rank_of = _rank(torch.argsort(-scores2, stable=True))
    appended = unmatched & (rank_of < n - n1)
    for _ in range(4):      # score monotonicity makes >1 pass a no-op
        parent_ok = torch.where(p2 >= 0,
                                (map2[p2c] >= 0) | appended[p2c], True)
        appended = appended & parent_ok
    n_app = appended.sum().to(torch.int32)

    merged_id_app = n1 + torch.cumsum(appended.to(torch.int32), 0) - 1
    map2m = torch.where(map2 >= 0, map2,
                        torch.where(appended, merged_id_app, -1)).to(
        torch.int32)

    q = torch.arange(n, device=dev)
    src2 = kept_order(appended)[(q - n1).clamp(0, n - 1)]
    in_app = (q >= n1) & (q < n1 + n_app)
    old = q < n1
    src_par = map2m[tree2.parents[src2].clamp(0, n - 1).long()]
    tokens = torch.where(old, tree1.tokens,
                         torch.where(in_app, tree2.tokens[src2], -1))
    parents = torch.where(old, tree1.parents,
                          torch.where(in_app, src_par, -1))
    scores = torch.where(old, tree1.scores,
                         torch.where(in_app, tree2.scores[src2], -torch.inf))
    merged = finalize_tree(tokens.to(torch.int32), parents.to(torch.int32),
                           scores, n1 + n_app, tree1.leaf_cap,
                           tree1.depth_cap)
    return MergeResult(tree=merged, n_appended=n_app, map2_to_merged=map2m)
