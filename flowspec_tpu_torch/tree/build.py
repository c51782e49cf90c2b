"""Construct a TokenTree from flat (token, score, parent) candidate arrays.

Port of `flowspec_tpu/tree/build.py`: global top-N selection over all beam
candidates, re-indexing, ancestor mask and retrieve paths. Every ordering
that decides the tree uses a stable sort, as the JAX package does, so equal
scores (common: invalid candidates all carry -inf) keep flat-index order.
Every function works on (M,) candidates or on (B, M), one pool a lane
(`tree/types.py`), along the last axis.
"""

from __future__ import annotations

import torch

from flowspec_tpu_torch.tree.types import TokenTree, ancestor_matrix


def _rank(order: torch.Tensor) -> torch.Tensor:
    """Inverse permutation along the last axis: rank[order[i]] = i."""
    ar = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(-1, order, ar.expand_as(order))


def select_topn(cand_scores: torch.Tensor, cand_valid: torch.Tensor,
                num_select: int,
                force_include: torch.Tensor | None = None) -> torch.Tensor:
    """([B,] M) bool — top-`num_select` valid candidates by score, plus
    everything in `force_include`."""
    eligible = cand_valid
    if force_include is not None:
        eligible = eligible & ~force_include
    neg_inf = torch.full((), -torch.inf, device=cand_scores.device)
    masked = torch.where(eligible, cand_scores, neg_inf)
    rank = _rank(torch.argsort(-masked, dim=-1, stable=True))
    sel = eligible & (rank < num_select) & (masked > -torch.inf)
    if force_include is not None:
        sel = sel | (force_include & cand_valid)
    return sel


def build_tree(cand_tokens: torch.Tensor, cand_scores: torch.Tensor,
               cand_parents: torch.Tensor, selected: torch.Tensor,
               root_token: torch.Tensor, node_cap: int, leaf_cap: int,
               depth_cap: int, sort_score: bool = False) -> TokenTree:
    """Assemble the tree from an ancestor-closed selection mask: selected
    candidates become nodes 1..n in flat order or, with `sort_score`, by
    descending cumulative score (ties keep flat order). Selections beyond
    node_cap-1 are dropped lowest-score first. Per lane: (B, M) candidates
    and a (B,) root_token."""
    m = cand_tokens.shape[-1]
    lead = cand_tokens.shape[:-1]
    dev = cand_tokens.device
    neg_inf = torch.full((), -torch.inf, device=dev)

    masked = torch.where(selected, cand_scores, neg_inf)
    rank = _rank(torch.argsort(-masked, dim=-1, stable=True))
    selected = selected & (rank < node_cap - 1)

    n_sel = selected.sum(dim=-1).to(torch.int32)
    if sort_score:
        sel_order = torch.argsort(
            -torch.where(selected, cand_scores, neg_inf), dim=-1,
            stable=True)
    else:
        sel_order = torch.argsort((~selected).to(torch.int8), dim=-1,
                                  stable=True)
    qn = torch.arange(node_cap, device=dev)
    # candidate for node q
    src = torch.gather(sel_order, -1,
                       (qn - 1).clamp(0, m - 1).expand(*lead, node_cap))
    in_sel = (qn >= 1) & (qn <= n_sel[..., None])

    # invmap: flat candidate index -> node index (0 = root for parent -1)
    am = torch.arange(m, device=dev)
    invmap = torch.full((*lead, m), -1, dtype=torch.int32, device=dev)
    invmap.scatter_(-1, sel_order, torch.where(
        am < n_sel[..., None], am + 1, -1).to(torch.int32))

    pf = torch.gather(cand_parents, -1, src).long()
    parents = torch.where(pf < 0, 0,
                          torch.gather(invmap, -1, pf.clamp(0, m - 1)))
    tokens = torch.where(in_sel, torch.gather(cand_tokens, -1, src),
                         -1).to(torch.int32)
    parents = torch.where(in_sel, parents, -1).to(torch.int32)
    scores = torch.where(in_sel, torch.gather(cand_scores, -1, src),
                         neg_inf)

    # fills and a device copy: a Python scalar assigned by index would be
    # copied from the host, which a captured CUDA graph cannot do
    tokens[..., 0].copy_(root_token)
    parents[..., 0].fill_(-1)
    scores[..., 0].fill_(0.0)
    return finalize_tree(tokens, parents, scores, n_sel + 1, leaf_cap,
                         depth_cap)


def finalize_tree(tokens: torch.Tensor, parents: torch.Tensor,
                  scores: torch.Tensor, n_nodes: torch.Tensor, leaf_cap: int,
                  depth_cap: int) -> TokenTree:
    """Derive depth + retrieve from (tokens, parents) and pack a TokenTree
    (one tree, or one a lane)."""
    node_cap = tokens.shape[-1]
    n_nodes = torch.as_tensor(n_nodes, dtype=torch.int32,
                              device=tokens.device)
    valid = torch.arange(node_cap, device=tokens.device) < n_nodes[..., None]
    anc = ancestor_matrix(parents, depth_cap, valid)
    depth = anc.sum(dim=-1).to(torch.int32) - 1             # root -> 0
    depth = torch.where(valid, depth, 0).to(torch.int32)
    retrieve, n_leaves = compute_retrieve(parents, depth, valid, anc,
                                          leaf_cap, depth_cap)
    return TokenTree(tokens=tokens, parents=parents, depth=depth,
                     scores=scores, retrieve=retrieve, n_nodes=n_nodes,
                     n_leaves=n_leaves)


def compute_retrieve(parents: torch.Tensor, depth: torch.Tensor,
                     valid: torch.Tensor, anc: torch.Tensor, leaf_cap: int,
                     depth_cap: int):
    """(L, D) per-leaf root->leaf node paths in ascending-node-index leaf
    order, and the leaf count (capped at leaf_cap). A node is a leaf iff no
    valid node names it as parent; the path entry at depth d is the leaf's
    unique ancestor of depth d. Per lane along the last axes."""
    node_cap = parents.shape[-1]
    lead = parents.shape[:-1]
    dev = parents.device
    idx = torch.arange(node_cap, device=dev)

    has_parent = (valid & (parents >= 0)).to(torch.int32)
    has_child = torch.zeros_like(has_parent).scatter_reduce(
        -1, parents.long().clamp(0, node_cap - 1), has_parent, "amax")
    is_leaf = valid & (has_child == 0)

    n_leaves = is_leaf.sum(dim=-1).to(torch.int32)
    order = torch.argsort((~is_leaf).to(torch.int8), dim=-1, stable=True)
    leaf_nodes = torch.where(idx < n_leaves[..., None], order,
                             -1)[..., :leaf_cap]
    n_l = leaf_nodes.shape[-1]

    leaf_anc = torch.gather(anc, -2, leaf_nodes.clamp(0, node_cap - 1)[
        ..., None].expand(*lead, n_l, node_cap))                  # (L, N)
    depth_eq = depth[..., None, None, :] == torch.arange(
        depth_cap, device=dev)[:, None]                           # (1, D, N)
    hit = leaf_anc[..., :, None, :] & depth_eq                    # (L, D, N)
    found = hit.any(dim=-1)
    entry = hit.to(torch.int8).argmax(dim=-1)     # first hit, as jnp.argmax
    retrieve = torch.where(found, entry, -1)
    retrieve = torch.where((leaf_nodes >= 0)[..., None], retrieve, -1)
    return retrieve.to(torch.int32), torch.clamp(n_leaves, max=leaf_cap)
