"""TokenTree: the static-capacity draft-tree representation.

Port of `flowspec_tpu/tree/types.py`. The canonical encoding is a parents
array padded to a fixed node capacity; the ancestor mask and retrieve paths
are derived with vectorized index ops. Node 0 is always the root. Parents
precede children. Invalid slots (i >= n_nodes) have parent -1, token -1,
depth 0. `n_nodes`/`n_leaves` are 0-d int32 tensors on the tree's device.

A tree of B lanes (requests served together) carries a leading lane axis
on every field: tokens (B, N), retrieve (B, L, D), n_nodes (B,), and so
on. Every function here works on either form, lane by lane.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class TokenTree:
    tokens: torch.Tensor    # ([B,] N) int32 — node tokens; [0] = root token
    parents: torch.Tensor   # ([B,] N) int32 — parent node; -1 root/invalid
    depth: torch.Tensor     # ([B,] N) int32 — root depth 0
    scores: torch.Tensor    # ([B,] N) float32 — cumulative draft log-prob
    retrieve: torch.Tensor  # ([B,] L, D) int32 — root->leaf paths, -1 pad
    n_nodes: torch.Tensor   # ([B]) int32
    n_leaves: torch.Tensor  # ([B]) int32

    @property
    def node_cap(self) -> int:
        return self.tokens.shape[-1]

    @property
    def leaf_cap(self) -> int:
        return self.retrieve.shape[-2]

    @property
    def depth_cap(self) -> int:
        return self.retrieve.shape[-1]

    def valid(self) -> torch.Tensor:
        """([B,] N) bool — which node slots are live."""
        return torch.arange(self.node_cap, device=self.tokens.device) \
            < self.n_nodes[..., None]

    def leaf_valid(self) -> torch.Tensor:
        return torch.arange(self.leaf_cap, device=self.tokens.device) \
            < self.n_leaves[..., None]

    def candidates(self) -> torch.Tensor:
        """([B,] L, D) int32 token sequences along each root->leaf path, -1
        pad."""
        safe = self.retrieve.clamp(0, self.node_cap - 1).long()
        toks = torch.gather(
            self.tokens[..., None, :].expand(*safe.shape[:-1],
                                             self.node_cap), -1, safe)
        return torch.where(self.retrieve >= 0, toks, -1)

    def lanes(self) -> "TokenTree":
        """The tree with a lane axis: itself if it has one, else as B = 1
        (views)."""
        if self.tokens.dim() == 2:
            return self
        return TokenTree(**{f.name: getattr(self, f.name)[None]
                            for f in dataclasses.fields(self)})

    def lane(self, b: int) -> "TokenTree":
        """Lane `b` as a one-request tree (views)."""
        return TokenTree(**{f.name: getattr(self, f.name)[b]
                            for f in dataclasses.fields(self)})


def take(x: torch.Tensor, *index: torch.Tensor) -> torch.Tensor:
    """x[i, j, ...] for 0-d index tensors, gathered on the device. PyTorch
    takes a 0-d tensor index for a Python int and reads it back to the
    host, which a captured CUDA graph cannot do."""
    return x[tuple(i.reshape(1).long() for i in index)][0]


def lane_take(x: torch.Tensor, *index: torch.Tensor) -> torch.Tensor:
    """x[b, i[b], j[b], ...] for every lane b of (B,) index tensors: (B,
    ...), gathered on the device."""
    lanes = torch.arange(x.shape[0], device=x.device)
    return x[(lanes,) + tuple(i.long() for i in index)]


def lane_gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[b, index[b, j], ...] for (B, J) `index`: (B, J, ...) — rows of
    each lane's own (B, N, ...) slice."""
    lanes = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[lanes, index.long()]


def ceil_log2(x: int) -> int:
    n = 0
    while (1 << n) < x:
        n += 1
    return n


def ancestor_matrix(parents: torch.Tensor, depth_cap: int,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """([B,] N, N) bool: out[i, j] iff j is an ancestor of i or i == j, by
    pointer doubling (`ceil_log2(depth_cap) + 1` gather-OR steps)."""
    n = parents.shape[-1]
    lead = parents.shape[:-1]
    anc = torch.eye(n, dtype=torch.bool, device=parents.device).expand(
        *lead, n, n)
    ptr = parents.long()
    for _ in range(ceil_log2(depth_cap) + 1):
        safe = ptr.clamp(0, n - 1)
        live = ptr >= 0
        hop_rows = torch.gather(anc, -2, safe[..., None].expand(*lead, n, n)) \
            & live[..., None]
        ptr = torch.where(live, torch.gather(ptr, -1, safe), -1)
        anc = anc | hop_rows
    if valid is not None:
        anc = anc & valid[..., :, None] & valid[..., None, :]
    return anc


def tree_attention_bias(parents: torch.Tensor, depth_cap: int,
                        valid: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """(N, N) additive attention bias: 0 where attendable, NEG_INF else."""
    anc = ancestor_matrix(parents, depth_cap, valid)
    zero = torch.zeros((), dtype=dtype, device=parents.device)
    return torch.where(anc, zero, torch.full_like(zero, NEG_INF))


def depths_from_parents(parents: torch.Tensor, depth_cap: int) -> torch.Tensor:
    """([B,] N) int32 depth of each node (root = 0) by pointer doubling."""
    n = parents.shape[-1]
    depth = (parents >= 0).to(torch.int32)
    ptr = parents.long()
    for _ in range(ceil_log2(depth_cap) + 1):
        safe = ptr.clamp(0, n - 1)
        live = ptr >= 0
        hop_depth = torch.where(live, torch.gather(depth, -1, safe), 0)
        hop_ptr = torch.where(live, torch.gather(ptr, -1, safe), -1)
        depth = depth + hop_depth
        ptr = torch.where(live, hop_ptr, -1)
    return depth.to(torch.int32)
