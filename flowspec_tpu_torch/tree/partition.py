"""Tree partitioning into pipeline chunks.

Port of `flowspec_tpu/tree/partition.py:16-73` (ref `token_tree_partition`
/ `get_subseq_ri_cum_depths`, pipeline_utils.py:673-740, and
`split_close_equal`, :136-146). One tree, no lane axis: counts are 0-d
int32 tensors on the tree's device (or host ints), and nothing is read
back to the host.
"""

from __future__ import annotations

import torch


def _scalar(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


def split_close_equal(total, n: int) -> torch.Tensor:
    """(n,) int32 near-equal split of `total`, smaller chunks first."""
    total = _scalar(total)
    i = torch.arange(n, device=total.device)
    return (total // n + (i >= n - total % n).to(torch.int32)).to(
        torch.int32)


def partition_lengths(n_tokens, num_stages: int, chunk_len: int,
                      chunk_cap: int):
    """Initial chunking of a fresh tree: the even split across
    `num_stages` if it stays <= chunk_len (num_stages chunks), else
    num_stages chunks of `chunk_len` and one leftover chunk. Returns (lens
    (chunk_cap,), n_chunks ())."""
    n_tokens = _scalar(n_tokens)
    dev = n_tokens.device
    zeros = lambda k: torch.zeros((k,), dtype=torch.int32, device=dev)
    even = split_close_equal(n_tokens, num_stages)
    small = (n_tokens // num_stages) <= chunk_len
    lens_small = torch.cat([even, zeros(chunk_cap - num_stages)])
    leftover = (n_tokens - chunk_len * num_stages).reshape(1)
    lens_big = torch.cat([
        torch.full((num_stages,), chunk_len, dtype=torch.int32, device=dev),
        leftover, zeros(chunk_cap - num_stages - 1)])[:chunk_cap]
    lens = torch.where(small, lens_small, lens_big)
    n_chunks = torch.where(small, num_stages, num_stages + 1).to(torch.int32)
    return lens, n_chunks


def retrieve_cum_depths(retrieve: torch.Tensor,
                        lens: torch.Tensor) -> torch.Tensor:
    """(S, L): the depth each leaf path reaches within each cumulative chunk
    prefix — entry (s, l) counts retrieve[l, :] values in [0, cum_len[s])."""
    cum = torch.cumsum(lens, 0)
    inside = (retrieve[None] >= 0) & (retrieve[None] < cum[:, None, None])
    return inside.sum(dim=-1).to(torch.int32)


def rebucket_lengths(old_lens: torch.Tensor, kept_old_indices: torch.Tensor,
                     n_kept) -> torch.Tensor:
    """Chunk lengths after pruning (ref draft_stage_pruning:1049-1051):
    each old chunk keeps however many of its node ids survived.
    `kept_old_indices` (K,) is -1 padded."""
    cum = torch.cumsum(old_lens, 0)
    valid = (torch.arange(kept_old_indices.shape[0],
                          device=cum.device) < n_kept) \
        & (kept_old_indices >= 0)
    lo = torch.cat([cum.new_zeros(1), cum[:-1]])
    k = kept_old_indices[None, :]
    in_chunk = (k >= lo[:, None]) & (k < cum[:, None]) & valid[None, :]
    return in_chunk.sum(dim=1).to(torch.int32)
