"""Attention-bias builders for prefill and tree chunks.

Port of `flowspec_tpu/models/bias.py`: the model is mask-agnostic; callers
build one additive (T, S) bias per forward and every layer reuses it. The
start and base are host ints or 0-d tensors on the device (the serving
path's lengths), so the bias of a replayed CUDA graph follows each round;
a (B,) start or base (B lanes, each with its own length) gives one bias a
lane, (B, T, S).
"""

from __future__ import annotations

import torch

from flowspec_tpu_torch.tree.types import NEG_INF


def prefill_bias(start, t: int, s_max: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """(T, S) bias for a contiguous chunk written at [start, start+T): query
    i attends cache positions j <= start + i; (B, T, S) for a (B,) start."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(s_max, device=device)[None, :]
    if isinstance(start, torch.Tensor) and start.dim():
        start = start[:, None, None]
    ok = j <= start + i
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def tree_bias(anc_bias_rows: torch.Tensor, tree_base, s_max: int,
              dtype=torch.float32) -> torch.Tensor:
    """(T, S) bias for the tree written at cache positions
    [tree_base, tree_base + N): [0, tree_base) is committed context
    (always attendable), [tree_base, tree_base + N) the tree nodes whose
    ancestor bias rows `anc_bias_rows` (T, N_cap) gives, and every column
    past the tree region holds stale KV and is masked. Per lane: rows (B,
    T, N_cap) and a (B,) base give (B, T, S)."""
    n_cap = anc_bias_rows.shape[-1]
    j = torch.arange(s_max, device=anc_bias_rows.device)
    if anc_bias_rows.dim() == 3:
        b, t, _ = anc_bias_rows.shape
        base = tree_base.reshape(-1, 1).expand(b, 1)
        tree_col = (j - base).clamp(0, n_cap - 1)               # (B, S)
        tree_part = torch.gather(anc_bias_rows, 2,
                                 tree_col[:, None, :].expand(b, t, s_max))
        base = base[:, :, None]
    else:
        base = tree_base
        tree_col = (j - tree_base).clamp(0, n_cap - 1)
        tree_part = anc_bias_rows[:, tree_col]
    out = torch.where(j < base + n_cap, tree_part, NEG_INF)
    out = torch.where(j < base, 0.0, out)
    return out.to(dtype)
