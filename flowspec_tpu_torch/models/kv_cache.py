"""Preallocated KV cache with explicit length + gather-compaction.

Port of `flowspec_tpu/models/kv_cache.py`. Buffers are stacked over layers
(L, B, H_kv, S, D) and updated IN PLACE (the JAX package donates the old
state instead; a caller here never reuses a cache after passing it on).
`length` is a 0-d int32 tensor on the cache's device, as in the JAX state:
every write position derives from it on the device, so a replayed CUDA
graph (`runtime/graphs.py`) writes where this round's lengths say, and no
write needs a device-to-host read.

`jax.lax.dynamic_update_slice` clamps its start so the update fits; a torch
slice assignment does not, so every write here goes through `clamp_start`
(a host int for a host start, a device scalar for a device one) and
`index_copy_` at the rows `write_rows` gives.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def clamp_start(start, size: int, total: int):
    """The start `dynamic_update_slice` uses for a `size`-long update of a
    `total`-long axis: clamp(start, 0, total - size), on the device for a
    tensor `start`."""
    if isinstance(start, torch.Tensor):
        return start.clamp(0, total - size)
    return min(max(int(start), 0), total - size)


def write_rows(start, size: int, total: int, device) -> torch.Tensor:
    """(size,) int64 rows of a `size`-long update at `start` (clamped as
    `clamp_start` does), for `index_copy_`."""
    return clamp_start(start, size, total) + torch.arange(size, device=device)


def device_scalar(x, device) -> torch.Tensor:
    """`x` as a 0-d int32 tensor on `device` (a tensor is only cast), made
    by a fill on the device, not a copy from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor         # (L, B, H_kv, S, D)
    v: torch.Tensor         # (L, B, H_kv, S, D)
    length: torch.Tensor    # () int32 — valid positions, on k's device

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def with_length(self, length) -> "KVCache":
        return KVCache(k=self.k, v=self.v,
                       length=device_scalar(length, self.k.device))

    def compact(self, src_positions: torch.Tensor, n_src,
                dst_start) -> "KVCache":
        """Move rows `src_positions[:n_src]` to [dst_start, dst_start+n_src)
        and set length = dst_start + n_src. All pos_cap padded entries are
        written (to slots past the new length). Source and destination rows
        overlap, so the rows are gathered into new tensors before the write.
        `n_src` and `dst_start` are host ints or device scalars.
        """
        pos_cap = src_positions.shape[0]
        src = src_positions.long().clamp(0, self.max_len - 1)
        gk = self.k.index_select(3, src)         # gather first (a copy)
        gv = self.v.index_select(3, src)
        dst = write_rows(dst_start, pos_cap, self.max_len, self.k.device)
        self.k.index_copy_(3, dst, gk)
        self.v.index_copy_(3, dst, gv)
        return self.with_length(device_scalar(dst_start, self.k.device)
                                + n_src)


def grow_kv(cache: KVCache, rows: int) -> KVCache:
    """The counterpart of `flowspec_tpu/runtime/engine.py _grow_kv` for one
    cache: zero-pad the sequence axis to `rows` (a larger KV bucket); the
    live rows and the length carry over unchanged."""
    pad = rows - cache.max_len
    if pad < 0:
        raise ValueError(f"grow_kv: {rows} rows < the cache's {cache.max_len}")
    return KVCache(k=F.pad(cache.k, (0, 0, 0, pad)),
                   v=F.pad(cache.v, (0, 0, 0, pad)), length=cache.length)


def init_kv_cache(num_layers: int, batch: int, num_kv_heads: int,
                  max_len: int, head_dim: int, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))
