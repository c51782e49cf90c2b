"""Preallocated KV cache with explicit length + gather-compaction.

Port of `flowspec_tpu/models/kv_cache.py`. Buffers are stacked over layers
(L, B, H_kv, S, D) and updated IN PLACE (the JAX package donates the old
state instead; a caller here never reuses a cache after passing it on).
`length` is an int32 tensor on the cache's device, as in the JAX state, one
a lane: (B,) for B lanes (requests served together, one per index of the B
axis, each with its own length; an engine's one request is one lane). The
JAX package's single-request functions, called here as there with host-int
starts, give a 0-d length. Every write position derives from it on the
device, so a replayed CUDA graph (`runtime/graphs.py`) writes where this
round's lengths say, and no write needs a device-to-host read.

`jax.lax.dynamic_update_slice` clamps its start so the update fits; a torch
slice assignment does not, so every write here goes through `clamp_start`
(a host int for a host start, a device tensor for a device one), one start
a lane, and one `index_copy_` over the cache viewed as rows of D at the
rows `flat_rows` gives.

Lanes the caller marks dead (`live`, a (B,) bool: a lane that is idle,
finished or frozen, whose state the caller keeps as it was) write nowhere
near their valid rows: every row of such a lane's write goes to the lane's
last row, S - 1, which no length reaches (a clamped start could otherwise
pull the write below the lane's length). That row is scratch: its content
is undefined (many rows land on it, in no fixed order) and never read. The
JAX package selects the whole old state back instead; here that would copy
every cache every round.

A latent cache (DeepSeek's MLA, `models/deepseek.py`) holds one row a token
and layer shared by every head: `k` is (L, B, 1, S, C) and `v` is None
(the values are the first columns of the latent rows). Writes, compaction,
growth and lanes treat it as a cache of one KV head with no V buffer.
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


def write_rows(start: torch.Tensor, size: int, total: int,
               live: torch.Tensor | None = None) -> torch.Tensor:
    """(B, size) int64 rows of a `size`-long update at each lane's `start`
    ((B,), clamped as `clamp_start` does). A lane with `live` False writes
    every row to S - 1 (the module's note)."""
    rows = (clamp_start(start, size, total).long()[:, None]
            + torch.arange(size, device=start.device))
    if live is not None:
        rows = torch.where(live[:, None], rows, total - 1)
    return rows


def flat_rows(rows: torch.Tensor, heads: int, total: int) -> torch.Tensor:
    """Indices into one layer's (B, heads, total, D) buffer viewed as
    (B * heads * total, D) rows, of the (B, T) per-lane `rows` of every
    head, in (lane, head, row) order: (B * heads * T,) int64."""
    b, t = rows.shape
    base = torch.arange(b * heads, device=rows.device).view(b, heads, 1)
    return (base * total + rows.view(b, 1, t)).reshape(-1)


def device_scalar(x, device) -> torch.Tensor:
    """`x` as a 0-d int32 tensor on `device` (a tensor is only cast), made
    by a fill on the device, not a copy from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


def lane_tensor(x, lanes: int, device) -> torch.Tensor:
    """A host int or a 0-d / (lanes,) tensor as a (lanes,) int32 tensor on
    `device` (a view where it can be one, a fill otherwise)."""
    x = device_scalar(x, device)
    return x.reshape(-1).expand(lanes) if x.dim() == 0 else x


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor         # (L, B, H_kv, S, D); a latent cache's rows
    v: torch.Tensor | None  # (L, B, H_kv, S, D); None in a latent cache
    length: torch.Tensor    # () or (B,) int32 — valid positions, on k's
                            #   device

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def buffers(self) -> tuple:
        """The row buffers: (k, v), or (k,) for a latent cache."""
        return (self.k,) if self.v is None else (self.k, self.v)

    def with_length(self, length) -> "KVCache":
        return KVCache(k=self.k, v=self.v,
                       length=device_scalar(length, self.k.device))

    def compact(self, src_positions: torch.Tensor, n_src, dst_start,
                live: torch.Tensor | None = None) -> "KVCache":
        """Move rows `src_positions[..., :n_src]` to [dst_start, dst_start +
        n_src) and set length = dst_start + n_src, lane by lane. All pos_cap
        padded entries are written (to slots past the new length). Source
        and destination rows overlap, so the rows are gathered into new
        tensors before the write. `src_positions` is (pos_cap,) (every lane)
        or (B, pos_cap); `n_src` and `dst_start` are host ints or 0-d / (B,)
        device tensors; the length comes back (B,). Dead lanes (`live`)
        write to their last row and keep their length."""
        n_l, b, h, s_max, d = self.k.shape
        pos_cap = src_positions.shape[-1]
        dev = self.k.device
        src = src_positions.long().clamp(0, s_max - 1).reshape(-1, pos_cap)
        src = src.expand(b, pos_cap)
        dst_start = lane_tensor(dst_start, b, dev)
        dst = write_rows(dst_start, pos_cap, s_max, live)
        flats = [x.view(n_l, b * h * s_max, d) for x in self.buffers]
        gsrc = flat_rows(src, h, s_max)
        gathered = [f.index_select(1, gsrc)      # gather first (a copy)
                    for f in flats]
        gdst = flat_rows(dst, h, s_max)
        for f, g in zip(flats, gathered):
            f.index_copy_(1, gdst, g)
        length = dst_start + n_src
        if live is not None:
            length = torch.where(live, length, self.length)
        return self.with_length(length)


def grow_kv(cache: KVCache, rows: int) -> KVCache:
    """The counterpart of `flowspec_tpu/runtime/engine.py _grow_kv` for one
    cache: zero-pad the sequence axis to `rows` (a larger KV bucket); the
    live rows and the length carry over unchanged."""
    pad = rows - cache.max_len
    if pad < 0:
        raise ValueError(f"grow_kv: {rows} rows < the cache's {cache.max_len}")
    return KVCache(k=F.pad(cache.k, (0, 0, 0, pad)),
                   v=None if cache.v is None else F.pad(cache.v,
                                                        (0, 0, 0, pad)),
                   length=cache.length)


def init_kv_cache(num_layers: int, batch: int, num_kv_heads: int,
                  max_len: int, head_dim: int, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    """Zero caches of `batch` lanes, each with its own (zero) length."""
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=device))


def init_latent_cache(num_layers: int, batch: int, max_len: int,
                      width: int, dtype=torch.bfloat16,
                      device=None) -> KVCache:
    """A zero latent cache (the module's note): (L, B, 1, S, width) rows,
    no V buffer, one (zero) length a lane."""
    return KVCache(k=torch.zeros((num_layers, batch, 1, max_len, width),
                                 dtype=dtype, device=device),
                   v=None,
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=device))


def stack_lanes(caches) -> KVCache:
    """One lane cache from one-lane caches (each (L, 1, ...), (1,)
    length), lane b the b-th: a copy."""
    return KVCache(k=torch.cat([c.k for c in caches], dim=1),
                   v=torch.cat([c.v for c in caches], dim=1),
                   length=torch.cat([c.length for c in caches]))


def read_lane(cache: KVCache, b: int) -> KVCache:
    """Lane `b` of a lane cache as a one-lane cache ((L, 1, ...), (1,)
    length): a copy, so the lane may be reused while the caller holds it."""
    return KVCache(k=cache.k[:, b:b + 1].clone(),
                   v=cache.v[:, b:b + 1].clone(),
                   length=cache.length[b:b + 1].clone())


def write_lane(cache: KVCache, b: int, src: KVCache,
               payload: bool = True) -> None:
    """Copy the one-lane cache `src` into lane `b` of `cache`, in place:
    the rows (unless `payload` is False: a zero-length source has no rows
    worth copying) and the length."""
    if payload:
        cache.k[:, b].copy_(src.k[:, 0])
        cache.v[:, b].copy_(src.v[:, 0])
    cache.length[b].copy_(src.length[0])
