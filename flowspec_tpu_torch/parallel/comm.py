"""The collectives of tensor parallelism, behind one small interface.

What `shard_map` and GSPMD insert into the JAX package's TP programs (psum,
all_gather, the `ppermute` ring of `parallel/galaxy.py`) is written here
out, over a TP group of `size` ranks. A process holds the shards of the
ranks in `group.ranks`; every sharded quantity is a list with one tensor a
local rank, in that order, and a replicated one is a single tensor:

- `all_reduce(parts)`: the sum of every rank's partial (one tensor);
- `all_gather(parts, dim)`: every rank's shard joined along `dim` in rank
  order (one tensor);
- `ring_shift(parts, shift)`: the parts moved `shift` ranks along the ring,
  rank r receiving rank (r - shift) mod size's (a list again).

Two groups implement it:

- `InProcessGroup`: all `size` ranks in one process (on one card, or in
  the CPU tests). The ranks run one after another on one stream, the
  collectives are memory operations, and nothing reads back to the host, so
  a CUDA graph captures a TP round whole. The partials of `all_reduce` are
  each cast to f32 and added in rank order (0, 1, ...), and the sum is cast
  once to the partials' dtype: the bits do not depend on anything but the
  partials.
- `DistGroup`: one rank a process over `torch.distributed` (the world),
  whose backend follows the device: gloo for CPU tensors, NCCL for
  CUDA ones (`parallel/mesh.py init_multihost`). A tensor on the other kind
  of device raises; nothing switches between the two. `all_reduce` sums
  f32 copies in the backend's order, so two ranks give the in-process bits
  (a sum of two terms does not depend on its order) and more may round
  differently.
"""

from __future__ import annotations

import torch


def _sum_f32(parts):
    """The partials cast to f32, added in list order, cast back once."""
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(parts[0].dtype)


class InProcessGroup:
    """A TP group whose `size` ranks all live in this process."""

    distributed = False

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a TP group needs >= 1 rank, got {size}")
        self.size = size
        self.ranks = tuple(range(size))

    def _check(self, parts):
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for {self.size} ranks")

    def all_reduce(self, parts) -> torch.Tensor:
        self._check(parts)
        return _sum_f32(parts)

    def all_gather(self, parts, dim: int = -1) -> torch.Tensor:
        self._check(parts)
        return parts[0] if self.size == 1 else torch.cat(parts, dim=dim)

    def ring_shift(self, parts, shift: int = 1) -> list:
        self._check(parts)
        return [parts[(r - shift) % self.size] for r in self.ranks]


class DistGroup:
    """A TP group of one rank a process: the `torch.distributed` world."""

    distributed = True

    def __init__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "parallel.mesh.init_multihost first")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)
        self.backend = dist.get_backend()

    def _one(self, parts) -> torch.Tensor:
        if len(parts) != 1:
            raise ValueError(f"a process of a DistGroup holds one rank, got "
                             f"{len(parts)} parts")
        x = parts[0]
        want = "nccl" if x.is_cuda else "gloo"
        if self.backend != want:
            raise ValueError(f"a {x.device.type} tensor needs the {want} "
                             f"backend, the group runs {self.backend}")
        return x

    def all_reduce(self, parts) -> torch.Tensor:
        import torch.distributed as dist
        x = self._one(parts)
        acc = x.float().clone()
        dist.all_reduce(acc)
        return acc.to(x.dtype)

    def all_gather(self, parts, dim: int = -1) -> torch.Tensor:
        import torch.distributed as dist
        x = self._one(parts).contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x)
        return torch.cat(out, dim=dim)

    def ring_shift(self, parts, shift: int = 1) -> list:
        import torch.distributed as dist
        x = self._one(parts).contiguous()
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (self.rank + shift) % self.size),
               dist.P2POp(dist.irecv, got, (self.rank - shift) % self.size)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [got]
