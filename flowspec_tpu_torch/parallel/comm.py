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

One more transport exists, and only the caller picks it: gloo carrying
CUDA tensors through pinned host buffers (`init_multihost(...,
host_staging=True)`). It is how processes that share one card talk, since
NCCL refuses two ranks on one device: every collective copies its CUDA
operand into a pinned buffer, runs over gloo on the host and copies the
result back, each copy waited for. The choice belongs to the process's one
world, so `init_multihost` records it here (`_WORLD`) and every
`DistGroup` reads it.

`DistGroup` also gives the pipeline's stage ring what JAX's three
collectives over `stage` do (`flowspec_tpu/parallel/pipeline.py:111-125`,
`:1188`): `exchange` (a send to one rank with a receive from another, the
`ppermute` hop), `broadcast` (the completed chunk, `all_gather(...)[p-1]`)
and `all_gather_ints` (a few host ints from every rank, the `psum` of the
chunk lengths). Each call is counted in `stats` by op: calls, payload bytes
(what this rank sends and receives; a gather's whole result) and host
seconds (staging copies included).
"""

from __future__ import annotations

import collections
import time

import torch

# the transport `init_multihost` chose for this process's world
_WORLD = {"host_staging": False}


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
    """A group of one rank a process: the `torch.distributed` world."""

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
        self.host_staging = _WORLD["host_staging"]
        self.stats = collections.defaultdict(lambda: [0, 0, 0.0])
        self._pinned = {}

    def _count(self, op: str, n_bytes: int, t0: float) -> None:
        st = self.stats[op]
        st[0] += 1
        st[1] += n_bytes
        st[2] += time.perf_counter() - t0

    def _check_device(self, x: torch.Tensor) -> None:
        if x.is_cuda and self.host_staging:
            return
        want = "nccl" if x.is_cuda else "gloo"
        if self.backend != want:
            raise ValueError(f"a {x.device.type} tensor needs the {want} "
                             f"backend, the group runs {self.backend} (CUDA "
                             "over gloo only through init_multihost(..., "
                             "host_staging=True))")

    def _one(self, parts) -> torch.Tensor:
        if len(parts) != 1:
            raise ValueError(f"a process of a DistGroup holds one rank, got "
                             f"{len(parts)} parts")
        self._check_device(parts[0])
        return parts[0]

    def _staged(self, x: torch.Tensor) -> bool:
        return x.is_cuda and self.host_staging

    def _pin(self, role, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer of `like`'s shape and dtype, one a role, kept
        for the next call of that shape."""
        key = (role, tuple(like.shape), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(
                like.shape, dtype=like.dtype, pin_memory=True)
        return buf

    def _wire(self, x: torch.Tensor, role="send") -> torch.Tensor:
        """What gloo / NCCL is handed for `x` (a pinned host copy when
        staged)."""
        x = x.contiguous()
        if not self._staged(x):
            return x
        buf = self._pin(role, x)
        buf.copy_(x)
        return buf

    def _empty(self, like: torch.Tensor, role="recv") -> torch.Tensor:
        """A buffer to receive `like` into: pinned and kept when staged,
        else a new tensor (what the caller gets back)."""
        return (self._pin(role, like) if self._staged(like) else
                torch.empty_like(like, memory_format=torch.contiguous_format))

    @staticmethod
    def _home(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return buf.to(like.device) if buf.device != like.device else buf

    def all_reduce(self, parts) -> torch.Tensor:
        import torch.distributed as dist
        x = self._one(parts)
        t0 = time.perf_counter()
        acc = x.float()
        acc = self._wire(acc) if self._staged(acc) else acc.clone()
        dist.all_reduce(acc)
        out = self._home(acc, x).to(x.dtype)
        self._count("all_reduce", acc.nbytes, t0)
        return out

    def all_gather(self, parts, dim: int = -1) -> torch.Tensor:
        import torch.distributed as dist
        x = self._one(parts)
        t0 = time.perf_counter()
        w = self._wire(x)
        out = [self._empty(x, ("gather", r)) for r in range(self.size)]
        dist.all_gather(out, w)
        got = self._home(torch.cat(out, dim=dim), x)
        self._count("all_gather", got.nbytes, t0)
        return got

    def ring_shift(self, parts, shift: int = 1) -> list:
        x = self._one(parts)
        return [self.exchange(x, (self.rank + shift) % self.size,
                              (self.rank - shift) % self.size)]

    def exchange(self, x: torch.Tensor | None, dst: int | None,
                 src: int | None, like: torch.Tensor | None = None):
        """Send `x` to rank `dst` and receive a tensor shaped as `like`
        (default `x`) from rank `src`, paired in one batch (gloo's
        point-to-point needs matching order; a batch cannot deadlock);
        either side may be None. Returns the received tensor (None without
        a receive)."""
        import torch.distributed as dist
        like = x if like is None else like
        t0 = time.perf_counter()
        ops, got, n = [], None, 0
        if dst is not None:
            self._check_device(x)
            w = self._wire(x)
            ops.append(dist.P2POp(dist.isend, w, dst))
            n += w.nbytes
        if src is not None:
            self._check_device(like)
            got = self._empty(like)
            ops.append(dist.P2POp(dist.irecv, got, src))
            n += got.nbytes
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if got is not None:
            got = self._home(got, like)
        self._count("exchange", n, t0)
        return got

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank `src`'s `x` on every rank; elsewhere `x` gives the shape
        and dtype. Returns a new tensor on non-src ranks."""
        import torch.distributed as dist
        self._check_device(x)
        t0 = time.perf_counter()
        buf = self._wire(x, "bcast") if self.rank == src \
            else self._empty(x, "bcast")
        dist.broadcast(buf, src)
        out = x if self.rank == src else self._home(buf, x)
        self._count("broadcast", buf.nbytes, t0)
        return out

    def all_gather_ints(self, vals) -> list:
        """Every rank's list of ints (each rank passes as many), in rank
        order: a gloo gather of host ints (on the card's device for NCCL)."""
        import torch.distributed as dist
        dev = "cuda" if self.backend == "nccl" else "cpu"
        t0 = time.perf_counter()
        x = torch.tensor([int(v) for v in vals], dtype=torch.int64,
                         device=dev)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x)
        got = [o.tolist() for o in out]
        self._count("all_gather_ints", x.nbytes * self.size, t0)
        return got
