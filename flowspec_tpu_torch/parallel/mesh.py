"""Meshes: the layout of pipeline stages and tensor-parallel ranks.

Port of `flowspec_tpu/parallel/mesh.py`. A JAX `Mesh` names device axes and
the compiler places shards on them; here a `Mesh` names the same axes
(`stage`, `tp`, with `tp` the minor axis as in `:46-60`) and carries the
groups whose collectives the engines call (`parallel/comm.py`):

- in-process (the default): every rank's shards and every stage in this
  process, on one card or on the CPU, the collectives memory operations;
- distributed, after `init_multihost`: a `tp_mesh` puts one TP rank in each
  process of the `torch.distributed` world; a `stage_mesh` or
  `stage_tp_mesh` puts one contiguous block of p / world stages in each
  process (rank r holds stages [r * p / world, (r + 1) * p / world)), the
  stage ring (`Mesh.stages`, a `DistGroup`) crossing processes and a
  `stage_tp_mesh`'s TP group staying inside each process, as the JAX
  dryrun's `Mesh(devices.reshape(4, 2), ("stage", "tp"))` keeps each TP
  pair on one host (`tools/multihost_dryrun.py`).

`put_global` is the per-host loading pattern of `:71-92`: each rank slices
its own shard from the host value.
"""

from __future__ import annotations

import datetime

import torch

from flowspec_tpu_torch.parallel import comm
from flowspec_tpu_torch.parallel.comm import DistGroup, InProcessGroup


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device=None, host_staging: bool = False,
                   timeout: float | None = None) -> None:
    """Join this process to the `torch.distributed` world: the analogue of
    `jax.distributed.initialize` and of the reference's master_addr /
    nnodes flags. `coordinator` is "host:port" of rank 0 (a TCP init
    method), `num_processes` the world size, `process_id` this rank. The
    backend follows `device` (default `cuda`): NCCL for a CUDA device, gloo
    for the CPU. `host_staging=True` (a CUDA device only) runs gloo and
    carries CUDA tensors through pinned host buffers: processes that share
    one card, where NCCL refuses two ranks, talk only so. `timeout`
    (seconds) bounds every collective: a rank whose peers never join one
    raises when it ends."""
    import torch.distributed as dist
    dev = torch.device(device if device is not None else "cuda")
    if host_staging and dev.type != "cuda":
        raise ValueError("host_staging carries CUDA tensors; the device is "
                         f"{dev}")
    backend = "nccl" if dev.type == "cuda" and not host_staging else "gloo"
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    comm._WORLD["host_staging"] = host_staging


class Mesh:
    """Named axes and their sizes (`shape`, as a JAX mesh's), the TP group
    of the `tp` axis (None without one; in-process every stage's TP group is
    the same group of `tp` ranks) and the stage ring across processes
    (`stages`, a `DistGroup`; None when every stage is in this process)."""

    def __init__(self, axis_names: tuple, sizes: tuple, group=None,
                 stages=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.group = group
        self.stages = stages

    @property
    def distributed(self) -> bool:
        return self.stages is not None or bool(
            self.group is not None and self.group.distributed)

    def stage_block(self) -> tuple:
        """[lo, hi) of the stages this process holds."""
        p = self.shape["stage"]
        if self.stages is None:
            return 0, p
        b = p // self.stages.size
        return self.stages.rank * b, (self.stages.rank + 1) * b

    def __repr__(self):
        kind = "distributed" if self.distributed else "in-process"
        return f"Mesh({self.shape}, {kind})"


def _tp_group(tp: int, distributed: bool):
    if not distributed:
        return InProcessGroup(tp)
    group = DistGroup()
    if group.size != tp:
        raise ValueError(f"a distributed tp {tp} needs a world of {tp} "
                         f"processes, got {group.size}")
    return group


def _stage_ring(num_stages: int, distributed: bool):
    if num_stages < 1:
        raise ValueError(f"a stage mesh needs >= 1 stage, got {num_stages}")
    if not distributed:
        return None
    ring = DistGroup()
    if num_stages % ring.size:
        raise ValueError(f"{num_stages} stages do not split over a world of "
                         f"{ring.size} processes")
    return ring


def tp_mesh(tp: int, distributed: bool = False) -> Mesh:
    """A 1-D `tp` mesh: in-process, or one rank a process of the
    `torch.distributed` world (`init_multihost` first)."""
    return Mesh(("tp",), (tp,), _tp_group(tp, distributed))


def stage_mesh(num_stages: int, distributed: bool = False) -> Mesh:
    """A 1-D pipeline mesh: every stage in this process, or (distributed,
    `init_multihost` first) a block of num_stages / world stages a process
    of the world; a world that does not divide the stages raises."""
    return Mesh(("stage",), (num_stages,),
                stages=_stage_ring(num_stages, distributed))


def stage_tp_mesh(num_stages: int, tp: int, distributed: bool = False) -> Mesh:
    """A (stage, tp) mesh, tp the minor axis: the layers pipeline over
    `stage`, each stage's heads / MLP columns / experts shard over `tp`.
    Distributed, each process holds a block of stages as `stage_mesh`
    does, with an in-process TP group of `tp` ranks: the stage ring crosses
    processes, the TP ranks do not."""
    return Mesh(("stage", "tp"), (num_stages, tp), InProcessGroup(tp),
                stages=_stage_ring(num_stages, distributed))


def put_global(x: torch.Tensor, group, dim: int | None = None) -> list:
    """This process's shards of the host value `x`, one a local rank of
    `group`: rank r's is slice r of `size` equal slices along `dim`, a
    contiguous copy (the shard does not keep `x` alive); with `dim` None
    the value is replicated and every rank holds `x` itself."""
    if dim is None:
        return [x for _ in group.ranks]
    n = x.shape[dim]
    if n % group.size:
        raise ValueError(f"axis {dim} of size {n} does not split over "
                         f"{group.size} ranks")
    w = n // group.size
    return [x.narrow(dim, r * w, w).clone(
        memory_format=torch.contiguous_format) for r in group.ranks]
