"""Meshes: the layout of pipeline stages and tensor-parallel ranks.

Port of `flowspec_tpu/parallel/mesh.py`. A JAX `Mesh` names device axes and
the compiler places shards on them; here a `Mesh` names the same axes
(`stage`, `tp`, with `tp` the minor axis as in `:46-60`) and carries the TP
group whose collectives the engines call (`parallel/comm.py`):

- in-process (the default): every rank's shards in this process, on one
  card or on the CPU, the collectives memory operations;
- distributed: one TP rank a process over `torch.distributed`, after
  `init_multihost`. Every pipeline stage stays in one process: a stage per
  process is not ported, so a distributed mesh has no `stage` axis.

`put_global` is the per-host loading pattern of `:71-92`: each rank slices
its own shard from the host value.
"""

from __future__ import annotations

import torch

from flowspec_tpu_torch.parallel.comm import DistGroup, InProcessGroup


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device=None) -> None:
    """Join this process to the `torch.distributed` world: the analogue of
    `jax.distributed.initialize` and of the reference's master_addr /
    nnodes flags. `coordinator` is "host:port" of rank 0 (a TCP init
    method), `num_processes` the world size, `process_id` this rank. The
    backend follows `device` (default `cuda`): NCCL for a CUDA device, gloo
    for the CPU."""
    import torch.distributed as dist
    dev = torch.device(device if device is not None else "cuda")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


class Mesh:
    """Named axes and their sizes (`shape`, as a JAX mesh's), and the TP
    group of the `tp` axis (None without one). In-process every stage's
    TP group is the same group of `tp` ranks."""

    def __init__(self, axis_names: tuple, sizes: tuple, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.group = group

    @property
    def distributed(self) -> bool:
        return bool(self.group is not None and self.group.distributed)

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


def tp_mesh(tp: int, distributed: bool = False) -> Mesh:
    """A 1-D `tp` mesh: in-process, or one rank a process of the
    `torch.distributed` world (`init_multihost` first)."""
    return Mesh(("tp",), (tp,), _tp_group(tp, distributed))


def stage_mesh(num_stages: int) -> Mesh:
    """A 1-D pipeline mesh; its stages run in this process."""
    if num_stages < 1:
        raise ValueError(f"stage_mesh needs >= 1 stage, got {num_stages}")
    return Mesh(("stage",), (num_stages,))


def stage_tp_mesh(num_stages: int, tp: int) -> Mesh:
    """A (stage, tp) mesh, tp the minor axis: the layers pipeline over
    `stage`, each stage's heads / MLP columns / experts shard over `tp`.
    In-process only (a stage per process is not ported)."""
    if num_stages < 1:
        raise ValueError(f"stage_tp_mesh needs >= 1 stage, got {num_stages}")
    return Mesh(("stage", "tp"), (num_stages, tp), InProcessGroup(tp))


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
