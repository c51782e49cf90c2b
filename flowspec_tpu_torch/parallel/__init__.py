"""Distributed runtime (`flowspec_tpu/parallel/`): the `PipelineEngine`
with its P layer stages in one process, tensor parallelism (`TPEngine`,
the megatron layout of `tp.py`, the galaxy rings of `galaxy.py`, PP x TP
on a (stage, tp) mesh) over one collectives interface (`comm.py`),
in-process or over `torch.distributed`, and the meshes (`mesh.py`)."""

from flowspec_tpu_torch.parallel.mesh import (
    Mesh, init_multihost, put_global, stage_mesh, stage_tp_mesh, tp_mesh,
)
from flowspec_tpu_torch.parallel.pipeline import (
    Flight, PipelineEngine, PipeState, RoundOut,
)
from flowspec_tpu_torch.parallel.tp import (
    TPDraft, TPEngine, TPParams, shard_draft_tp, shard_params_tp,
)

__all__ = ["Flight", "Mesh", "PipelineEngine", "PipeState", "RoundOut",
           "TPDraft", "TPEngine", "TPParams", "init_multihost",
           "put_global", "shard_draft_tp", "shard_params_tp", "stage_mesh",
           "stage_tp_mesh", "tp_mesh"]
