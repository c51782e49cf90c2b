"""Pipelined speculative decoding (`flowspec_tpu/parallel/`): the
`PipelineEngine` with its P layer stages on one card. Tensor parallelism
(`tp.py`, `galaxy.py`, `mesh.py`) is not ported yet."""

from flowspec_tpu_torch.parallel.pipeline import (
    Flight, PipelineEngine, PipeState, RoundOut,
)

__all__ = ["Flight", "PipelineEngine", "PipeState", "RoundOut"]
