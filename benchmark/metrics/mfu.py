"""mfu: the model FLOPs that the traced run's untraced blocks served (base
forward over every prefill token and verified tree row, the lm_head on the
rows it scored, the draft layer and the beam's head, attention over the
keys each call read; the family's work, `run.dims`) over their host
seconds, from the first one's start to the last one's return, and the
card's dense bf16 peak, in percent. It reads no trace: the profiler
stretches the traced requests."""

from benchmark.lib.bounds import BF16_FLOPS_PER_S


def read(run):
    later = [r for r in run.requests if r.block >= 1]
    if not later:
        return None
    wall = later[-1].t1 - later[0].t0
    flops = run.dims.model_flops(later)
    return (100.0 * flops / (wall * BF16_FLOPS_PER_S) if flops is not None
            else None)
