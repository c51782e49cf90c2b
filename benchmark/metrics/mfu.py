"""mfu: the model FLOPs that the traced run's untraced blocks served (base
forward over every prefill token and verified tree row, the lm_head on the
rows it scored, the draft layer and the beam's head, attention over the
keys each call read; `benchmark/lib/work.py`) over their host seconds,
from the first one's start to the last one's return, and the card's dense
bf16 peak, in percent. It reads no trace: the profiler stretches the
traced requests."""

from benchmark.lib.bounds import BF16_FLOPS_PER_S
from benchmark.lib.work import model_flops


def read(run):
    later = [r for r in run.requests if r.block >= 1]
    if not later:
        return None
    wall = later[-1].t1 - later[0].t0
    return 100.0 * model_flops(later, run.dims) / (wall * BF16_FLOPS_PER_S)
