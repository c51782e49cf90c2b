"""round_device_ms: the round graph's device ms a replay: the mean
`device_ms` of the program's `round` spans (CUDA events before and after
`graph.replay()`, `runtime/graphs.py DecodeGraph`) over the first block's
untraced requests (`lib/program_spans.py`)."""

from benchmark.lib import program_spans


def read(run):
    return program_spans.mean(program_spans.values(run, "round",
                                                   "device_ms"))
