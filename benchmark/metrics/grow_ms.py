"""grow_ms: a KV bucket growth's device ms: the mean `device_ms` of the
program's `grow_kv` spans (CUDA events around `runtime/engine.py _grow_kv`)
over the first block's untraced requests (`lib/program_spans.py`)."""

from benchmark.lib import program_spans


def read(run):
    return program_spans.mean(program_spans.values(run, "grow_kv",
                                                   "device_ms"))
