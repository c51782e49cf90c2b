"""round_gap_us: the device's idle between two rounds of a segment, in
microseconds: the mean `gap_ms` of the program's `round` spans (from the
previous round graph's end event to this one's start event: the host's
sync, read, loop test and launch, `runtime/graphs.py _run`) over the first
block's untraced requests (`lib/program_spans.py`). A segment's first
round has none."""

from benchmark.lib import program_spans


def read(run):
    gaps = program_spans.values(run, "round", "gap_ms")
    return 1e3 * program_spans.mean(gaps) if gaps else None
