"""capture_s: the set-up's seconds in graph captures: the sum of the
program's `capture` spans (`runtime/graphs.py DecodeGraph`: warm-up body
and capture) between the set-up's start and the window's first request,
less the `kernel_build` spans inside them (a checkout's first run builds
kernels at their first launch, some in a capture's warm-up body)
(`lib/program_spans.py`)."""

from benchmark.lib import program_spans


def read(run):
    every = program_spans.spans()
    if not every or not run.requests:
        return None
    hi = run.requests[0].ns0
    lo = hi - run.setup_s * 1e9
    caps = [s for s in every if s.name == "capture"
            and lo <= s.t0_ns and s.t1_ns <= hi]
    if not caps:
        return None
    builds = [s for s in every if s.name == "kernel_build"
              and any(c.t0_ns <= s.t0_ns and s.t1_ns <= c.t1_ns
                      for c in caps)]
    return (sum(s.t1_ns - s.t0_ns for s in caps)
            - sum(s.t1_ns - s.t0_ns for s in builds)) / 1e9
