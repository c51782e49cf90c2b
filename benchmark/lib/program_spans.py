"""The port's own spans, for the metrics that read them (`metrics/`
`round_device_ms`, `round_gap_us`, `prefill_ms_per_chunk`, `grow_ms`,
`capture_s`).

The port records spans at its layer boundaries into
`flowspec_tpu_torch.utils.profiler.prof` once `prof.enabled` is set: a
`request` span around each `generate_fused` call and, inside it,
`prefill.chunk`, `prefill.finish`, `grow_kv`, `segment.load`, `round` and
`segment.read`; `capture` and `kernel_build` wherever they happen. Times
are `time.time_ns()`, the clock of the harness's `Served.ns0` / `ns1`. On
the card `round` spans carry the graph's `device_ms` and the device's idle
since the previous round, `gap_ms`; `prefill.finish` the device ms from the
first chunk's start to its own end; `grow_kv` the growth's.

Nothing here turns the recorder on: the harness is to do that in a traced
run, from the start of set-up to the end of the first block. Until it
does, and in a program without the recorder, there are no spans and these
readers read None.

The readers read the first block's untraced requests (`traffic.traced`),
each through the program's one `request` span inside its `ns0` .. `ns1`.
"""

from __future__ import annotations

from benchmark.lib import traffic


def spans() -> list:
    """The recorder's spans (none in a program without one)."""
    from flowspec_tpu_torch.utils.profiler import prof
    return list(getattr(prof, "spans", None) or [])


def requests(run) -> list:
    """Per request of the first block's untraced ones that has exactly one
    program `request` span inside it, the spans of that request."""
    every = spans()
    heads = [s for s in every if s.name == "request"]
    by = {}
    for s in every:
        by.setdefault(s.request, []).append(s)
    out = []
    for r in run.requests:
        if r.block != 0 or traffic.traced(r.size) or r.failed:
            continue
        inside = [h for h in heads if r.ns0 <= h.t0_ns and h.t1_ns <= r.ns1]
        if len(inside) == 1:
            out.append(by[inside[0].request])
    return out


def values(run, name: str, field: str) -> list:
    """The `field` of every `name` span of those requests that has one."""
    return [getattr(s, field) for req in requests(run) for s in req
            if s.name == name and getattr(s, field) is not None]


def mean(xs: list):
    return sum(xs) / len(xs) if xs else None
