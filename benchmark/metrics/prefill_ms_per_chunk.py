"""prefill_ms_per_chunk: the eager chunked prefill's device ms a chunk:
over the first block's untraced requests, the sum of the program's
`prefill.finish` spans' `device_ms` (a CUDA event before the first chunk
to one after the finish, `runtime/engine.py SpecEngine.prefill`) over the
sum of their `prefill.chunk` spans (`lib/program_spans.py`)."""

from benchmark.lib import program_spans


def read(run):
    ms = chunks = 0
    for req in program_spans.requests(run):
        done = [s.device_ms for s in req if s.name == "prefill.finish"
                and s.device_ms is not None]
        if done:
            ms += sum(done)
            chunks += sum(s.name == "prefill.chunk" for s in req)
    return ms / chunks if chunks else None
