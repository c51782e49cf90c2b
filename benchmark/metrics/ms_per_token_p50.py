"""ms_per_token_p50: the median over the window's requests of a request's
wall time (prefill included, host clock) over its new tokens."""

import statistics


def read(run):
    per = [(r.t1 - r.t0) * 1e3 / r.new_tokens for r in run.requests
           if r.new_tokens]
    return statistics.median(per) if per else None
