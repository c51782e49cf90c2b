"""ms_per_token_p95: the 95th percentile (inclusive, linear between order
statistics) over the window's requests of a request's wall time (prefill
included, host clock) over its new tokens."""

import statistics


def read(run):
    per = [(r.t1 - r.t0) * 1e3 / r.new_tokens for r in run.requests
           if r.new_tokens]
    if len(per) < 2:
        return None
    return statistics.quantiles(per, n=20, method="inclusive")[18]
