"""tok_s: the new tokens of every request of the window over the window's
seconds (host clock, from the first request's start to the last one's
return)."""


def read(run):
    return sum(r.new_tokens for r in run.requests) / run.window_s
