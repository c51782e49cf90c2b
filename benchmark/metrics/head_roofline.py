"""head_roofline: the bound of every head top-k call the traced block
served (the beam's int8 head and its scales read once a call) over the
device time of the head kernel and its select pass, in percent."""

from benchmark.lib.work import head_bound_s


def read(run):
    fam = run.trace.family_s
    t = fam.get("head_topk", 0.0) + fam.get("head_select", 0.0)
    return 100.0 * head_bound_s(run.traced, run.dims) / t if t else None
