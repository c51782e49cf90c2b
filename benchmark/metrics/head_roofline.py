"""head_roofline: the bound of every head top-k call the traced block
served (the beam's int8 head and its scales read once a call; the
family's work, `run.dims`) over the device time of the head kernel and its
select pass, in percent."""


def read(run):
    fam = run.trace.family_s
    t = fam.get("head_topk", 0.0) + fam.get("head_select", 0.0)
    bound = run.dims.head_bound_s(run.traced)
    return 100.0 * bound / t if t and bound is not None else None
