"""attention_roofline: the bound of every tree-attention launch the traced
block served (K and V rows up to its keys, q and out once, every query
against every key read; the family's work, `run.dims`) over the device
time of the tree-attention kernel, in percent."""


def read(run):
    t = run.trace.family_s.get("tree_attention")
    bound = run.dims.attention_bound_s(run.traced)
    return 100.0 * bound / t if t and bound is not None else None
