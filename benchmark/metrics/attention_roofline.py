"""attention_roofline: the bound of every tree-attention launch the traced
block served (K and V rows up to its keys, q and out once, every query
against every key read) over the device time of the tree-attention
kernel, in percent."""

from benchmark.lib.work import attention_bound_s


def read(run):
    t = run.trace.family_s.get("tree_attention")
    return 100.0 * attention_bound_s(run.traced, run.dims) / t if t else None
