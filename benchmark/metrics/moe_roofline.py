"""moe_roofline: the bound of the expert products the traced block served
(the bf16 weights of the experts reached, rows in and out once, each row
through its top-k experts) over the device time of the expert GEMMs, in
percent."""

from benchmark.lib.work import moe_bound_s


def read(run):
    t = run.trace.family_s.get("moe_experts")
    return 100.0 * moe_bound_s(run.traced, run.dims) / t if t else None
