"""moe_roofline: the bound of the expert products the traced block served
(the bf16 weights of the experts reached, rows in and out once, each row
through its top-k experts; the family's work, `run.dims`) over the device
time of the expert GEMMs, in percent."""


def read(run):
    t = run.trace.family_s.get("moe_experts")
    bound = run.dims.moe_bound_s(run.traced)
    return 100.0 * bound / t if t and bound is not None else None
