"""expert_share_roofline: the bound of the expert products the traced
block served on this card (the bf16 weights of the held experts its rows
reached and of the shared expert, read once a forward; rows in and out
once; the routed pairs and the shared expert's rows computed; the
family's work, `run.dims.moe_bound_s`) over the device time of the
expert GEMMs (`moe_experts`), in percent: `moe_roofline`'s reading, for a
family whose MoE layers hold a share of the router's experts. What the
rows reached is the program's own count, the `moe.load` span that the
engine records at the end of each traced request (`runtime/engine.py`).
Where the program records none, it reads nothing."""


def read(run):
    t = run.trace.family_s.get("moe_experts")
    bound = run.dims.moe_bound_s(run.traced)
    return 100.0 * bound / t if t and bound is not None else None
