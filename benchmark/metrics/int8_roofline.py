"""int8_roofline: the bound of every int8 product the traced block served
(weights and column scales once, x and y once, 2 M In Out operations; the
family's work, `run.dims`) over the device time of the int8 dequant-matmul
and its split-K reduce pass, in percent."""


def read(run):
    fam = run.trace.family_s
    t = fam.get("int8_matmul", 0.0) + fam.get("matmul_reduce", 0.0)
    bound = run.dims.int8_bound_s(run.traced)
    return 100.0 * bound / t if t and bound is not None else None
