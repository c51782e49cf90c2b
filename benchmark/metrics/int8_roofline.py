"""int8_roofline: the bound of every int8 product the traced block served
(weights and column scales once, x and y once, 2 M In Out operations;
`benchmark/lib/work.py`) over the device time of the int8 dequant-matmul
and its split-K reduce pass, in percent."""

from benchmark.lib.work import int8_bound_s


def read(run):
    fam = run.trace.family_s
    t = fam.get("int8_matmul", 0.0) + fam.get("matmul_reduce", 0.0)
    return 100.0 * int8_bound_s(run.traced, run.dims) / t if t else None
