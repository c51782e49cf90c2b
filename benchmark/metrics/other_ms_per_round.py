"""other_ms_per_round: device ms of the kernels of no named family (the
round's bookkeeping, tree building, norms, rope, biases, the eager
prefill's small ops) over the traced block, per speculative round."""


def read(run):
    rounds = sum(r.rounds for r in run.traced)
    other = run.trace.family_s.get("other")
    return other * 1e3 / rounds if rounds and other else None
