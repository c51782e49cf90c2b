"""accept_per_round: tokens served a speculative round, summed over the
window's requests (`generate_fused`'s own counts). With random weights the
draft rarely guesses the base, so this sits near 1: not a user's."""


def read(run):
    rounds = sum(r.rounds for r in run.requests)
    return sum(r.new_tokens for r in run.requests) / rounds if rounds else None
