"""The one traffic generator: requests from a mix's parameters and a seed.

A mix (`traffic/<name>.json`) gives the prompt and answer lengths as
measured (`prompt_tokens`, `new_tokens`: lists of lengths; its "source"
says where from) and a block size B. Its B sizes are the lists' stratified
quantiles, (k + 1/2) / B for k < B, prompts and answers paired by one
fixed shuffle: every run serves the same set of sizes. The run's seed orders each block of B requests and draws
every token id, uniform over the vocabulary. One client sends a request
when the last one returned (a closed loop), every request is greedy and
runs its whole answer (the eos id never matches), and a window serves
whole blocks, so each window holds the mix's sizes in whole multiples.
A mix states nothing else: `check_mix` refuses a key the harness would
not act on.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class Request(NamedTuple):
    block: int
    size: int               # its pair's index in `sizes(mix)`
    prompt: list            # token ids
    max_new: int


MIX_KEYS = {"name", "why", "source", "block", "prompt_tokens", "new_tokens",
            "engine", "check"}


def check_mix(mix: dict) -> dict:
    """The mix, or ValueError where it sets a key the harness does not read
    or its lengths are not a list of whole numbers."""
    extra = set(mix) - MIX_KEYS
    if extra:
        raise ValueError(
            f"mix {mix.get('name')!r} sets {sorted(extra)}, which the "
            f"harness does not act on: it runs one client in a closed loop, "
            f"greedy, to each answer's full length")
    for key in ("prompt_tokens", "new_tokens"):
        vals = mix[key]
        if not (isinstance(vals, list) and vals
                and all(isinstance(v, int) and v > 0 for v in vals)):
            raise ValueError(f"mix {mix.get('name')!r}: {key} must be a "
                             f"list of lengths")
    return mix


def quantile(values: list, q: float) -> int:
    """The q-quantile of the lengths (the lower order statistic)."""
    vals = sorted(values)
    return vals[min(int(q * len(vals)), len(vals) - 1)]


def sizes(mix: dict) -> list:
    """The mix's B (prompt tokens, new tokens) pairs."""
    b = mix["block"]
    qs = [(k + 0.5) / b for k in range(b)]
    prompts = [quantile(mix["prompt_tokens"], q) for q in qs]
    news = [quantile(mix["new_tokens"], q) for q in qs]
    order = np.random.default_rng(0).permutation(b)
    return [(prompts[k], news[int(j)]) for k, j in enumerate(order)]


def requests(mix: dict, seed: int, vocab: int) -> Iterator[Request]:
    """The run's requests, block after block, without end."""
    rng = np.random.default_rng(seed)
    pairs = sizes(mix)
    block = 0
    while True:
        for k in rng.permutation(len(pairs)):
            p, n = pairs[int(k)]
            yield Request(block, int(k), rng.integers(0, vocab, p).tolist(),
                          n)
        block += 1


def traced(size: int) -> bool:
    """Whether a traced run profiles the requests of this size: every
    other one in the order of prompt length, the same half of the sizes
    whatever the seed (a whole block's trace took minutes to read)."""
    return size % 2 == 1


def warmup(mix: dict, depth_cap: int) -> list:
    """(prompt tokens, new tokens) of the set-up's warm requests: of the
    mix's sizes that start in one KV bucket, the one that grows farthest.
    A request starts in the smallest bucket that holds its prompt and
    `depth_cap` + 1 rows and grows bucket by bucket until one holds its
    answer too (`SpecEngine._plan_buckets`), so these serve every prefill
    bucket, decode graph and bucket growth the window meets, and no
    others."""
    eng = mix["engine"]
    full = eng["max_seq_len"]
    buckets = sorted({b for b in eng["kv_buckets"] if b <= full} | {full})
    farthest = {}
    for p, n in sizes(mix):
        start = next(b for b in buckets if b >= p + depth_cap + 1)
        if start not in farthest or p + n > sum(farthest[start]):
            farthest[start] = (p, n)
    return [farthest[b] for b in sorted(farthest)]
