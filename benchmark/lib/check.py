"""The output check that decides `correct`.

Once the window has closed and the program's state is freed, a sample of
the window's finished requests, drawn from the seed, goes to the plain
reference: the longest request (prompt and answer together), then others
in the seed's order until `check.served_tokens` served tokens are in it.
The reference runs once over each sampled prompt with its served tokens,
and at each served token reads the gap by which that token's logit lies
below the reference's best at its position. Every request is greedy, so a
sound program serves tokens with no gap but where its bf16 arithmetic
meets a near tie.

The numbers, of which `limits/<cell>.json` names those a cell compares,
each with its limit:
- `max_gap`: the widest gap;
- `decided_mean_gap`: the mean gap over the served tokens whose position
  every MoE layer of the reference routes by a margin (its k-th router
  logit less the next) of at least the file's `router_margin`. Where a
  router's k-th and next experts lie within bf16's rounding, bf16 and
  float32 pick different experts and the token's logits move by O(1)
  logit: a plain bf16 forward reads as wide a gap there as the program;
- `failed`: requests that raised; `short`: requests that served fewer
  tokens than they asked for (the eos id never matches).
"""

from __future__ import annotations

import numpy as np
import torch


def sample(reqs, seed: int, served_tokens: int) -> list:
    """Indices into `reqs` (finished requests with `prompt`, `tokens`):
    the longest, then others in the seed's order up to `served_tokens`."""
    order = [int(i) for i in np.random.default_rng(seed + 1).permutation(
        len(reqs))]
    longest = max(range(len(reqs)),
                  key=lambda i: (len(reqs[i].prompt) + len(reqs[i].tokens),
                                 -i))
    picked, n = [], 0
    for i in [longest] + [i for i in order if i != longest]:
        if n >= served_tokens:
            break
        picked.append(i)
        n += len(reqs[i].tokens)
    return picked


def sequences(reqs, device):
    """(token sequences, rows): each prompt with its served tokens, and the
    positions whose next-token logits judge the served tokens."""
    seqs, rows = [], []
    for r in reqs:
        toks = list(r.prompt) + list(r.tokens)
        seqs.append(torch.tensor(toks, dtype=torch.long, device=device))
        p = len(r.prompt)
        rows.append(torch.arange(p - 1, p - 1 + len(r.tokens), device=device))
    return seqs, rows


def gaps(logits, tokens) -> torch.Tensor:
    """Per served token: best logit minus the served token's logit."""
    t = torch.as_tensor(tokens, dtype=torch.long, device=logits.device)
    return logits.max(-1).values - logits.gather(-1, t[:, None])[:, 0]


def numbers(logits, tokens, margins, router_margin=None) -> dict:
    """`max_gap` and `decided_mean_gap` of the served `tokens` under the
    reference's `logits` (per request), with the reference's smallest
    router margin per served position (`margins`)."""
    g = torch.cat([gaps(lg, t) for lg, t in zip(logits, tokens)])
    out = {"max_gap": float(g.max())}
    if router_margin is not None:
        sel = g[torch.cat(list(margins)) >= router_margin]
        out["decided_mean_gap"] = (float(sel.mean()) if sel.numel()
                                   else float("inf"))
        out["decided_tokens"] = int(sel.numel())
    return out


def compare(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number that has a limit
    at or under it."""
    out = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return all(numbers[k] <= v for k, v in limits.items()), out
