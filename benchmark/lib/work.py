"""The work the served requests needed in the LLaMA-style families (a
LLaMA decoder with an optional Mixtral MLP; `Dims` is the default of a
family's `work` hook), reckoned from the configuration's shapes and what
each request served (prompt tokens, rounds, new tokens), never from a
kernel's grid, tiles or padding.

One request is an eager chunked prefill and then `rounds` speculative
rounds (`SpecEngine.generate_fused`):
- prefill chunk i of `prefill_chunk` tokens: the base forward over its
  valid rows after i * chunk committed ones, the lm_head on its last row,
  and the draft's context forward over the same pairs;
- round j: the draft's context forward over the pairs the last round
  accepted (none in round 0), the beam's `depth` levels of `top_k` rows
  each through the draft layer, `depth` + 1 head top-k calls (the root's
  one row, then `top_k` rows a level), and the verify: the base forward
  over the tree's `total_tokens` + 1 rows and the lm_head on all of them.
Row counts are valid rows: a call with none needs nothing. The committed
length at round j is reckoned as the prompt plus j times the request's
mean accepted tokens a round (the draft KV follows it one for one), so an
attention's keys are within one round's acceptance of the truth.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

from benchmark.lib.bounds import bound_s, int8_matmul_work


class Call(NamedTuple):
    rows: int     # valid query rows
    keys: int     # K / V rows its attention reads (earlier ones + its own)


@dataclasses.dataclass(frozen=True)
class Dims:
    hidden: int
    inter: int
    layers: int
    nq: int
    nkv: int
    head_dim: int
    vocab: int
    experts: int          # 0: a dense MLP
    experts_per_token: int
    base_int8: bool       # weight-only int8 decoder matmuls (else bf16)
    depth: int
    top_k: int
    tree_rows: int        # the verify's rows: total_tokens + 1
    chunk: int            # prefill chunk

    @classmethod
    def of(cls, cfg: dict, mix: dict) -> "Dims":
        tree = cfg["tree"]
        return cls(
            hidden=cfg["hidden_size"], inter=cfg["intermediate_size"],
            layers=cfg["num_hidden_layers"],
            nq=cfg["num_attention_heads"], nkv=cfg["num_key_value_heads"],
            head_dim=cfg.get("head_dim", cfg["hidden_size"]
                             // cfg["num_attention_heads"]),
            vocab=cfg["vocab_size"],
            experts=cfg.get("num_local_experts", 0),
            experts_per_token=cfg.get("num_experts_per_tok", 0),
            base_int8=cfg["weights"]["precision"] == "int8",
            depth=tree["depth"], top_k=tree["top_k"],
            tree_rows=tree["total_tokens"] + 1,
            chunk=mix["engine"]["prefill_chunk"])

    # what the readers ask of a family's work (`families/__init__.py`):
    # seconds, or None for a kernel the family does not launch
    def attention_bound_s(self, reqs) -> float:
        return attention_bound_s(reqs, self)

    def int8_bound_s(self, reqs) -> float:
        return int8_bound_s(reqs, self)

    def head_bound_s(self, reqs) -> float:
        return head_bound_s(reqs, self)

    def moe_bound_s(self, reqs) -> float | None:
        return moe_bound_s(reqs, self) if self.experts else None

    def model_flops(self, reqs) -> float:
        return model_flops(reqs, self)

    def attn_products(self, width: int) -> list:
        """(In, Out) of q, k, v and o at model width `width`."""
        q, kv = self.nq * self.head_dim, self.nkv * self.head_dim
        return [(width, q), (width, kv), (width, kv), (q, width)]

    def mlp_products(self) -> list:
        h, i = self.hidden, self.inter
        return [(h, i), (h, i), (i, h)]

    def draft_products(self) -> list:
        """The draft's int8 products: fc (2H -> H), then its layer's."""
        return ([(2 * self.hidden, self.hidden)]
                + self.attn_products(self.hidden) + self.mlp_products())


def _chunks(p: int, c: int) -> Iterator[Call]:
    for start in range(0, p, c):
        rows = min(c, p - start)
        yield Call(rows, start + rows)


def _commits(req, d: Dims) -> Iterator[float]:
    per_round = req.new_tokens / max(req.rounds, 1)
    for j in range(req.rounds):
        yield req.prompt_len + j * per_round


def base_calls(req, d: Dims) -> Iterator[Call]:
    """Each base forward of `req`: its prefill chunks, then its verifies."""
    yield from _chunks(req.prompt_len, d.chunk)
    for c in _commits(req, d):
        yield Call(d.tree_rows, int(c) + d.tree_rows)


def draft_calls(req, d: Dims) -> Iterator[Call]:
    """Each draft-layer forward of `req`: the prefill's context forwards,
    then a round's context forward and beam levels."""
    yield from _chunks(req.prompt_len, d.chunk)
    accepted = req.new_tokens / max(req.rounds, 1)
    for j, c in enumerate(_commits(req, d)):
        if j:
            rows = max(1, round(accepted))
            yield Call(rows, int(c))
        for lv in range(d.depth):
            yield Call(d.top_k, int(c) + d.top_k * (lv + 1))


def head_rows(req, d: Dims) -> Iterator[int]:
    """The rows of each head top-k call of `req`."""
    for _ in range(req.rounds):
        yield 1
        yield from [d.top_k] * d.depth


def lm_head_rows(req, d: Dims) -> int:
    return -(-req.prompt_len // d.chunk) + req.rounds * d.tree_rows


# ---- per-kernel bounds (seconds) ----------------------------------------

def attention_work(call: Call, d: Dims) -> tuple:
    """K and V rows up to the call's keys, q and out once (bf16); every
    query row against every key row read."""
    kv = 2 * call.keys * d.nkv * d.head_dim * 2
    qo = 2 * call.rows * d.nq * d.head_dim * 2
    return kv + qo, 4.0 * call.rows * call.keys * d.nq * d.head_dim


def attention_bound_s(reqs, d: Dims) -> float:
    t = 0.0
    for r in reqs:
        t += d.layers * sum(bound_s(*attention_work(c, d))
                            for c in base_calls(r, d) if c.rows)
        t += sum(bound_s(*attention_work(c, d))
                 for c in draft_calls(r, d) if c.rows)
    return t


def int8_bound_s(reqs, d: Dims) -> float:
    """Every int8 product served: the base's decoder matmuls when they are
    int8, and the draft's."""
    def products(rows, shapes):
        return sum(bound_s(*int8_matmul_work(rows, i, o)) for i, o in shapes)
    base = d.attn_products(d.hidden) + d.mlp_products()
    t = 0.0
    for r in reqs:
        if d.base_int8:
            t += d.layers * sum(products(c.rows, base)
                                for c in base_calls(r, d) if c.rows)
        t += sum(products(c.rows, d.draft_products())
                 for c in draft_calls(r, d) if c.rows)
    return t


def head_bound_s(reqs, d: Dims) -> float:
    """The beam's int8 head (H, V) with its column scales read once a
    call, the call's bf16 rows once."""
    h, v = d.hidden, d.vocab
    return sum(bound_s(h * v + 4 * v + rows * h * 2, 2.0 * rows * h * v)
               for r in reqs for rows in head_rows(r, d))


def moe_bound_s(reqs, d: Dims) -> float:
    """Each base forward's expert products, a layer at a time: the bf16
    weights of the experts its rows reach (every expert: a forward routes
    64 or more rows to its top-k, and the last prefill chunk's few valid
    rows are counted alike), the rows in and out once, and the products of
    each row with its top-k experts only."""
    if not d.experts:
        return 0.0
    h, i = d.hidden, d.inter
    w_bytes = d.experts * 3 * h * i * 2
    return sum(d.layers * bound_s(w_bytes + 2 * c.rows * h * 2,
                                  2.0 * c.rows * d.experts_per_token
                                  * 3 * h * i)
               for r in reqs for c in base_calls(r, d) if c.rows)


# ---- model FLOPs served ---------------------------------------------------

def model_flops(reqs, d: Dims) -> float:
    """The base forward over every prefill token and verified tree row,
    the lm_head on the rows it scores, the draft layer over its rows with
    the beam's head calls, and attention over the keys each call reads."""
    h = d.hidden

    def per_row(shapes):
        return sum(2.0 * i * o for i, o in shapes)

    mlp = (d.experts_per_token * per_row(d.mlp_products()) + 2.0 * h * d.experts
           if d.experts else per_row(d.mlp_products()))
    base_row = d.layers * (per_row(d.attn_products(h)) + mlp)
    draft_row = per_row(d.draft_products())
    head = 2.0 * h * d.vocab
    f = 0.0
    for r in reqs:
        for c in base_calls(r, d):
            f += c.rows * base_row + d.layers * attention_work(c, d)[1]
        for c in draft_calls(r, d):
            f += c.rows * draft_row + attention_work(c, d)[1]
        f += head * (lm_head_rows(r, d) + sum(head_rows(r, d)))
    return f
