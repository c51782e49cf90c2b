"""Evaluation harness: dataset sweeps with throughput/acceptance metrics.

Port of `flowspec_tpu/eval/harness.py`, with its semantics: the same
multi-turn loop, longest-common-prefix resume, serving eval and length
sweep over the port's engines. Timing is `time.perf_counter` around each
call, as in the JAX package; the port's engines return host lists, so on
the card a span includes the device's work. One addition to a serving
row, so that an eviction from the capped ConversationStore shows: a turn
>= 2 row carries `cold` (questions - resumed) beside `resumed`.

Reference: eval/run_pipe_eval.py — iterates temperatures x pipeline_types x
datasets x questions, multi-turn conversations, measures per-question decode
time, and reports throughput = sum(tokens)/sum(time), average latency, and
mean accepted length per round/turn (:340-360). Dataset files are jsonl with
{"question_id": ..., "turns": [str, ...]} (ref data/*/question.jsonl).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from flowspec_tpu_torch.utils.chat import build_prompt


@dataclasses.dataclass
class EvalResult:
    name: str
    total_new_tokens: int = 0
    total_decode_s: float = 0.0
    total_rounds: int = 0
    total_turns: int = 0
    n_questions: int = 0
    n_conv_turns: int = 0
    resume_hits: int = 0     # turns continued via KV reuse (engine resume)

    @property
    def throughput(self) -> float:
        return self.total_new_tokens / max(self.total_decode_s, 1e-9)

    @property
    def avg_latency(self) -> float:
        return self.total_decode_s / max(self.n_questions, 1)

    @property
    def accept_per_round(self):
        """None only for engines that don't report rounds at all (every
        in-repo engine now does — the fused pipeline loop counts them
        on-device since r3)."""
        if self.total_rounds <= 0:
            return None
        return self.total_new_tokens / self.total_rounds

    @property
    def accept_per_turn(self) -> float:
        return self.total_new_tokens / max(self.total_turns, 1)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "questions": self.n_questions,
            "conversation_turns": self.n_conv_turns,
            "new_tokens": self.total_new_tokens,
            "throughput_tok_s": round(self.throughput, 3),
            "avg_latency_s": round(self.avg_latency, 3),
            "accept_per_round": (None if self.accept_per_round is None
                                 else round(self.accept_per_round, 3)),
            "accept_per_turn": round(self.accept_per_turn, 3),
            "resume_hits": self.resume_hits,
        }


def load_questions(path: str, limit: Optional[int] = None) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
            if limit and len(out) >= limit:
                break
    return out


def run_eval(
    generate: Callable,            # (prompt_tokens) -> (tokens, stats)
    tokenize: Callable[[str], Sequence[int]],
    detokenize: Callable[[Sequence[int]], str],
    questions: List[dict],
    name: str = "eval",
    template: str = "vicuna",
    max_turns: int = 2,
    results_path: Optional[str] = None,
    engine=None,
    resume: bool = False,
    max_new_tokens: Optional[int] = None,
    eos_token_id: int = -1,
) -> EvalResult:
    """Multi-turn loop mirroring run_pipe_eval.py:200-320: each turn's
    generated answer is appended to the conversation before the next turn.

    With `engine` + `resume=True`, turn N rolls the kept engine state back
    to the longest common token prefix of the new prompt and turn N-1's
    output, then prefills ONLY the suffix via `resume_and_generate` —
    committed KV row i holds stream token i, so any shared prefix is
    reusable even when the chat template re-punctuates the boundary (the
    vicuna template inserts a space before the recorded answer) or a BPE
    tokenizer re-merges across it. The reference re-prefills the whole
    conversation every turn (eval/run_pipe_eval.py:200-320)."""
    res = EvalResult(name=name)
    for q in questions:
        convo: List[tuple] = []
        state = None
        prev_out: Optional[list] = None
        for turn_text in q.get("turns", [])[:max_turns]:
            convo.append((turn_text, None))
            prompt = build_prompt(convo, template=template)
            tokens = [int(t) for t in tokenize(prompt)]
            t0 = time.perf_counter()
            if engine is not None and resume:
                lcp = 0
                if state is not None:
                    prev = [int(t) for t in prev_out]
                    m = min(len(tokens) - 1, len(prev))
                    while lcp < m and tokens[lcp] == prev[lcp]:
                        lcp += 1
                if lcp >= 2:
                    out, stats, state = engine.resume_and_generate(
                        state, tokens[:lcp], tokens[lcp:],
                        max_new_tokens=max_new_tokens,
                        eos_token_id=eos_token_id, return_state=True)
                    res.resume_hits += 1
                else:
                    out, stats, state = engine.generate(
                        tokens, max_new_tokens=max_new_tokens,
                        eos_token_id=eos_token_id, return_state=True)
                prev_out = out
            else:
                out, stats = generate(tokens)
            dt = time.perf_counter() - t0
            answer_tokens = out[len(tokens):]
            answer = detokenize(answer_tokens)
            convo[-1] = (turn_text, answer)

            res.total_new_tokens += stats.get("new_tokens",
                                              len(answer_tokens))
            res.total_decode_s += dt
            res.total_rounds += max(stats.get("rounds", 0), 0)
            res.total_turns += stats.get("turns", stats.get("rounds", 0))
            res.n_conv_turns += 1
        res.n_questions += 1
    if results_path:
        with open(results_path, "a") as f:
            f.write(json.dumps(res.summary()) + "\n")
    return res


def run_eval_serve(engine, tokenize: Callable[[str], Sequence[int]],
                   questions: List[dict], name: str = "serve",
                   template: str = "vicuna", max_new_tokens: int = 64,
                   eos_token_id: int = -1, queue_order: str = "fifo",
                   prefix_cache: bool = False, warmup: bool = True,
                   max_turns: int = 1, store_cap: int = 8,
                   detokenize: Optional[Callable] = None,
                   results_path: Optional[str] = None) -> List[dict]:
    """Dataset-level CONTINUOUS BATCHING eval: every question's first turn
    is queued through `BatchedSpecEngine.serve` at once — aggregate
    dataset throughput instead of the reference's one-question-at-a-time
    batch-1 loop (eval/run_pipe_eval.py:200-320, the only mode its runtime
    supports). With `prefix_cache=True` the chat template's shared
    preamble is auto-detected (`shared_prefix="auto"`) and prefilled once
    for the whole dataset — the realistic production configuration, since
    every templated prompt in a dataset shares the system preamble.

    `warmup` (default on) pre-pays the serve path's first-call costs
    (graph captures on the card) with a tiny serve() call so
    throughput_tok_s measures steady-state serving. Rows record `warmed`
    so cold rows are identifiable.

    `max_turns` > 1 (requires `detokenize`) runs the reference's
    multi-turn loop (eval/run_pipe_eval.py:200-320) THROUGH the serving
    path: every question's turn k is served as one continuous-batching
    workload, with per-conversation lane snapshots
    (BatchedSpecEngine ConversationStore) so turn k+1 resumes each
    conversation's KV and chain-prefills only the new turn — the
    reference re-prefills the whole conversation every turn. Returns one
    row per turn; turn-2+ rows record `resumed` and `cold` and their
    latency_rounds_p50 shows the TTFT cut.

    `store_cap` bounds the ConversationStore: each entry pins a full
    per-lane KV snapshot on device (~hundreds of MB at 7B), so an
    uncapped store over an 80-question dataset is tens of GB. Evicted
    conversations degrade gracefully to a cold re-prefill; turn-2+ rows
    record `resumed` and `cold` (questions - resumed) so degraded
    coverage stays observable."""
    from flowspec_tpu_torch.runtime.batched import ConversationStore
    assert max_turns == 1 or detokenize is not None, \
        "multi-turn serving eval needs detokenize to build turn-2 prompts"
    store = ConversationStore(max_items=store_cap) \
        if max_turns > 1 else None
    convos = [[] for _ in questions]
    rows = []
    for turn in range(max_turns):
        idx = [i for i, q in enumerate(questions)
               if len(q.get("turns", [])) > turn]
        if not idx:
            break
        prompts = []
        for i in idx:
            convos[i].append((questions[i]["turns"][turn], None))
            prompts.append([int(t) for t in tokenize(
                build_prompt(convos[i], template=template))])
        kw = {"queue_order": queue_order}
        if store is not None:
            kw["conversations"] = store
            kw["conversation_ids"] = list(idx)
            kw["rounds_per_dispatch"] = 16
        if prefix_cache:
            # resolve "auto" over the FULL prompt set up front: a 2-prompt
            # warmup would detect a longer LCP and build (and cache) a
            # template the real call can't reuse
            kw["shared_prefix"] = engine._detect_shared_prefix(prompts)
        if warmup and turn == 0:
            wkw = dict(kw)
            if store is not None:
                wkw["conversations"] = ConversationStore(max_items=2)
                wkw["conversation_ids"] = [-1, -2]
            engine.serve(prompts[:2], max_new_tokens=4,
                         eos_token_id=eos_token_id, **wkw)
        t0 = time.perf_counter()
        outs, stats = engine.serve(prompts, max_new_tokens=max_new_tokens,
                                   eos_token_id=eos_token_id, **kw)
        dt = time.perf_counter() - t0
        for j, i in enumerate(idx):
            answer = outs[j][len(prompts[j]):]
            convos[i][-1] = (questions[i]["turns"][turn],
                             detokenize(answer) if detokenize else "")
        lr = sorted(stats["latency_rounds"])
        row = {
            "name": name, "turn": turn + 1, "questions": len(idx),
            "new_tokens": stats["new_tokens"],
            "throughput_tok_s": round(stats["new_tokens"] / dt, 3),
            "rounds": stats["rounds"],
            "slot_utilization": round(stats["slot_utilization"], 3),
            "latency_rounds_p50": int(lr[len(lr) // 2]),
            "latency_rounds_p95": int(lr[min(len(lr) - 1,
                                             int(0.95 * (len(lr) - 1)))]),
            "queue_order": queue_order, "prefix_cache": bool(prefix_cache),
            "warmed": bool(warmup),
        }
        if store is not None:
            row["resumed"] = stats.get("resumed_turns", 0)
            if turn:
                row["cold"] = len(idx) - row["resumed"]
        rows.append(row)
        if results_path:
            with open(results_path, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows if max_turns > 1 else rows[0]


def length_sweep(forward_at_len: Callable[[int], float],
                 lengths: Sequence[int] = (4, 8, 16, 24, 32, 48, 64),
                 threshold: float = 0.95) -> int:
    """Chunk-length autotune (ref tools/length_sweep.py:5-30): pick the
    largest length whose per-token latency still improves by >= threshold
    relative to linear scaling — i.e. the knee where the forward stops being
    latency-bound. `forward_at_len(n)` returns measured seconds."""
    times = [forward_at_len(n) for n in lengths]
    best = lengths[0]
    for (n0, t0), (n1, t1) in zip(zip(lengths, times),
                                  zip(lengths[1:], times[1:])):
        # cost growth per token-ratio; sub-linear growth means still amortized
        if t1 / t0 < threshold * (n1 / n0):
            best = n1
        else:
            break
    return best
