"""Single-device tree-speculative decoding engine.

Port of `flowspec_tpu/runtime/engine.py` (single-request path):
prefill -> [draft context -> beam tree -> verify the whole tree -> accept
-> compact KV] -> ... Positions and lengths (commit_len, n_pending, the
caches' lengths) are int32 tensors on the engine's device, one a lane, as
are the draw streams, so one round (`_spec_round`) issues no device-to-host
read and can be captured as a CUDA graph.

Two decode paths share that round body, as the JAX package's do:
- `generate` runs it eagerly in a Python loop and reads the accepted tokens
  once a round;
- `generate_fused` / `generate_ar_fused` run the counterparts of
  `_spec_decode_loop` / `_ar_decode_loop` (`runtime/graphs.py`): on the card
  one CUDA graph a KV bucket, replayed with one small read a replay; on the
  CPU the same loop body without capture.
`kv_buckets` (`_plan_buckets`, `_grow_kv`), `resume_and_generate` and the
`force_accept` bench mode are ported too; greedy and stochastic rounds
alike read nothing back (`tree/posterior.py` walks every depth with masks,
as the JAX scan does). The base model is any family of
`models/__init__.py model_forward` (LLaMA / Qwen2 `LlamaParams`, Mixtral
`MixtralParams`, DeepSeek-V3 `DeepseekParams` over a latent cache), or the
caller's `forward_fn`.

The state and the round run over a leading lane axis: B requests served
together, each with its own caches, lengths, tree and draw stream
(`EngineState` with (B,) lengths, `ServeCtx` for the serving path's prompt
chains). `SpecEngine` is the B = 1 case: its one request is one lane. The
batched engines are in `runtime/batched.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from flowspec_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingConfig, TreeConfig,
)
from flowspec_tpu_torch.draft.beam import topk_generate
from flowspec_tpu_torch.draft.eagle import (
    EagleParams, draft_context_forward, draft_view,
)
from flowspec_tpu_torch.models import init_base_cache, model_forward
from flowspec_tpu_torch.models.bias import prefill_bias, tree_bias
from flowspec_tpu_torch.models.kv_cache import (
    KVCache, grow_kv, init_kv_cache,
)
from flowspec_tpu_torch.models.llama import (
    LlamaParams, embed_tokens, final_hidden, lm_head_logits,
)
from flowspec_tpu_torch.models.mixtral import MixtralParams
from flowspec_tpu_torch.ops.quant import Int8Tensor, NF4Tensor, quantize_int8
from flowspec_tpu_torch.runtime import graphs
from flowspec_tpu_torch.tree.posterior import (
    evaluate_posterior_greedy, evaluate_posterior_stochastic,
)
from flowspec_tpu_torch.tree.sampling import Draws, lane_rng, sample_token
from flowspec_tpu_torch.tree.types import (
    TokenTree, lane_gather, lane_take, tree_attention_bias,
)
from flowspec_tpu_torch.utils.profiler import prof, timing_events


def resolve_device(device=None) -> torch.device:
    """The engine's device: `cuda` unless the caller names another; a CUDA
    device without a card raises (there is no silent CPU fallback)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    return dev


def make_beam_head(params: LlamaParams | MixtralParams, draft: EagleParams,
                   cfg: EngineConfig):
    """The lm_head copy the draft beam scores proposals with
    (EngineConfig.beam_head_quant; "auto" = int8 for an int8 or nf4 draft,
    plain for an int4 or unquantized one, as in the JAX package)."""
    mode = cfg.beam_head_quant
    if mode == "auto":
        mode = ("int8" if isinstance(draft.wq, (Int8Tensor, NF4Tensor))
                else "none")
    if mode == "int8":
        return quantize_int8(params.lm_head)
    assert mode == "none", mode
    return params.lm_head


@dataclasses.dataclass
class EngineState:
    """B lanes' state (B = 1 for one request), each lane its own request:
    caches (L, B, H, S, D) with (B,) lengths and the fields below."""
    base_cache: KVCache
    draft_cache: KVCache
    commit_len: torch.Tensor       # (B,) int32 — committed tokens (== base
                                   #   KV length)
    root_token: torch.Tensor       # (B,) int32 — current speculation root
    pending_tokens: torch.Tensor   # (B, CTX) int32 — draft pairs not
                                   #   consumed
    pending_hidden: torch.Tensor   # (B, CTX, H)
    n_pending: torch.Tensor        # (B,) int32
    root_hidden: torch.Tensor      # (B, H) — draft hidden of the root
                                   #   pair, used when n_pending == 0
    rng: torch.Tensor              # (B, 2) int64 draw streams (seed,
                                   #   counter), `tree/sampling.py`


@dataclasses.dataclass
class ServeCtx:
    """Per-lane request context of token-level continuous batching
    (`flowspec_tpu/runtime/engine.py:77-90`): while prompt_pos < prompt_len
    a lane's round consumes the next chain of prompt tokens instead of
    verifying a drafted tree (the chain is a degenerate tree, a root-to-leaf
    path, so verify and commit are shared; see `_spec_round`)."""
    prompt_buf: torch.Tensor   # (B, P) int32 — each lane's prompt, 0-padded
    prompt_len: torch.Tensor   # (B,) int32
    prompt_pos: torch.Tensor   # (B,) int32 — tokens already in the KV
    active: torch.Tensor       # (B,) bool — the lane holds a live request


def select_lanes(keep_new: torch.Tensor, new, old):
    """Field by field, lane b of `new` where keep_new[b], else of `old`
    (an EngineState, ServeCtx or TokenTree of lanes). A cache keeps its
    (shared, in place) rows and selects its length."""
    def sel(a, b):
        if isinstance(a, KVCache):
            return a.with_length(sel(a.length, b.length))
        if not isinstance(a, torch.Tensor) or a is b:
            return a
        return torch.where(keep_new.reshape(-1, *(1,) * (a.dim() - 1)), a, b)
    return dataclasses.replace(new, **{
        f.name: sel(getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(new)})


class SpecEngine:
    """Owns params and the step functions for one (base, draft) pair."""

    def __init__(self, params: LlamaParams | MixtralParams,
                 draft: EagleParams, cfg: EngineConfig, device=None,
                 forward_fn=None):
        """`forward_fn` swaps the base model's forward (`model_forward`'s
        signature), as in the JAX package."""
        self.device = resolve_device(device)
        self.forward_fn = forward_fn or model_forward
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.draft = draft
        self.dcfg = draft_view(draft, cfg.model)
        tc = cfg.tree
        # fresh (never merged) trees hold exactly total_tokens+1 nodes of
        # depth <= depth: clamp the static caps to that envelope, as the
        # JAX engine does, so verify runs no padded rows beyond it
        tc = dataclasses.replace(
            tc,
            node_cap=min(tc.node_cap, tc.total_tokens + 1),
            leaf_cap=min(tc.leaf_cap, tc.total_tokens + 1),
            depth_cap=min(tc.depth_cap, tc.depth + 1))
        self.cfg = dataclasses.replace(cfg, tree=tc)
        self.beam_head = make_beam_head(params, draft, self.cfg)
        # pending pair buffers hold a full prefill chunk until the first
        # round drains them
        self.ctx_pad = max(tc.depth_cap + 1, cfg.prefill_chunk)
        self._max_levels = tc.depth + tc.expand_depth
        self.draft_kv_len, self.base_kv_len = self._kv_rows(cfg.max_seq_len)
        # captured decode loops, keyed by kind and shapes (runtime/graphs.py)
        self._graphs: dict = {}
        self._graph_pool = None     # the memory pool its graphs share
        self._events: dict = {}     # the recorder's timing events, by span

    # ---- state setup -----------------------------------------------------
    def _kv_rows(self, max_seq: int):
        """(draft_rows, base_rows), rounded up to 256 (the attention kernel
        reads whole 256-row blocks)."""
        tc = self.cfg.tree
        rnd = lambda n: -(-n // 256) * 256
        return (rnd(max_seq + self._max_levels * tc.top_k),
                rnd(max_seq + tc.node_cap))

    def _plan_buckets(self, prompt_len: int, max_new: int):
        """Ascending max_seq bucket schedule for one request; [max_seq_len]
        when bucket growth is off. Buckets too small to fit the prompt plus
        one round are dropped, and the list is cut at the first bucket that
        covers the full request (later buckets can never engage)."""
        tc = self.cfg.tree
        full = self.cfg.max_seq_len
        if not self.cfg.kv_buckets:
            return [full]
        need = prompt_len + max_new + tc.depth_cap + 1
        out = []
        for s in sorted(set(self.cfg.kv_buckets) | {full}):
            if s > full or s < prompt_len + tc.depth_cap + 1:
                continue
            out.append(s)
            if s >= need:
                break
        return out or [full]

    def init_state(self, seed: int = 0,
                   max_seq: Optional[int] = None) -> EngineState:
        mc = self.cfg.model
        dt = getattr(torch, mc.dtype)
        dev = self.device
        draft_rows, base_rows = (
            self._kv_rows(max_seq) if max_seq is not None
            else (self.draft_kv_len, self.base_kv_len))
        zero = lambda: torch.zeros((1,), dtype=torch.int32, device=dev)
        return EngineState(
            base_cache=init_base_cache(mc, 1, base_rows, dt, dev),
            # draft KV geometry follows the draft's own (possibly thin)
            # head layout, not the base's
            draft_cache=init_kv_cache(1, 1, self.dcfg.num_key_value_heads,
                                      draft_rows, self.dcfg.head_dim_,
                                      dt, dev),
            commit_len=zero(), root_token=zero(),
            pending_tokens=torch.zeros((1, self.ctx_pad), dtype=torch.int32,
                                       device=dev),
            pending_hidden=torch.zeros((1, self.ctx_pad, mc.hidden_size),
                                       dtype=dt, device=dev),
            n_pending=zero(),
            root_hidden=torch.zeros((1, mc.hidden_size), dtype=dt,
                                    device=dev),
            rng=lane_rng(torch.full((1,), seed, dtype=torch.int64,
                                    device=dev)))

    # ---- prefill ---------------------------------------------------------
    def _prefill_chunks(self, state: EngineState, prompt):
        """Consume `prompt` in `prefill_chunk`-token chunks, leaving the last
        chunk's draft pairs pending with a placeholder in the final slot."""
        c = self.cfg.prefill_chunk
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = len(prompt)
        n_chunks = max(1, -(-p // c))
        padded = np.zeros((n_chunks * c,), np.int32)
        padded[:p] = prompt
        nxt = np.roll(padded, -1)
        dev = self.device
        rec = prof.enabled
        for i in range(n_chunks):
            sp = prof.open("prefill.chunk") if rec else -1
            state, last_logits = _prefill_chunk(
                state, self.params, self.draft,
                torch.from_numpy(padded[i * c:(i + 1) * c]).to(dev),
                torch.from_numpy(nxt[i * c:(i + 1) * c]).to(dev),
                min(c, p - i * c), cfg=self.cfg.model, fwd=self.forward_fn)
            if sp >= 0:
                prof.close(sp)
        return state, last_logits

    def prefill(self, state: EngineState, prompt) -> EngineState:
        """Chunked prefill; the draft context advances in lockstep with the
        pairs (token_{i+1}, base_hidden_i). Recorded, the `prefill.finish`
        span's device ms run from the first chunk's start."""
        ev = self._timing("prefill") if prof.enabled else None
        if ev:
            ev[0].record()
        state, last_logits = self._prefill_chunks(state, prompt)
        sp = prof.open("prefill.finish") if prof.enabled else -1
        state = _finish_prefill(state, self.draft, last_logits,
                                cfg=self.cfg.model,
                                ctx_small=self.cfg.tree.depth_cap + 1,
                                sampling=self.cfg.sampling)
        if sp >= 0:
            prof.close(sp, events=ev)
        return state

    def _timing(self, span: str):
        """The engine's (start, end) timing events for `span`, made at its
        first recording on the card and reused; None off the card, and
        while the pair's last reading is still pending (prefills admitted
        one after another with no sync between them), so that span goes
        without device figures."""
        ev = self._events.get(span)
        if ev is None:
            if self.device.type != "cuda":
                return None
            ev = self._events[span] = timing_events(2)
        prof.resolve()
        return None if prof.pending(ev) else ev

    def _check_budget(self, prompt, max_new: int):
        """Tree chunks are written at [commit, commit + node_cap), so commit
        may never pass max_seq_len (a clamped write would overwrite the
        newest valid rows)."""
        need = (len(np.asarray(prompt).reshape(-1)) + max_new
                + self.cfg.tree.depth_cap + 1)
        if need > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt+max_new+depth_cap = {need} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}; raise EngineConfig.max_seq_len or "
                "shorten the request")

    # ---- decoding --------------------------------------------------------
    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_token_id: int = 2, seed: int = 0,
                 return_state: bool = False):
        """Returns (tokens list incl prompt, stats dict[, final state])."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        self._check_budget(prompt, max_new)
        state = self.prefill(self.init_state(seed), prompt)
        out = [int(t) for t in np.asarray(prompt).reshape(-1)]
        return self._decode_rounds(state, out, max_new, eos_token_id,
                                   return_state)

    def _decode_rounds(self, state, out, max_new, eos_token_id,
                       return_state):
        new_tokens = 0
        rounds = 0
        while new_tokens < max_new:
            state, accepted, n_acc = self._round(state)
            rounds += 1
            # the round's one host read: the accepted length and tokens
            n, *acc = torch.cat([n_acc.view(1), accepted]).tolist()
            stop = False
            for t in acc[:n]:
                out.append(t)
                new_tokens += 1
                if t == eos_token_id or new_tokens >= max_new:
                    stop = True
                    break
            if stop:
                break
        stats = {"new_tokens": new_tokens, "rounds": rounds,
                 "accept_per_round": new_tokens / max(rounds, 1)}
        if return_state:
            return out, stats, state
        return out, stats

    def _round(self, state: EngineState):
        """One `_spec_round` of this engine's one lane: (state, accepted
        (depth_cap,) int32 with -1 padding, n_accepted ())."""
        st, accepted, n_acc = _spec_round(
            state, self.params, self.draft, self.beam_head,
            cfg=self.cfg.model, tree_cfg=self.cfg.tree,
            sampling=self.cfg.sampling, force_accept=self.cfg.force_accept,
            fwd=self.forward_fn)
        return st, accepted[0], n_acc[0]

    def _ar(self, state: EngineState):
        """One `_ar_step` with this engine's weights: (state, next token
        (1,))."""
        return _ar_step(state, self.params, cfg=self.cfg.model,
                        sampling=self.cfg.sampling, fwd=self.forward_fn)

    def resume_and_generate(self, state, history, extra_prompt,
                            max_new_tokens: Optional[int] = None,
                            eos_token_id: int = 2,
                            return_state: bool = False):
        """Multi-turn continuation with KV reuse
        (`flowspec_tpu/runtime/engine.py:415-477`): append `extra_prompt`
        to a finished generation and keep decoding, prefilling only the new
        tokens. `history` is exactly the token list the previous
        generate / resume_and_generate call on this `state` returned (pass
        return_state=True there). The engine may have committed past that
        stream, so the lengths roll back, on the device, to len(history)-1
        committed tokens (committed KV row i holds history[i]), and the
        boundary token history[-1] is re-forwarded as the first token of
        the continuation chunk; the draft cache's length tracks commits one
        for one and rolls back to the same mark. The pending pair buffers
        are re-widened to a prefill chunk, or the continuation's pairs
        would be cut."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        history = [int(t) for t in np.asarray(history).reshape(-1)]
        extra = [int(t) for t in np.asarray(extra_prompt).reshape(-1)]
        keep = len(history) - 1
        if keep < 0 or not extra:
            raise ValueError(f"resume_and_generate needs a history and an "
                             f"extra prompt, got {len(history)} and "
                             f"{len(extra)} tokens")
        tc = self.cfg.tree
        limit = min(self.cfg.max_seq_len,
                    state.base_cache.max_len - tc.node_cap,
                    state.draft_cache.max_len - self._max_levels * tc.top_k)
        need = len(history) + len(extra) + max_new + tc.depth_cap + 1
        if need > limit:
            raise ValueError(
                f"history+extra+max_new+depth_cap = {need} exceeds this "
                f"state's budget {limit}; raise EngineConfig.max_seq_len")
        dev = self.device
        h = state.pending_hidden.shape[-1]
        keep_t = torch.full((1,), keep, dtype=torch.int32, device=dev)
        state = dataclasses.replace(
            state,
            base_cache=state.base_cache.with_length(keep_t),
            draft_cache=state.draft_cache.with_length(keep_t.clone()),
            commit_len=keep_t.clone(),
            n_pending=torch.zeros((1,), dtype=torch.int32, device=dev),
            pending_tokens=torch.zeros((1, self.ctx_pad), dtype=torch.int32,
                                       device=dev),
            pending_hidden=torch.zeros((1, self.ctx_pad, h),
                                       dtype=state.pending_hidden.dtype,
                                       device=dev))
        state = self.prefill(state, [history[-1]] + extra)
        return self._decode_rounds(state, history + extra, max_new,
                                   eos_token_id, return_state)

    def generate_fused(self, prompt, max_new_tokens: Optional[int] = None,
                       eos_token_id: int = 2, seed: int = 0):
        """Like generate(), but the decode loop runs as the counterpart of
        `_spec_decode_loop` (`runtime/graphs.py`): on the card one captured
        CUDA graph of the round and its bookkeeping, replayed with one small
        read a replay; on the CPU the same loop body. It captures and
        replays or raises: it never falls back to the eager loop.

        With cfg.kv_buckets set, the decode runs as a chain of segments: the
        KV caches start in the smallest bucket that fits the prompt, and
        when commit_len passes the bucket's budget the loop exits, the
        caches are zero-padded to the next bucket and the next segment (the
        next bucket's graph) continues.

        With the recorder on (`utils/profiler.py prof.enabled`) the call is
        one `request` span around `prefill.chunk`, `prefill.finish`,
        `grow_kv` and each segment's spans (`runtime/graphs.py`), and a
        span for each of the recorder's device tallies that counted in the
        request (`utils/profiler.py tally`), read once at its end."""
        req = prof.open_request() if prof.enabled else -1
        if req >= 0:
            prof.zero_tallies()
        try:
            return self._generate_fused(prompt, max_new_tokens,
                                        eos_token_id, seed)
        finally:
            if req >= 0:
                prof.read_tallies()
                prof.close_request(req)

    def _generate_fused(self, prompt, max_new_tokens, eos_token_id, seed):
        max_new = max_new_tokens or self.cfg.max_new_tokens
        self._check_budget(prompt, max_new)
        p_len = len(np.asarray(prompt).reshape(-1))
        buckets = self._plan_buckets(p_len, max_new)
        state = self.prefill(self.init_state(seed, max_seq=buckets[0]),
                             prompt)
        out = [int(t) for t in np.asarray(prompt).reshape(-1)]
        new_tokens = 0
        rounds = 0
        for i, seq in enumerate(buckets):
            if i:
                sp = prof.open("grow_kv") if prof.enabled else -1
                ev = self._timing("grow_kv") if sp >= 0 else None
                if ev:
                    ev[0].record()
                state = _grow_kv(state, *self._kv_rows(seq))
                if sp >= 0:
                    prof.close(sp, events=ev)
            toks, seg_rounds, done, state = graphs.spec_decode_loop(
                self, state, eos_token_id, max_new - new_tokens, seq)
            rounds += seg_rounds
            # trim past eos / budget like the reference's outer loop
            stop = False
            for t in toks:
                out.append(t)
                new_tokens += 1
                if t == eos_token_id or new_tokens >= max_new:
                    stop = True
                    break
            if stop or done or new_tokens >= max_new:
                break
        return out, {"new_tokens": new_tokens, "rounds": rounds,
                     "accept_per_round": new_tokens / max(rounds, 1),
                     "kv_buckets_used": i + 1}

    def generate_ar_fused(self, prompt, max_new_tokens: Optional[int] = None,
                          eos_token_id: int = 2, seed: int = 0):
        """generate_ar() through the counterpart of `_ar_decode_loop`: one
        captured CUDA graph of the AR step on the card, the same body on
        the CPU."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        self._check_budget(prompt, max_new)
        state = self.prefill(self.init_state(seed), prompt)
        toks = graphs.ar_decode_loop(self, state, eos_token_id,
                                     max_out=max_new)
        out = [int(t) for t in np.asarray(prompt).reshape(-1)] + toks
        return out, {"new_tokens": len(toks)}

    def generate_ar(self, prompt, max_new_tokens: Optional[int] = None,
                    eos_token_id: int = 2, seed: int = 0):
        """Plain autoregressive baseline (ref `ar` schedule)."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        self._check_budget(prompt, max_new)
        state = self.prefill(self.init_state(seed), prompt)
        out = [int(t) for t in np.asarray(prompt).reshape(-1)]
        tok = state.root_token
        new_tokens = 0
        while new_tokens < max_new:
            t = int(tok)
            out.append(t)
            new_tokens += 1
            if t == eos_token_id:
                break
            state, tok = self._ar(state)
        return out, {"new_tokens": new_tokens}


# ---- step bodies -----------------------------------------------------------

def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last axis cut or zero-padded to n, int32."""
    c = x.shape[-1]
    if c >= n:
        return x[..., :n].to(torch.int32)
    return torch.cat([x, x.new_zeros((*x.shape[:-1], n - c))],
                     dim=-1).to(torch.int32)


def _pad_rows(h: torch.Tensor, n: int) -> torch.Tensor:
    b, c, d = h.shape
    if c >= n:
        return h[:, :n]
    return torch.cat([h, h.new_zeros((b, n - c, d))], dim=1)


def _prefill_chunk(state: EngineState, params, draft: EagleParams, tokens,
                   next_tokens, n_valid: int, *, cfg: ModelConfig,
                   fwd=model_forward):
    """One prompt chunk (`tokens`, (C,)) of a one-lane state. Returns (state,
    the last valid token's logits (V,))."""
    c = tokens.shape[0]
    start = state.commit_len                                  # (1,)
    dev = tokens.device
    s_max = state.base_cache.max_len
    hidden = embed_tokens(params, tokens[None])
    bias = prefill_bias(start, c, s_max, device=dev)
    positions = start[:, None] + torch.arange(c, device=dev)
    out, cache = fwd(params, state.base_cache, hidden, positions, bias,
                     start, cfg)
    cache = cache.with_length(start + n_valid)
    normed = final_hidden(params, out, cfg)

    # consume the *previous* pending pairs, then queue this chunk's pairs
    dstate = _drain_pending(state, draft, cfg)
    last_logits = lm_head_logits(params, normed[0, min(max(n_valid - 1, 0),
                                                        c - 1)])
    new_state = dataclasses.replace(
        dstate, base_cache=cache, commit_len=start + n_valid,
        pending_tokens=_pad_to(next_tokens[None],
                               state.pending_tokens.shape[1]),
        pending_hidden=_pad_rows(normed, state.pending_hidden.shape[1]),
        n_pending=torch.full((1,), n_valid, dtype=torch.int32, device=dev))
    return new_state, last_logits


def _finish_prefill(state: EngineState, draft: EagleParams, last_logits, *,
                    cfg: ModelConfig, ctx_small: int,
                    sampling: SamplingConfig) -> EngineState:
    """Sample the first root from `last_logits`, patch it into the final
    pending pair, drain the last prompt chunk's pairs, keep the root's draft
    hidden, and shrink the pending buffers to depth_cap+1 rows."""
    draws = Draws(state.rng)
    root = sample_token(draws, last_logits[None], sampling, is_probs=False)
    slot = (state.n_pending - 1).remainder(state.pending_tokens.shape[1])
    pt = state.pending_tokens.scatter(1, slot.long()[:, None], root[:, None])
    state = dataclasses.replace(state, root_token=root, pending_tokens=pt,
                                rng=draws.rng)
    out, dcache = draft_context_forward(
        draft, state.draft_cache, state.pending_tokens, state.pending_hidden,
        state.draft_cache.length, state.n_pending, cfg)
    h = state.pending_hidden.shape[-1]
    return dataclasses.replace(
        state, draft_cache=dcache,
        root_hidden=lane_take(out, (state.n_pending - 1).clamp(
            0, out.shape[1] - 1)),
        pending_tokens=state.pending_tokens.new_zeros((1, ctx_small)),
        pending_hidden=state.pending_hidden.new_zeros((1, ctx_small, h)),
        n_pending=torch.zeros_like(state.n_pending))


def _drain_pending(state: EngineState, draft: EagleParams,
                   cfg: ModelConfig) -> EngineState:
    """Advance the draft context KV over the queued (token, hidden) pairs."""
    _, dcache = draft_context_forward(
        draft, state.draft_cache, state.pending_tokens, state.pending_hidden,
        state.draft_cache.length, state.n_pending, cfg)
    return dataclasses.replace(state, draft_cache=dcache)


def _chain_tree(serve: ServeCtx, tree_cfg: TreeConfig):
    """Each lane's next prompt chunk as a degenerate tree
    (`flowspec_tpu/runtime/engine.py:642-666`): a root-to-leaf chain of up
    to depth_cap tokens (node i's parent is i-1, one retrieve row).
    Verifying it through the round appends its KV, gives its hiddens for
    the draft context and the last node's logits: a prefill step, batched
    beside the decoding lanes. Returns (tree, n_chain (B,))."""
    cl = tree_cfg.depth_cap
    n_cap, l_cap = tree_cfg.node_cap, tree_cfg.leaf_cap
    b, p_cap = serve.prompt_buf.shape
    dev = serve.prompt_buf.device
    pos = serve.prompt_pos
    n_chain = (serve.prompt_len - pos).clamp(1, cl).to(torch.int32)
    i_n = torch.arange(n_cap, device=dev, dtype=torch.int32)
    toks = torch.gather(serve.prompt_buf, 1,
                        (pos[:, None] + i_n).clamp(0, p_cap - 1).long())
    in_chain = i_n < n_chain[:, None]
    i_d = torch.arange(cl, device=dev, dtype=torch.int32)
    row0 = torch.where(i_d < n_chain[:, None], i_d, -1)           # (B, D)
    retrieve = torch.cat(
        [row0[:, None], torch.full((b, l_cap - 1, cl), -1, dtype=torch.int32,
                                   device=dev)], dim=1)
    return TokenTree(
        tokens=torch.where(in_chain, toks, -1).to(torch.int32),
        parents=torch.where((i_n > 0) & in_chain, i_n - 1, -1),
        depth=torch.where(in_chain, i_n, 0),
        scores=torch.zeros((b, n_cap), device=dev),
        retrieve=retrieve, n_nodes=n_chain,
        n_leaves=torch.ones((b,), dtype=torch.int32, device=dev)), n_chain


def _spec_round(state: EngineState, params, draft: EagleParams,
                beam_head=None, serve: ServeCtx | None = None,
                live: torch.Tensor | None = None, *, cfg: ModelConfig,
                tree_cfg: TreeConfig, sampling: SamplingConfig,
                force_accept: int = 0, fwd=model_forward):
    """One draft -> verify -> accept round (ref eagle/ea_model.py:236-297)
    over the B lanes of `state` (`EngineState` of lanes). Returns (state,
    accepted (B, depth_cap) int32 with -1 padding, n_accepted (B,) int32),
    all on the device: a round reads nothing back, so the eager loop and a
    captured CUDA graph run the same body. Every projection sees the B
    lanes' rows as one matrix and one attention launch a layer serves all
    lanes.

    `live` (B,) bool marks the lanes that advance; the others keep their
    state (lengths, tokens, pairs, draws) and their KV writes land on their
    last row only (`models/kv_cache.py`), the counterpart of the JAX
    package's select of the old state. With `serve` (`ServeCtx`), a lane
    still consuming its prompt verifies its next prompt chain instead of a
    drafted tree and emits nothing, an inactive lane does not advance, and
    the result is (state, accepted, n_emitted, serve')
    (`flowspec_tpu/runtime/engine.py:669-809`).

    `force_accept` > 0 is the synthetic-acceptance bench mode
    (`flowspec_tpu/runtime/engine.py:729-743`): the deepest drafted path is
    accepted for min(force_accept, its length) nodes whatever the verdict,
    so every later stage does the work of a real acceptance of that length.
    Measurement only: the tokens are not the base model's."""
    n_cap = tree_cfg.node_cap
    s_max = state.base_cache.max_len
    dev = state.root_token.device
    draws = Draws(state.rng)
    if serve is not None:
        live = serve.active if live is None else live & serve.active

    # 1. draft context + tree generation
    out, dcache = draft_context_forward(
        draft, state.draft_cache, state.pending_tokens, state.pending_hidden,
        state.draft_cache.length, state.n_pending, cfg, live)
    # n_pending == 0 only on the first round after prefill (the prefill
    # drain consumed the pairs and kept the root's hidden)
    drained = lane_take(out, (state.n_pending - 1).clamp(0, out.shape[1] - 1))
    root_hidden = torch.where((state.n_pending > 0)[:, None], drained,
                              state.root_hidden)
    head = params.lm_head if beam_head is None else beam_head
    tree, _, dcache = topk_generate(draft, head, dcache, state.root_token,
                                    root_hidden, tree_cfg, cfg,
                                    force_deep_path=force_accept > 0,
                                    live=live)
    if serve is not None:
        chain, n_chain = _chain_tree(serve, tree_cfg)
        in_pref = serve.active & (serve.prompt_pos < serve.prompt_len)
        tree = select_lanes(in_pref, chain, tree)

    # 2. verify every lane's tree in one chunk of node_cap tokens a lane
    commit = state.commit_len
    anc_bias = tree_attention_bias(tree.parents, tree_cfg.depth_cap,
                                   tree.valid())
    bias = tree_bias(anc_bias, commit, s_max)                # (B, N, S)
    toks = torch.where(tree.tokens >= 0, tree.tokens, 0)
    hidden = embed_tokens(params, toks)
    positions = commit[:, None] + tree.depth
    b_out, bcache = fwd(params, state.base_cache, hidden, positions, bias,
                        commit, cfg, **({} if live is None
                                        else {"live": live}))
    normed = final_hidden(params, b_out, cfg)            # (B, N, H)
    node_logits = lm_head_logits(params, normed)         # (B, N, V) f32

    # 3. accept
    if sampling.is_greedy:
        res = evaluate_posterior_greedy(node_logits, tree)
    else:
        res = evaluate_posterior_stochastic(
            node_logits, tree, sampling, draws,
            max_trials=min(2 * tree_cfg.top_k, tree_cfg.leaf_cap))
    new_root = sample_token(draws, res.sample_p, sampling, is_probs=True)
    best_leaf, accept_len = res.best_leaf, res.accept_len
    if force_accept:
        path_len = (tree.retrieve >= 0).sum(dim=-1)
        path_len = torch.where(tree.leaf_valid(), path_len, 0)
        best_leaf = torch.argmax(path_len, dim=-1).to(torch.int32)
        accept_len = torch.clamp(lane_take(path_len, best_leaf) - 1,
                                 max=force_accept).to(torch.int32)
        last = lane_take(tree.retrieve, best_leaf, accept_len).clamp(
            0, n_cap - 1)
        p_last = torch.softmax(lane_take(node_logits, last).float(), dim=-1)
        new_root = sample_token(draws, p_last, sampling, is_probs=True)
    if serve is not None:
        # prompt lanes: the whole chain is accepted by construction; the
        # next root is the next prompt token or, once the prompt is used
        # up, a sample from the last chain node's logits
        pos = serve.prompt_pos
        p_cap = serve.prompt_buf.shape[1]
        pref_done = pos + n_chain >= serve.prompt_len
        sampled = sample_token(
            draws, lane_take(node_logits, (n_chain - 1).clamp(0, n_cap - 1)),
            sampling, is_probs=False)
        next_prompt = lane_take(serve.prompt_buf,
                                (pos + n_chain).clamp(0, p_cap - 1))
        best_leaf = torch.where(in_pref, 0, best_leaf)
        accept_len = torch.where(in_pref, n_chain - 1, accept_len)
        new_root = torch.where(in_pref,
                               torch.where(pref_done, sampled, next_prompt),
                               new_root)

    # 4. commit: path nodes [root, a_1..a_k]
    d_cap = tree_cfg.depth_cap
    path = lane_take(tree.retrieve, best_leaf)           # (B, D)
    n_acc = (accept_len + 1).to(torch.int32)
    d_idx = torch.arange(d_cap, device=dev)
    path_valid = d_idx < n_acc[:, None]
    safe_path = path.clamp(0, n_cap - 1).long()
    accepted_tokens = torch.where(
        path_valid, torch.gather(tree.tokens, 1, safe_path), -1)

    # 5. base KV compaction: keep accepted node rows right after commit
    src = torch.where(path_valid, commit[:, None] + safe_path, 0)
    bcache = bcache.compact(src, n_acc, commit, live)

    # 6. next round's draft pairs: (a_1..a_k, new_root) with hiddens of
    # (a_0..a_k)
    ctx = state.pending_tokens.shape[1]
    shifted = torch.roll(accepted_tokens, -1, dims=1)
    pair_tok = torch.where(d_idx + 1 < n_acc[:, None], shifted, 0)
    pair_tok = torch.where(d_idx + 1 == n_acc[:, None], new_root[:, None],
                           pair_tok)
    pair_hidden = lane_gather(normed, safe_path)         # (B, D, H)
    pair_hidden = torch.where(path_valid[..., None], pair_hidden,
                              torch.zeros((), dtype=pair_hidden.dtype,
                                          device=dev))

    new_state = EngineState(
        base_cache=bcache, draft_cache=dcache, commit_len=commit + n_acc,
        root_token=new_root, pending_tokens=_pad_to(pair_tok, ctx),
        pending_hidden=_pad_rows(pair_hidden, ctx), n_pending=n_acc,
        root_hidden=root_hidden, rng=draws.rng)
    if live is not None:
        new_state = select_lanes(live, new_state, state)
    accepted_tokens = accepted_tokens.to(torch.int32)
    if serve is None:
        return new_state, accepted_tokens, n_acc
    serve2 = dataclasses.replace(
        serve, prompt_pos=serve.prompt_pos + torch.where(in_pref, n_chain, 0))
    n_emit = torch.where(serve.active & ~in_pref, n_acc, 0)
    return new_state, accepted_tokens, n_emit, serve2


def _grow_kv(state: EngineState, draft_rows: int,
             base_rows: int) -> EngineState:
    """Move a request's KV caches to a larger bucket by zero-padding the
    sequence axis (`flowspec_tpu/runtime/engine.py:812-828`); the lengths
    and every other field carry over unchanged."""
    return dataclasses.replace(
        state, base_cache=grow_kv(state.base_cache, base_rows),
        draft_cache=grow_kv(state.draft_cache, draft_rows))


def _ar_step(state: EngineState, params, *, cfg: ModelConfig,
             sampling: SamplingConfig, fwd=model_forward):
    """Decode one token autoregressively (baseline), every lane."""
    s_max = state.base_cache.max_len
    commit = state.commit_len
    dev = state.root_token.device
    hidden = embed_tokens(params, state.root_token[:, None])
    bias = prefill_bias(commit, 1, s_max, device=dev)
    out, cache = fwd(params, state.base_cache, hidden, commit[:, None], bias,
                     commit, cfg)
    cache = cache.with_length(commit + 1)
    logits = lm_head_logits(params, final_hidden(params, out, cfg))[:, 0]
    draws = Draws(state.rng)
    tok = sample_token(draws, logits, sampling, is_probs=False)
    return dataclasses.replace(state, base_cache=cache,
                               commit_len=commit + 1, root_token=tok,
                               rng=draws.rng), tok
