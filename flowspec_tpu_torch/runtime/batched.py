"""Batched and continuous-batching speculative decoding over B lanes.

Port of `flowspec_tpu/runtime/batched.py` (`generate_batch`,
`generate_batch_fused`, `serve`, `serve_stream`, `warmup`,
`ConversationStore`, `adapt_tree_for_batch`, `dynamic_tree`,
`dynamic_batch`). The JAX package vmaps its single-request round
over stacked lane states; here the round itself runs over a leading lane
axis (`runtime/engine.py _spec_round`): every projection sees the B lanes'
rows as one matrix, one attention launch a layer serves all lanes (the
kernel folds the lane into its grid), and one head top-k call a beam level
scores all B*K rows. So a batched round launches the kernels a one-request
round does, each on B times the rows.

Lane states are `EngineState`s with (B,) lengths and (L, B, ...) caches
(a one-request state is one lane), per-lane draw streams in `rng`
(`tree/sampling.py Draws`: a lane's randomness is keyed by its seed, seed +
queue position in `serve`, and is its own whatever its neighbours do). A
lane that stops (finished, idle, past its KV headroom) keeps its state by a
per-lane select of the small fields, and its KV
writes land on its last row only (`models/kv_cache.py`): the KV is never
copied whole.

- `generate_batch`: B requests in lockstep rounds, eager, one host read a
  round.
- `generate_batch_fused`: the gated lane loop (`runtime/graphs.py
  _lane_body`), one CUDA graph per KV bucket on the card; `kv_buckets`
  grow all lanes together.
- `serve`: token-level continuous batching. A lane whose request finishes
  is refilled from a device-resident queue inside the captured serve body
  (`runtime/graphs.py _serve_body`) and consumes its prompt as chains of
  up to depth_cap tokens while the other lanes keep decoding; the host
  replays one round at a time, reading one small pinned row, and falls at
  the JAX package's dispatch boundaries (after `rounds_per_dispatch`
  rounds, or when no lane is active), so every statistic equals the JAX
  package's. `shared_prefix` prefills a common prefix once into a template
  every lane starts from; `conversations` (a `ConversationStore`) resumes
  a later turn from the lane state a request finished with.
- `serve_stream`: requests arrive over time (`arrivals_s`, an injectable
  `clock`). At each dispatch boundary the host reorders the arrived queue
  (`queue_order`, `starvation_cap`), admits arrivals and resumes or
  preempts a request (`preempt_factor`, its cost gate) in one
  `_run_boundary`, writing the queue rows and lanes in place; a cold
  shared prefix builds in a thread while the first arrivals are served
  without it (`prefix_overlap`).
- `dynamic_tree`: each serve dispatch drafts the tree its busy-lane count
  earns (`_serve_tree`); `dynamic_batch`: `serve_stream` re-widths the
  lanes to 1, 2 or 4 (`_serve_width`, `_resize_lanes`). The serve graphs
  are keyed by (KV rows, width, queue capacity, tree variant); the
  variants of one width share its static buffers (`runtime/graphs.py
  ServeLanes`), so a variant switch copies nothing, and a width switch
  copies only the lanes that move. `warmup` captures every graph a call
  of that many requests can pick.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import List, Sequence

import numpy as np
import torch

from flowspec_tpu_torch.config import EngineConfig
from flowspec_tpu_torch.draft.eagle import EagleParams
from flowspec_tpu_torch.models.kv_cache import (
    KVCache, init_kv_cache, read_lane, stack_lanes, write_lane,
)
from flowspec_tpu_torch.runtime import graphs
from flowspec_tpu_torch.runtime.engine import (
    EngineState, ServeCtx, SpecEngine, _grow_kv, _spec_round,
)
from flowspec_tpu_torch.tree.sampling import lane_rng


def adapt_tree_for_batch(tree, batch_size: int):
    """Batch-adaptive speculation (`flowspec_tpu/runtime/batched.py:36-54`):
    shrink the per-lane draft tree as the batch grows, to 48 nodes for 2-3
    lanes and 32 from 4. Greedy outputs are tree-size-invariant; only the
    acceptance a round trades off."""
    if batch_size <= 1:
        return tree
    target = 48 if batch_size <= 3 else 32
    if tree.total_tokens + 1 <= target:
        return tree
    return dataclasses.replace(
        tree, total_tokens=target - 1,
        node_cap=min(tree.node_cap, target),
        leaf_cap=min(tree.leaf_cap, target))


OVERHEAD_ROUNDS = 2     # pause + resume host-boundary dispatches, in rounds


class ConversationStore:
    """Per-conversation lane snapshots for multi-turn serving: the exact
    one-lane state a request finished with, plus its token history. A later
    turn resumes from the snapshot and chain-prefills only its new tokens.
    Each snapshot holds a whole lane's KV allocation, so the store is
    LRU-capped at `max_items`."""

    def __init__(self, max_items: int = 8):
        self.max_items = max_items
        self._d = {}            # conv_id -> {"state": ..., "history": [..]}

    def get(self, conv_id):
        if conv_id in self._d:
            self._d[conv_id] = self._d.pop(conv_id)    # refresh recency
            return self._d[conv_id]
        return None

    def put(self, conv_id, state, history):
        self._d.pop(conv_id, None)
        while len(self._d) >= self.max_items:
            self._d.pop(next(iter(self._d)))
        self._d[conv_id] = {"state": state,
                            "history": [int(t) for t in history]}

    def __len__(self):
        return len(self._d)

    def __contains__(self, conv_id):
        return conv_id in self._d

    def clone(self):
        """Shallow copy: the entries share their snapshots, which nothing
        writes to (a resume copies a snapshot into a lane)."""
        c = ConversationStore(max_items=self.max_items)
        c._d = dict(self._d)
        return c


def _ints(xs) -> list:
    return [int(x) for x in np.asarray(xs).reshape(-1)]


class BatchedSpecEngine(SpecEngine):
    """SpecEngine plus decoding over B lanes."""

    def __init__(self, params, draft: EagleParams, cfg: EngineConfig,
                 batch_size: int = 4, adapt_tree: bool = True,
                 dynamic_tree: bool = False, dynamic_batch: bool = False,
                 device=None):
        """`adapt_tree` (default on) applies `adapt_tree_for_batch`; pass
        False to keep the configured tree. `dynamic_tree`: each serve
        dispatch drafts the `adapt_tree_for_batch` variant of its busy-lane
        count; the state is allocated for the full tree, which
        `generate_batch[_fused]` then run (adapt_tree is off).
        `dynamic_batch`: `serve_stream` re-widths its lanes to the
        power-of-two bucket of the lanes it needs, capped at batch_size.
        The engine runs on `device`: `cuda` unless named
        (`runtime/engine.py resolve_device`)."""
        self.dynamic_tree = dynamic_tree
        self.dynamic_batch = dynamic_batch
        if adapt_tree and not dynamic_tree:
            cfg = dataclasses.replace(
                cfg, tree=adapt_tree_for_batch(cfg.tree, batch_size))
        super().__init__(params, draft, cfg, device=device)
        self.batch_size = batch_size
        # the dispatch trees of dynamic_tree by busy-lane count, caps
        # clamped to each one's node count as SpecEngine clamps the engine's
        self._tree_variants = {}
        if dynamic_tree:
            for n in range(1, batch_size + 1):
                tc = adapt_tree_for_batch(self.cfg.tree, n)
                self._tree_variants[n] = dataclasses.replace(
                    tc, node_cap=min(tc.node_cap, tc.total_tokens + 1),
                    leaf_cap=min(tc.leaf_cap, tc.total_tokens + 1))
        # shared-prefix templates keyed by the prefix tokens (each holds a
        # whole lane allocation: the two most recent are kept)
        self._prefix_templates = {}
        self._zero_tstate = None
        self._serve_sets = {}   # ServeLanes by key (runtime/graphs.py)

    # ---- the round over lanes ------------------------------------------
    def _lane_round(self, state: EngineState, serve: ServeCtx | None = None,
                    live=None, tree_cfg=None):
        return _spec_round(state, self.params, self.draft, self.beam_head,
                           serve, live, cfg=self.cfg.model,
                           tree_cfg=tree_cfg or self.cfg.tree,
                           sampling=self.cfg.sampling,
                           force_accept=self.cfg.force_accept,
                           fwd=self.forward_fn)

    def _serve_tree(self, n_active: int):
        """The tree a serve dispatch with `n_active` busy lanes drafts: the
        engine's, or under dynamic_tree the variant of that count."""
        if not self.dynamic_tree:
            return self.cfg.tree
        return self._tree_variants[max(1, min(int(n_active),
                                              self.batch_size))]

    def _serve_width(self, want: int) -> int:
        """The dispatch width for `want` needed lanes (dynamic_batch): the
        smallest power of two >= want, capped at batch_size."""
        want = max(1, min(int(want), self.batch_size))
        w = 1
        while w < want:
            w *= 2
        return min(w, self.batch_size)

    # ---- lane states -----------------------------------------------------
    def _lane_state(self, seeds: Sequence[int]) -> EngineState:
        """Zero lanes (`init_state` per lane, stacked), one draw stream
        each from `seeds`."""
        return self._stack_states([self.init_state(sd) for sd in seeds],
                                  seeds)

    def _stack_states(self, states, seeds: Sequence[int]) -> EngineState:
        """One lane state from one-lane states, lane b the b-th with a draw
        stream from seeds[b] (a copy)."""
        cat = lambda f: torch.cat([getattr(s, f) for s in states])
        return EngineState(
            base_cache=stack_lanes([s.base_cache for s in states]),
            draft_cache=stack_lanes([s.draft_cache for s in states]),
            commit_len=cat("commit_len"), root_token=cat("root_token"),
            pending_tokens=cat("pending_tokens"),
            pending_hidden=cat("pending_hidden"),
            n_pending=cat("n_pending"), root_hidden=cat("root_hidden"),
            rng=lane_rng(torch.tensor(list(seeds)).to(self.device)))

    @staticmethod
    def _read_slot(batched: EngineState, s: int) -> EngineState:
        """Lane `s` as a one-lane state (a copy: the lane may be reused
        while the caller holds it)."""
        one = lambda x: x[s:s + 1].clone()
        return EngineState(
            base_cache=read_lane(batched.base_cache, s),
            draft_cache=read_lane(batched.draft_cache, s),
            commit_len=one(batched.commit_len),
            root_token=one(batched.root_token),
            pending_tokens=one(batched.pending_tokens),
            pending_hidden=one(batched.pending_hidden),
            n_pending=one(batched.n_pending),
            root_hidden=one(batched.root_hidden), rng=one(batched.rng))

    @staticmethod
    def _write_slot(batched: EngineState, state: EngineState, s: int,
                    payload: bool = True) -> None:
        """Copy the one-lane `state` into lane `s` of `batched`, in place
        (`payload` False: the lengths only, not the KV rows)."""
        write_lane(batched.base_cache, s, state.base_cache, payload)
        write_lane(batched.draft_cache, s, state.draft_cache, payload)
        for f in ("commit_len", "root_token", "pending_tokens",
                  "pending_hidden", "n_pending", "root_hidden", "rng"):
            getattr(batched, f)[s].copy_(getattr(state, f)[0])

    def _prefill_one(self, prompt, seed, max_seq=None):
        return self.prefill(self.init_state(seed, max_seq=max_seq), prompt)

    def _zero_template(self) -> EngineState:
        """A cached all-zero one-lane state: the template of fresh lanes
        when serving without a shared prefix."""
        if self._zero_tstate is None:
            self._zero_tstate = self._lane_state([0])
        return self._zero_tstate

    # ---- generate_batch ----------------------------------------------------
    def generate_batch(self, prompts: Sequence, max_new_tokens=None,
                       eos_token_id: int = 2, seed: int = 0):
        """Decode len(prompts) requests in lockstep rounds. Returns
        (outputs, stats); outputs[i] includes prompt i."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        b = len(prompts)
        seeds = [seed + i for i in range(b)]
        batched = self._stack_states(
            [self._prefill_one(p, s) for p, s in zip(prompts, seeds)], seeds)
        outs = [_ints(p) for p in prompts]
        new_tokens = [0] * b
        done = [False] * b
        rounds = 0
        while not all(done):
            batched, acc, n_acc = self._lane_round(batched)
            rounds += 1
            # the round's one host read
            rows = torch.cat([n_acc[:, None], acc], dim=1).tolist()
            for i in range(b):
                if done[i]:
                    continue
                for t in rows[i][1:1 + rows[i][0]]:
                    outs[i].append(t)
                    new_tokens[i] += 1
                    if t == eos_token_id or new_tokens[i] >= max_new:
                        done[i] = True
                        break
        total = sum(new_tokens)
        return outs, {"new_tokens": total, "rounds": rounds,
                      "per_request": new_tokens,
                      "accept_per_round": total / max(rounds * b, 1)}

    def generate_batch_fused(self, prompts: Sequence, max_new_tokens=None,
                             eos_token_id: int = 2, seed: int = 0):
        """All requests decoded by the gated lane loop (one CUDA graph a KV
        bucket on the card); a finished lane idles until the slowest is
        done. With cfg.kv_buckets set, all lanes start in the smallest
        bucket that fits the longest prompt and grow together when any
        lane's commit_len passes the bucket's budget."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        b = len(prompts)
        for p in prompts:
            self._check_budget(p, max_new)
        p_max = max(len(_ints(p)) for p in prompts)
        buckets = self._plan_buckets(p_max, max_new)
        seeds = [seed + i for i in range(b)]
        batched = self._stack_states(
            [self._prefill_one(p, s, max_seq=buckets[0])
             for p, s in zip(prompts, seeds)], seeds)
        outs = [_ints(p) for p in prompts]
        new_tokens = [0] * b
        lane_done = [False] * b
        rounds = 0
        for bi, seq in enumerate(buckets):
            if bi:
                batched = _grow_kv(batched, *self._kv_rows(seq))
            # an eos'd lane gets budget 0: it never advances this segment
            remaining = [0 if lane_done[i] else max_new - new_tokens[i]
                         for i in range(b)]
            toks, rnds, done, batched = graphs.lane_decode_loop(
                self, batched, eos_token_id, remaining, seq)
            rounds += max(rnds)
            for i in range(b):
                if lane_done[i]:
                    continue
                for t in toks[i]:
                    outs[i].append(t)
                    new_tokens[i] += 1
                    if t == eos_token_id or new_tokens[i] >= max_new:
                        lane_done[i] = True
                        break
                lane_done[i] = lane_done[i] or done[i]
            if all(d or nt >= max_new
                   for d, nt in zip(lane_done, new_tokens)):
                break
        total = sum(new_tokens)
        return outs, {"new_tokens": total, "rounds": rounds,
                      "per_request": new_tokens,
                      "kv_buckets_used": bi + 1}

    # ---- serve: lane surgery -------------------------------------------
    def _serve_ctx(self, prompts) -> ServeCtx:
        """ServeCtx lanes for `prompts`: (prompt or None, prompt_pos) per
        lane, None an idle lane; prompt_pos > 0 marks a prefix already in
        the lane's KV."""
        p_cap = self.cfg.max_seq_len
        b = len(prompts)
        buf = np.zeros((b, p_cap), np.int32)
        lens, pos, active = [0] * b, [0] * b, [False] * b
        for i, (pr, at) in enumerate(prompts):
            if pr is not None:
                pr = np.asarray(pr, np.int32).reshape(-1)
                buf[i, :len(pr)] = pr
                lens[i], pos[i], active[i] = len(pr), at, True
        dev = self.device
        as_t = lambda x, dt=torch.int32: torch.tensor(x, dtype=dt).to(dev)
        return ServeCtx(prompt_buf=torch.from_numpy(buf).to(dev),
                        prompt_len=as_t(lens), prompt_pos=as_t(pos),
                        active=as_t(active, torch.bool))

    def _prefix_template(self, shared_prefix, seed: int):
        """Prefill the shared prefix once into a template one-lane state
        that stops before `_finish_prefill`: the last prefix chunk's draft
        pairs stay queued with a placeholder in the final slot, where each
        request's first suffix token is patched in. Every serve lane starts
        as a copy; nothing in a round writes below commit_len, so a device
        refill only resets lengths. Cached across calls (the two most
        recent prefixes). Returns (template, prefix_len)."""
        prefix = np.asarray(shared_prefix, np.int32).reshape(-1)
        assert len(prefix) > 0, "shared_prefix must be non-empty"
        key = prefix.tobytes()
        if key in self._prefix_templates:
            self._prefix_templates[key] = self._prefix_templates.pop(key)
        else:
            if len(self._prefix_templates) >= 2:
                self._prefix_templates.pop(next(iter(self._prefix_templates)))
            st, _ = self._prefill_chunks(self.init_state(seed + 777_000),
                                         prefix)
            self._prefix_templates[key] = st
        return self._prefix_templates[key], len(prefix)

    def _template_consts(self, tstate):
        """(tp_commit, tp_draft_len, tp_pt, tp_ph, tp_np) of a one-lane
        template (all zeros without one), 0-d where the JAX package's
        are."""
        t = tstate if tstate is not None else self._zero_template()
        r = lambda x: x.reshape(())
        return (r(t.commit_len), r(t.draft_cache.length),
                t.pending_tokens[0], t.pending_hidden, r(t.n_pending))

    def _lanes_from_template(self, tstate, first_sfx, seeds,
                     views: bool = False) -> EngineState:
        """B template copies: the template's KV rows copied into every lane
        (zeros for the zero template, whose rows are never read), its
        lengths, its pending pairs with each lane's first suffix token
        patched into the placeholder slot (-1: none), one stream a lane.
        `views`: the caches are views of the template's, for a caller that
        only copies from them."""
        t = tstate if tstate is not None else self._zero_template()
        b = len(first_sfx)
        dev = self.device
        sfx = torch.tensor(list(first_sfx), dtype=torch.int32).to(dev)
        ctxn = t.pending_tokens.shape[1]
        slot = torch.arange(ctxn, device=dev)[None, :] == t.n_pending - 1
        placeholder = t.pending_tokens[0, (t.n_pending - 1).clamp_min(0)]
        first = torch.where(sfx >= 0, sfx, placeholder)[:, None]
        pt = torch.where(slot, first, t.pending_tokens)

        def cache(c: KVCache) -> KVCache:
            shape = (c.k.shape[0], b) + c.k.shape[2:]
            if views:
                return KVCache(k=c.k.expand(shape), v=c.v.expand(shape),
                               length=c.length.expand(b))
            if tstate is None:
                return init_kv_cache(shape[0], b, shape[2], shape[3],
                                     shape[4], c.k.dtype, dev)
            return KVCache(k=c.k.expand(shape).clone(),
                           v=c.v.expand(shape).clone(),
                           length=c.length.expand(b).clone())
        rep = lambda x: x.expand(b, *x.shape[1:]).clone()
        return EngineState(
            base_cache=cache(t.base_cache), draft_cache=cache(t.draft_cache),
            commit_len=rep(t.commit_len),
            root_token=torch.where(sfx >= 0, sfx, t.root_token),
            pending_tokens=pt.to(torch.int32),
            pending_hidden=rep(t.pending_hidden),
            n_pending=rep(t.n_pending), root_hidden=rep(t.root_hidden),
            rng=lane_rng(torch.tensor(list(seeds)).to(dev)))

    def _lanes_with_resumes(self, tstate, first_sfx, key_seeds, parked,
                            rollbacks, use_parked) -> EngineState:
        """A mixed initial fill: lanes with use_parked[b] take their stored
        conversation snapshot rolled back to `rollbacks[b]` committed
        tokens (pending pairs cleared, stream reseeded), the others are
        fresh template copies."""
        batched = self._lanes_from_template(tstate, first_sfx, key_seeds)
        for s, (use, st, rb) in enumerate(zip(use_parked, parked,
                                              rollbacks)):
            if use:
                self._write_slot(batched,
                                 self._rolled_back(st, rb, key_seeds[s]), s)
        return batched

    def _rolled_back(self, st: EngineState, keep: int, seed: int):
        """A parked one-lane state with its lengths rolled back to `keep`
        committed tokens, no pending pairs and a fresh stream (the
        resume_and_generate rollback, serve-side)."""
        dev = self.device
        k = torch.full((1,), keep, dtype=torch.int32, device=dev)
        return dataclasses.replace(
            st, base_cache=st.base_cache.with_length(k),
            draft_cache=st.draft_cache.with_length(k), commit_len=k,
            n_pending=torch.zeros_like(k),
            rng=lane_rng(torch.full((1,), seed, device=dev)))

    def _run_boundary(self, r, plan, queue):
        """A host boundary's lane surgery on the serve runner `r` (its
        lanes and loop carry, in place, on the device): snapshot lane
        `pause_idx` first (returned, else None), then per lane `src_sel`
        0 keep, 1 resume the parked (state, ctx, emitted, budget) rolled
        back to `parked_rollback` committed tokens (>= 0) with a stream
        from `parked_seed`, 2 a fresh template copy for queue position
        `fresh_qpos` (first suffix token `fresh_sfx`, stream `fresh_seed`,
        chain start `fresh_pos`)."""
        st, lp = r.state, r.loop
        q_prompts, q_lens, q_budgets = queue
        snap = None
        pi = plan.get("pause_idx", -1)
        if pi >= 0:
            snap = (self._read_slot(st, pi), self._ctx_slot(lp, pi),
                    lp.em[pi].clone(), lp.bud[pi].clone())
        tstate = plan.get("tstate")
        for s, sel in enumerate(plan["src_sel"]):
            if sel == 1:
                p_st, p_ctx, p_em, p_bud = plan["parked"]
                rb = plan.get("parked_rollback", -1)
                if rb >= 0:
                    p_st = self._rolled_back(p_st, rb,
                                             plan.get("parked_seed", 0))
                self._write_slot(st, p_st, s)
                self._write_ctx(lp, s, p_ctx, int(p_em), int(p_bud))
            elif sel == 2:
                qpos = plan["fresh_qpos"][s]
                fresh = self._lanes_from_template(
                    tstate, [plan["fresh_sfx"][s]], [plan["fresh_seed"][s]],
                    views=True)
                self._write_slot(st, fresh, s, payload=tstate is not None)
                qs = max(qpos, 0)
                lp.prompt_buf[s].copy_(q_prompts[qs])
                lp.prompt_len[s].copy_(q_lens[qs])
                lp.prompt_pos[s].fill_(plan["fresh_pos"][s])
                lp.active[s].fill_(qpos >= 0)
                lp.em[s].fill_(0)
                lp.bud[s].copy_(q_budgets[qs])
        return snap

    @staticmethod
    def _ctx_slot(lp, s: int) -> ServeCtx:
        one = lambda x: x[s:s + 1].clone()
        return ServeCtx(prompt_buf=one(lp.prompt_buf),
                        prompt_len=one(lp.prompt_len),
                        prompt_pos=one(lp.prompt_pos),
                        active=one(lp.active))

    @staticmethod
    def _write_ctx(lp, s: int, ctx: ServeCtx, em: int, bud: int) -> None:
        for f in ("prompt_buf", "prompt_len", "prompt_pos", "active"):
            getattr(lp, f)[s].copy_(getattr(ctx, f)[0])
        lp.em[s].fill_(em)
        lp.bud[s].fill_(bud)

    def _check_shared_prefix(self, prompts, shared_prefix):
        """Every prompt must extend the shared prefix by >= 1 token."""
        prefix = np.asarray(shared_prefix, np.int32).reshape(-1)
        for i, p in enumerate(prompts):
            pr = np.asarray(p, np.int32).reshape(-1)
            if len(pr) <= len(prefix) or not np.array_equal(
                    pr[:len(prefix)], prefix):
                raise ValueError(
                    f"prompt {i} does not strictly extend shared_prefix "
                    f"(prompt len {len(pr)}, prefix len {len(prefix)})")

    @staticmethod
    def _detect_shared_prefix(prompts):
        """Longest common prefix of all prompts, capped one token short of
        the shortest prompt; None when empty."""
        if not prompts:
            return None
        arrs = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        cap = min(len(a) for a in arrs) - 1
        if cap <= 0:
            return None
        first = arrs[0][:cap]
        n = cap
        for a in arrs[1:]:
            neq = np.nonzero(a[:n] != first[:n])[0]
            if neq.size:
                n = int(neq[0])
            if n == 0:
                return None
        return first[:n].tolist()

    @staticmethod
    def _queue_schedule(order, budgets, policy: str, start: int = 0):
        """Order queue positions >= `start` by the admission policy: fifo
        (submission order), sjf (smallest budget first), lpt (largest
        first); stable sorts keep equal budgets in FIFO order."""
        if policy == "fifo":
            return order
        head, tail = order[:start], order[start:]
        if policy == "sjf":
            tail = sorted(tail, key=lambda r: budgets[r])
        elif policy == "lpt":
            tail = sorted(tail, key=lambda r: -budgets[r])
        else:
            raise ValueError(f"unknown queue_order {policy!r}")
        return head + tail

    @staticmethod
    def _queue_pad(n_req: int) -> int:
        """The queue capacity for n_req requests: a power of two >= 8, so
        the serve graph is captured once per capacity, not per count."""
        return max(8, 1 << (n_req - 1).bit_length())

    def _serve_key(self, n_req: int, width=None, tree_cfg=None):
        """The key of the serve graph a call with n_req requests replays at
        `width` lanes (batch_size) drafting `tree_cfg` (the engine's)."""
        return ("serve", self.base_kv_len, self.draft_kv_len,
                width or self.batch_size, self._queue_pad(n_req),
                tree_cfg or self.cfg.tree)

    def _serve_lanes(self, width: int, n_pad: int) -> graphs.ServeLanes:
        """The serve buffers of `width` lanes for queue capacity `n_pad`
        (made at their first use, kept for later calls); every width of
        one capacity shares the queue and constants."""
        key = ("serve", self.base_kv_len, self.draft_kv_len, width, n_pad)
        if key not in self._serve_sets:
            share = next((sl.loop for k, sl in self._serve_sets.items()
                          if k[4] == n_pad), None)
            if share is None:       # the first width: a queue of its own
                z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                               device=self.device)
                share = graphs._clone(self._request_loop(
                    self._serve_ctx([(None, 0)]), [-1], [graphs.BIG_BUDGET],
                    0, (z(n_pad, self.cfg.max_seq_len), z(n_pad), z(n_pad)),
                    0, 0, 0, False, None))
            self._serve_sets[key] = graphs.ServeLanes(
                key, self._lane_state([0] * width),
                graphs.serve_loop(width, share))
        return self._serve_sets[key]

    def _resize_lanes(self, src: graphs.ServeLanes, width: int, perm,
                      keep) -> graphs.ServeLanes:
        """The lanes of `src` moved into the `width`-lane buffers
        (`flowspec_tpu/runtime/batched.py:200-222`): lane j takes src lane
        perm[j]; a lane with keep[j] False is deactivated, a placeholder
        whose KV rows are not copied (only a refill makes it busy, which
        resets its lengths; no row of it is read before it is written)."""
        dst = self._serve_lanes(width, src.key[4])
        idx = torch.tensor(perm, dtype=torch.long).to(self.device)
        st, ds = src.state, dst.state
        for f in ("commit_len", "root_token", "pending_tokens",
                  "pending_hidden", "n_pending", "root_hidden", "rng"):
            getattr(ds, f).copy_(getattr(st, f)[idx])
        for c, d in ((st.base_cache, ds.base_cache),
                     (st.draft_cache, ds.draft_cache)):
            d.length.copy_(c.length[idx])
            for j, (pj, kj) in enumerate(zip(perm, keep)):
                if kj:
                    d.k[:, j].copy_(c.k[:, pj])
                    d.v[:, j].copy_(c.v[:, pj])
        for f in graphs.SERVE_LANE_FIELDS:
            getattr(dst.loop, f).copy_(getattr(src.loop, f)[idx])
        dst.loop.active.logical_and_(
            torch.tensor(list(keep)).to(self.device))
        return dst

    def _request_loop(self, bctx: ServeCtx, lane_req, lane_budget, qh: int,
                      queue, n_q: int, eos_token_id: int, seed: int,
                      hold: bool, tstate) -> graphs.ServeLoop:
        """A serve call's loop carry: its lanes' contexts, request ids and
        budgets (nothing emitted), the queue and its constants, the
        template's."""
        dev = self.device
        i32 = lambda x: torch.tensor(x, dtype=torch.int32).to(dev)
        tmpl = self._template_consts(tstate)
        return graphs.ServeLoop(
            prompt_buf=bctx.prompt_buf, prompt_len=bctx.prompt_len,
            prompt_pos=bctx.prompt_pos, active=bctx.active,
            req=i32(lane_req), em=i32([0] * len(lane_req)),
            bud=i32(lane_budget), qh=i32(qh),
            row=torch.zeros((len(lane_req), self.cfg.tree.depth_cap + 2),
                            dtype=torch.int32, device=dev),
            q_prompts=queue[0], q_lens=queue[1], q_budgets=queue[2],
            n_q=i32(n_q), eos_id=i32(eos_token_id), seed=i32(seed),
            hold=torch.tensor(hold).to(dev), tp_commit=tmpl[0],
            tp_draft_len=tmpl[1], tp_pt=tmpl[2], tp_ph=tmpl[3],
            tp_np=tmpl[4])

    # ---- serve ---------------------------------------------------------
    def serve(self, prompts: Sequence, max_new_tokens=None,
              eos_token_id: int = 2, seed: int = 0,
              rounds_per_dispatch: int = 256, queue_order: str = "fifo",
              shared_prefix=None, on_token=None, conversations=None,
              conversation_ids=None):
        """Token-level continuous batching over `batch_size` lanes
        (`flowspec_tpu/runtime/batched.py:989-1288`). Returns outputs in
        `prompts` order and the JAX package's statistics.

        `max_new_tokens`: one budget or one per request. `queue_order`:
        "fifo", "sjf" or "lpt". `shared_prefix`: token ids every prompt
        extends, or "auto" for their longest common prefix; it is
        prefilled once and every lane starts from it. `on_token(request,
        token)` is called for every generated token in emission order, as
        each dispatch's rows are read. `conversations` (a
        `ConversationStore`) with `conversation_ids` (one per prompt):
        a request whose stored history its prompt extends resumes from the
        stored lane state; finished requests' lane states are stored.
        Lane transitions then happen at host boundaries, every
        `rounds_per_dispatch` rounds; stats gain `resumed_turns`."""
        n_req = len(prompts)
        if max_new_tokens is None:
            budgets = [self.cfg.max_new_tokens] * n_req
        elif np.ndim(max_new_tokens) == 0:
            budgets = [int(max_new_tokens)] * n_req
        else:
            budgets = [int(x) for x in max_new_tokens]
            assert len(budgets) == n_req, (len(budgets), n_req)
        b = self.batch_size
        k = max(1, int(rounds_per_dispatch))
        for p, mx in zip(prompts, budgets):
            self._check_budget(p, mx)
        if isinstance(shared_prefix, str):
            if shared_prefix != "auto":
                raise ValueError(f"shared_prefix={shared_prefix!r}: pass "
                                 "token ids or the string \"auto\"")
            shared_prefix = self._detect_shared_prefix(prompts)
        tstate, pfx_len = None, 0
        if shared_prefix is not None:
            self._check_shared_prefix(prompts, shared_prefix)
            tstate, pfx_len = self._prefix_template(shared_prefix, seed)
        conv_mode = conversations is not None
        if conv_mode:
            assert conversation_ids is not None and \
                len(conversation_ids) == n_req, "one id per prompt"
        outs: List[list] = [_ints(p) for p in prompts]
        new_tokens = [0] * n_req
        finished = [False] * n_req
        admit_round = [0] * n_req
        finish_round = [0] * n_req
        resumed_turns = 0

        order = self._queue_schedule(list(range(n_req)), budgets,
                                     queue_order)
        # the device-resident request queue, padded to a capacity bucket
        p_cap = self.cfg.max_seq_len
        n_pad = self._queue_pad(n_req)
        q_np = np.zeros((n_pad, p_cap), np.int32)
        ql_np = np.zeros((n_pad,), np.int32)
        qb_np = np.zeros((n_pad,), np.int32)
        for qpos, r in enumerate(order):
            pr = np.asarray(prompts[r], np.int32).reshape(-1)
            q_np[qpos, :len(pr)] = pr
            ql_np[qpos] = len(pr)
            qb_np[qpos] = budgets[r]
        dev = self.device
        queue = tuple(torch.from_numpy(a).to(dev) for a in (q_np, ql_np,
                                                             qb_np))

        def _resume_keep(r):
            """Committed-token watermark to resume request r from and its
            snapshot, or (-1, None) for a fresh fill."""
            if not conv_mode:
                return -1, None
            ent = conversations.get(conversation_ids[r])
            if ent is None:
                return -1, None
            hist = ent["history"]
            toks = _ints(prompts[r])
            m = min(len(toks) - 1, len(hist))
            lcp = 0
            while lcp < m and toks[lcp] == hist[lcp]:
                lcp += 1
            if lcp < 2:
                return -1, None
            return lcp - 1, ent["state"]

        # initial fill: lanes 0..b-1 take queue entries 0..b-1 (the device
        # refills only on completion); streams keyed by queue position
        slot_q = [s if s < n_req else -1 for s in range(b)]
        lane_np = list(slot_q)
        ctxs, sfx, kseeds, resumes = [], [], [], []
        for s in range(b):
            qp = slot_q[s]
            kseeds.append(seed + (qp if qp >= 0 else 1000 + s))
            pr = (np.asarray(prompts[order[qp]], np.int32).reshape(-1)
                  if qp >= 0 else None)
            keep, rstate = _resume_keep(order[qp]) if qp >= 0 else (-1,
                                                                    None)
            if rstate is not None:
                resumes.append((keep, rstate))
                ctxs.append((pr, keep))
                sfx.append(-1)
                resumed_turns += 1
            else:
                resumes.append(None)
                sfx.append(int(pr[pfx_len]) if pr is not None else -1)
                ctxs.append((pr, pfx_len))
        if any(rz is not None for rz in resumes):
            batched = self._lanes_with_resumes(
                tstate, sfx, kseeds, [rz[1] if rz else None
                                      for rz in resumes],
                [rz[0] if rz else 0 for rz in resumes],
                [rz is not None for rz in resumes])
        elif tstate is None:
            batched = self._lane_state(kseeds)
        else:
            batched = self._lanes_from_template(tstate, sfx, kseeds)
        bctx = self._serve_ctx(ctxs)
        lanes = self._serve_lanes(b, n_pad)
        lanes.load(batched, self._request_loop(
            bctx, lane_np, [budgets[order[qp]] if qp >= 0
                            else graphs.BIG_BUDGET for qp in slot_q],
            min(b, n_req), queue, 0 if conv_mode else n_req, eos_token_id,
            seed, conv_mode, tstate))
        queue = (lanes.loop.q_prompts, lanes.loop.q_lens,
                 lanes.loop.q_budgets)
        qh_host = min(b, n_req)
        d_cap = self.cfg.tree.depth_cap
        dev = self.device

        rounds = 0
        busy_slot_rounds = 0
        first_seen = [-1] * n_req
        for qp in range(min(b, n_req)):
            first_seen[order[qp]] = 0
        tail = b * (d_cap + 2)
        n_active = sum(1 for x in lane_np if x >= 0)
        while not all(finished):
            # one dispatch drafting the tree of its busy-lane count: up to
            # k rounds while any lane is active, one pinned row read a round
            tree = self._serve_tree(n_active)
            lanes.loop.req.copy_(torch.tensor(lane_np, dtype=torch.int32)
                                 .to(dev))
            lanes.loop.qh.fill_(qh_host)
            any_active = bool(lanes.loop.active.any())
            rows = []
            while len(rows) < k and any_active:
                vals = lanes.replay(self, tree)
                rows.append(np.asarray(vals[:tail], np.int64).reshape(
                    b, d_cap + 2))
                any_active = bool(vals[-1])
            n_exec = len(rows)
            assert n_exec > 0, "serve dispatch made no progress"
            lane_np = [int(x) for x in vals[tail:tail + b]]
            qh_host = int(vals[tail + 3 * b])
            for j in range(n_exec):
                for s in range(b):
                    qpos = int(rows[j][s, -1])
                    if qpos < 0:
                        continue
                    rq = order[qpos]
                    if finished[rq]:
                        continue
                    if first_seen[rq] < 0:
                        admit_round[rq] = rounds + j
                        first_seen[rq] = 1
                    busy_slot_rounds += 1
                    for t in rows[j][s, :rows[j][s, -2]]:
                        outs[rq].append(int(t))
                        new_tokens[rq] += 1
                        if on_token is not None:
                            on_token(rq, int(t))
                        if int(t) == eos_token_id or \
                                new_tokens[rq] >= budgets[rq]:
                            finished[rq] = True
                            finish_round[rq] = rounds + j + 1
                            break
            rounds += n_exec
            if conv_mode:
                # held lanes (req <= -2): store the exact finish state,
                # then refill the lane from the queue at this boundary
                for s in range(b):
                    if lane_np[s] > -2:
                        continue
                    rq = order[-2 - lane_np[s]]
                    plan = dict(src_sel=[0] * b, fresh_qpos=[-1] * b,
                                fresh_sfx=[-1] * b, fresh_seed=[0] * b,
                                fresh_pos=[0] * b, pause_idx=s,
                                parked=None, tstate=tstate)
                    lane_np[s] = -1
                    if qh_host < n_req:
                        rn = order[qh_host]
                        keep, rstate = _resume_keep(rn)
                        prn = np.asarray(prompts[rn], np.int32).reshape(-1)
                        if rstate is not None:
                            plan["src_sel"][s] = 1
                            plan["parked"] = (
                                rstate,
                                self._serve_ctx([(prn, keep)]), 0,
                                budgets[rn])
                            plan["parked_rollback"] = keep
                            plan["parked_seed"] = seed + qh_host
                            resumed_turns += 1
                        else:
                            plan["src_sel"][s] = 2
                            plan["fresh_qpos"][s] = qh_host
                            plan["fresh_sfx"][s] = (int(prn[pfx_len])
                                                    if tstate is not None
                                                    else -1)
                            plan["fresh_seed"][s] = seed + qh_host
                            plan["fresh_pos"][s] = pfx_len
                        lane_np[s] = qh_host
                        if first_seen[rn] < 0:
                            admit_round[rn] = rounds
                            first_seen[rn] = 1
                        qh_host += 1
                    snap = self._run_boundary(lanes, plan, queue)
                    conversations.put(conversation_ids[rq], snap[0],
                                      outs[rq])
            n_active = sum(1 for x in lane_np if x >= 0)
        total = sum(new_tokens)
        stats = {"new_tokens": total, "rounds": rounds,
                 "per_request": new_tokens,
                 "latency_rounds": [finish_round[i] - admit_round[i]
                                    for i in range(n_req)],
                 "admit_rounds": admit_round,
                 "accept_per_round": total / max(busy_slot_rounds, 1),
                 "slot_utilization": busy_slot_rounds / max(rounds * b, 1)}
        if conv_mode:
            stats["resumed_turns"] = resumed_turns
        return outs, stats

    # ---- serve_stream --------------------------------------------------
    def serve_stream(self, prompts: Sequence, arrivals_s: Sequence[float],
                     max_new_tokens=None, eos_token_id: int = 2,
                     seed: int = 0, rounds_per_dispatch: int = 8,
                     clock=None, queue_order: str = "fifo",
                     starvation_cap: int | None = None,
                     shared_prefix=None, prefix_overlap: bool = True,
                     preempt_factor: float | None = None,
                     on_token=None):
        """Continuous batching of requests that arrive over time
        (`flowspec_tpu/runtime/batched.py:1291-1728`): request r may be
        admitted `arrivals_s[r]` seconds after serving starts. At each
        dispatch boundary the host reorders the arrived, unadmitted part of
        the queue by `queue_order` (a request a later arrival has jumped
        `starvation_cap` times goes to its front), re-widths the lanes
        (dynamic_batch), and in one `_run_boundary` resumes the parked
        request into a free lane, admits arrivals into idle lanes and, with
        `preempt_factor`, pauses the lane with the most budget left for a
        pending request at least that factor shorter, where the cost model
        says the wait for a free lane exceeds the short request's service
        (one request parked at most; the queue the device may admit from is
        capped while it is). Lanes that free up mid-dispatch take arrivals
        on the device. `rounds_per_dispatch` is the admission granularity.
        `clock` (() -> seconds) replaces the wall clock, as tests do.

        `shared_prefix` (token ids) works as in `serve`; with
        `prefix_overlap` a prefix whose template is not cached builds in a
        thread while the first arrivals are served without it: host
        admissions take it once it lands, in-program refills once every
        lane was filled from it (a dispatch that must first capture its
        graph waits for the build). `on_token` as in `serve`. Returns outputs
        in `prompts` order and the JAX package's statistics, with
        admission and completion latencies in seconds."""
        n_req = len(prompts)
        assert len(arrivals_s) == n_req, (len(arrivals_s), n_req)
        if max_new_tokens is None:
            budgets = [self.cfg.max_new_tokens] * n_req
        elif np.ndim(max_new_tokens) == 0:
            budgets = [int(max_new_tokens)] * n_req
        else:
            budgets = [int(x) for x in max_new_tokens]
        b = self.batch_size
        k = max(1, int(rounds_per_dispatch))
        for p, mx in zip(prompts, budgets):
            self._check_budget(p, mx)
        if isinstance(shared_prefix, str):
            raise ValueError(
                "auto prefix detection needs the full workload upfront; "
                "pass explicit tokens to serve_stream")
        tstate, pfx_len = None, 0
        pfx_thread, pfx_box = None, {}
        if shared_prefix is not None:
            self._check_shared_prefix(prompts, shared_prefix)
            pkey = np.asarray(shared_prefix, np.int32).reshape(-1).tobytes()
            if pkey in self._prefix_templates or not prefix_overlap:
                tstate, pfx_len = self._prefix_template(shared_prefix, seed)
            else:
                def _build():
                    try:
                        pfx_box["t"] = self._prefix_template(shared_prefix,
                                                             seed)
                    except Exception as e:      # re-raised at a boundary
                        pfx_box["err"] = e
                pfx_thread = threading.Thread(target=_build, daemon=True)
                pfx_thread.start()
        # arrival order is the initial queue order; non-fifo policies
        # reorder the arrived segment at the boundaries
        order = sorted(range(n_req), key=lambda r: arrivals_s[r])
        self._queue_schedule([], [], queue_order)    # validate policy name
        outs: List[list] = [_ints(p) for p in prompts]
        new_tokens = [0] * n_req
        finished = [False] * n_req
        admit_round = [-1] * n_req
        finish_round = [0] * n_req
        admit_s = [0.0] * n_req
        finish_s = [0.0] * n_req
        bypass_count = [0] * n_req   # aging state for starvation_cap

        p_cap = self.cfg.max_seq_len
        n_pad = self._queue_pad(n_req)
        q_host = (np.zeros((n_pad, p_cap), np.int32),
                  np.zeros((n_pad,), np.int32),
                  np.zeros((n_pad,), np.int32))
        lanes = self._serve_lanes(b, n_pad)
        queue = (lanes.loop.q_prompts, lanes.loop.q_lens,
                 lanes.loop.q_budgets)

        def _write_queue_rows(lo: int):
            """Rows lo..n_req-1 of the queue from `order`, on the host and
            in place on the device (the captured graphs read them there)."""
            qp, ql, qb = q_host
            for qpos in range(lo, n_req):
                r = order[qpos]
                pr = np.asarray(prompts[r], np.int32).reshape(-1)
                qp[qpos] = 0
                qp[qpos, :len(pr)] = pr
                ql[qpos] = len(pr)
                qb[qpos] = budgets[r]
            for dst, src in zip(queue, q_host):
                dst[lo:].copy_(torch.from_numpy(src[lo:]))

        _write_queue_rows(0)
        t0 = time.perf_counter()
        now = (lambda: time.perf_counter() - t0) if clock is None else clock
        seeds = [seed + 1000 + s for s in range(b)]
        lanes.load(
            self._lane_state(seeds) if tstate is None
            else self._lanes_from_template(tstate, [-1] * b, seeds),
            self._request_loop(self._serve_ctx([(None, 0)] * b), [-1] * b,
                               [graphs.BIG_BUDGET] * b, 0, queue, 0,
                               eos_token_id, seed, False, None))
        lane_np = [-1] * b           # host mirrors: values index `order`
        em_np = [0] * b
        bud_np = [graphs.BIG_BUDGET] * b
        born = [tstate is not None] * b   # lane KV holds the prefix rows
        qh_host = 0
        d_cap = self.cfg.tree.depth_cap
        dev = self.device

        rounds = 0
        busy_slot_rounds = 0
        parked = None   # (state, ctx, em, bud, qpos, born): at most one
        preemptions = 0
        cost_skips = 0
        width_switches = 0
        min_width = b
        cap_rounds = 0
        try:
            while not all(finished):
                t = now()
                n_arrived = sum(1 for r in order if arrivals_s[r] <= t)
                # all lanes idle, nothing parked, nothing arrived: wait for the
                # next arrival instead of spinning empty dispatches
                if (parked is None and n_arrived <= qh_host
                        and all(x < 0 for x in lane_np)):
                    nxt = min((arrivals_s[r] for r in order
                               if arrivals_s[r] > t), default=None)
                    if nxt is None:
                        break
                    if clock is None:
                        time.sleep(max(0.0, nxt - now()))
                    continue
                if queue_order != "fifo" and n_arrived > qh_host:
                    pend = [r for r in order[qh_host:] if arrivals_s[r] <= t]
                    fut = [r for r in order[qh_host:] if arrivals_s[r] > t]
                    if starvation_cap is not None:
                        promoted = [r for r in pend
                                    if bypass_count[r] >= starvation_cap]
                        promoted.sort(key=lambda r: (arrivals_s[r], r))
                        rest = [r for r in pend
                                if bypass_count[r] < starvation_cap]
                        sched = promoted + self._queue_schedule(
                            rest, budgets, queue_order)
                        # bypassed: a later arrival is scheduled ahead of it
                        for i, r in enumerate(sched):
                            if any((arrivals_s[x], x) > (arrivals_s[r], r)
                                   for x in sched[:i]):
                                bypass_count[r] += 1
                    else:
                        sched = self._queue_schedule(pend, budgets,
                                                     queue_order)
                    new_tail = sched + fut
                    if new_tail != order[qh_host:]:
                        order[qh_host:] = new_tail
                        _write_queue_rows(qh_host)
                # the cold prefix template landed?
                if pfx_thread is not None and not pfx_thread.is_alive():
                    pfx_thread.join()
                    if "err" in pfx_box:
                        raise pfx_box["err"]
                    tstate, pfx_len = pfx_box["t"]
                    pfx_thread = None

                # dynamic_batch: the width of the lanes this moment needs
                # (active + pending + one for a parked resume); active lanes
                # move to the front, grown lanes are placeholders
                if self.dynamic_batch:
                    n_act = sum(1 for x in lane_np if x >= 0)
                    want = (n_act + max(0, n_arrived - qh_host)
                            + (1 if parked is not None else 0))
                    w = self._serve_width(want)
                    cur = len(lane_np)
                    if w != cur:
                        src = ([s for s in range(cur) if lane_np[s] >= 0]
                               + [s for s in range(cur) if lane_np[s] < 0])
                        perm = (src + [0] * max(0, w - len(src)))[:w]
                        keep = [i < min(len(src), w) for i in range(w)]
                        lanes = self._resize_lanes(lanes, w, perm, keep)
                        rm = lambda xs, fill: [
                            xs[perm[i]] if keep[i] else fill for i in range(w)]
                        lane_np = rm(lane_np, -1)
                        em_np = rm(em_np, 0)
                        bud_np = rm(bud_np, graphs.BIG_BUDGET)
                        born = rm(born, False)
                        width_switches += 1
                wb = len(lane_np)
                min_width = min(min_width, wb)

                # ---- the boundary plan: one _run_boundary for it all ----
                use_tpl = tstate is not None
                src_sel = [0] * wb
                fresh_qpos, fresh_sfx = [-1] * wb, [-1] * wb
                fresh_seed, fresh_pos = [0] * wb, [0] * wb
                pause_idx, plan_parked, parked_meta = -1, None, None
                changed = False
                if parked is not None:
                    free = [s for s in range(wb) if lane_np[s] == -1]
                    if free:
                        s = free[0]
                        src_sel[s] = 1
                        plan_parked = parked[:4]
                        lane_np[s], em_np[s], bud_np[s] = (
                            parked[4], parked[2], parked[3])
                        born[s] = parked[5]
                        parked = None
                        changed = True
                for s in range(wb):
                    if lane_np[s] != -1 or qh_host >= n_arrived:
                        continue
                    r = order[qh_host]
                    pr = np.asarray(prompts[r], np.int32).reshape(-1)
                    src_sel[s] = 2
                    fresh_qpos[s] = qh_host
                    fresh_sfx[s] = int(pr[pfx_len]) if use_tpl else -1
                    fresh_seed[s] = seed + qh_host
                    fresh_pos[s] = pfx_len if use_tpl else 0
                    born[s] = use_tpl
                    lane_np[s], em_np[s], bud_np[s] = qh_host, 0, budgets[r]
                    qh_host += 1
                    changed = True
                # preemption: every lane busy, work pending, nothing parked,
                # the trigger and the cost model both pass; a lane this
                # boundary fills is no victim (its snapshot would be stale)
                victims = [s for s in range(wb) if src_sel[s] == 0]
                if (preempt_factor is not None and parked is None
                        and qh_host < n_arrived and victims
                        and all(x >= 0 for x in lane_np)):
                    accept_est = max(
                        sum(new_tokens) / busy_slot_rounds, 0.5) \
                        if busy_slot_rounds else 1.0
                    remaining = [bud_np[s] - em_np[s] for s in range(wb)]
                    v = max(victims, key=lambda s: remaining[s])
                    r = order[qh_host]
                    suffix = max(len(np.asarray(prompts[r]).reshape(-1))
                                 - (pfx_len if use_tpl else 0), 1)
                    service = (math.ceil(suffix / d_cap)
                               + math.ceil(budgets[r] / accept_est)
                               + OVERHEAD_ROUNDS)
                    rounds_to_free = min(remaining) / accept_est
                    if budgets[r] * preempt_factor <= remaining[v]:
                        if rounds_to_free > service:
                            pause_idx = v
                            parked_meta = (lane_np[v], em_np[v], bud_np[v],
                                           born[v])
                            pr = np.asarray(prompts[r], np.int32).reshape(-1)
                            src_sel[v] = 2
                            fresh_qpos[v] = qh_host
                            fresh_sfx[v] = int(pr[pfx_len]) if use_tpl else -1
                            fresh_seed[v] = seed + qh_host
                            fresh_pos[v] = pfx_len if use_tpl else 0
                            born[v] = use_tpl
                            lane_np[v], em_np[v], bud_np[v] = (
                                qh_host, 0, budgets[r])
                            qh_host += 1
                            preemptions += 1
                            changed = True
                        else:
                            cost_skips += 1
                if changed:
                    snap = self._run_boundary(
                        lanes, dict(src_sel=src_sel, fresh_qpos=fresh_qpos,
                                    fresh_sfx=fresh_sfx, fresh_seed=fresh_seed,
                                    fresh_pos=fresh_pos, pause_idx=pause_idx,
                                    parked=plan_parked,
                                    tstate=tstate if use_tpl else None), queue)
                    if snap is not None:
                        parked = (snap[0], snap[1], parked_meta[1],
                                  parked_meta[2], parked_meta[0],
                                  parked_meta[3])
                for qpos in range(qh_host):
                    r = order[qpos]
                    if admit_round[r] < 0:
                        admit_round[r] = rounds
                        admit_s[r] = now()

                # one dispatch; while a request is parked the device admits
                # nothing past the head, so the next freed lane is its
                n_q_pass = qh_host if parked is not None else n_arrived
                tree = self._serve_tree(sum(1 for x in lane_np if x >= 0))
                if pfx_thread is not None and not lanes.ready(self, tree):
                    pfx_thread.join()   # no capture beside the build
                all_born = use_tpl and all(born)
                lp = lanes.loop
                for dst, v in zip((lp.tp_commit, lp.tp_draft_len, lp.tp_pt,
                                   lp.tp_ph, lp.tp_np), self._template_consts(
                                       tstate if all_born else None)):
                    dst.copy_(v)
                lp.req.copy_(torch.tensor(lane_np, dtype=torch.int32).to(dev))
                lp.qh.fill_(qh_host)
                lp.n_q.fill_(n_q_pass)
                pre_lane = list(lane_np)
                tail = wb * (d_cap + 2)
                any_active = bool(lp.active.any())
                rows = []
                vals = None
                while len(rows) < k and any_active:
                    vals = lanes.replay(self, tree)
                    rows.append(np.asarray(vals[:tail], np.int64).reshape(
                        wb, d_cap + 2))
                    any_active = bool(vals[-1])
                n_exec = len(rows)
                if vals is None:
                    vals = lanes.readback()
                lane_np = [int(x) for x in vals[tail:tail + wb]]
                em_np = [int(x) for x in vals[tail + wb:tail + 2 * wb]]
                bud_np = [int(x) for x in vals[tail + 2 * wb:tail + 3 * wb]]
                qh_host = int(vals[tail + 3 * wb])
                if not all_born:
                    # refills on the device ran with the zero template: a lane
                    # it refilled no longer holds the prefix rows
                    for s in range(wb):
                        if lane_np[s] != pre_lane[s]:
                            born[s] = False
                t_end = now()
                cap_rounds += n_exec * wb
                for j in range(n_exec):
                    for s in range(wb):
                        qpos = int(rows[j][s, -1])
                        if qpos < 0:
                            continue
                        r = order[qpos]
                        if finished[r]:
                            continue
                        if admit_round[r] < 0:     # admitted on the device
                            admit_round[r] = rounds + j
                            admit_s[r] = t_end
                        busy_slot_rounds += 1
                        for tk in rows[j][s, :rows[j][s, -2]]:
                            outs[r].append(int(tk))
                            new_tokens[r] += 1
                            if on_token is not None:
                                on_token(r, int(tk))
                            if int(tk) == eos_token_id or \
                                    new_tokens[r] >= budgets[r]:
                                finished[r] = True
                                finish_round[r] = rounds + j + 1
                                finish_s[r] = t_end
                                break
                rounds += n_exec
                if n_exec == 0 and clock is not None:
                    continue    # a fake clock: let the caller advance it
        finally:
            # the build never outlives the call (nor runs beside a
            # capture of a later one)
            if pfx_thread is not None:
                pfx_thread.join()
        if pfx_box.get("err") is not None:
            raise pfx_box["err"]
        lat_admit = [admit_s[r] - arrivals_s[r] for r in range(n_req)]
        lat_total = [finish_s[r] - arrivals_s[r] for r in range(n_req)]
        q = lambda xs, p_: float(np.percentile(np.asarray(xs), p_))
        total = sum(new_tokens)
        return outs, {
            "new_tokens": total, "rounds": rounds,
            "per_request": new_tokens,
            "latency_rounds": [finish_round[r] - admit_round[r]
                               for r in range(n_req)],
            "admit_rounds": admit_round,
            "admission_s": lat_admit,
            "completion_s": lat_total,
            "preemptions": preemptions,
            "preempt_cost_skips": cost_skips,
            "width_switches": width_switches,
            "min_width": min_width,
            "accept_per_round": total / max(busy_slot_rounds, 1),
            "admission_p50_s": q(lat_admit, 50),
            "admission_p95_s": q(lat_admit, 95),
            "completion_p50_s": q(lat_total, 50),
            "completion_p95_s": q(lat_total, 95),
            "slot_utilization": busy_slot_rounds / max(cap_rounds, 1)}

    def warmup(self, n_requests: int = 8, shared_prefix=None):
        """Prepare what a `serve` or `serve_stream` call of `n_requests`
        requests will use, so that it captures nothing: for that request
        count's queue capacity, the serve graph of every (width, tree
        variant) the engine can pick (one width without dynamic_batch, one
        variant without dynamic_tree; on the card each is captured now, over
        its width's buffers) and, given `shared_prefix`, that prefix's
        template, cached for later calls. Returns the serve graph keys."""
        if shared_prefix is not None:
            self._prefix_template(shared_prefix, 0)
        b = self.batch_size
        n_pad = self._queue_pad(max(1, n_requests))
        widths = ({self._serve_width(n) for n in range(1, b + 1)}
                  if self.dynamic_batch else {b})
        keys = []
        for w in sorted(widths):
            lanes = self._serve_lanes(w, n_pad)
            for n in range(1, w + 1):
                tree = self._serve_tree(n)
                if lanes.key + (tree,) not in keys:
                    lanes.graph(self, tree)
                    keys.append(lanes.key + (tree,))
        return keys
