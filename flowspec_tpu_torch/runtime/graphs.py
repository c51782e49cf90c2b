"""The fused decode loops: the round as a CUDA graph over device-resident
lengths.

Port of `flowspec_tpu/runtime/engine.py:831-911` (`_spec_decode_loop`,
`_ar_decode_loop`). The JAX package runs the whole decode as one
`lax.while_loop` on the device. Here the loop body is one
`SpecEngine._round` (or `_ar` step) plus the bookkeeping of `:863-888`:
the accepted tokens go into a device `out_buf` at `n_out`, then `n_out`,
`done` (EOS) and `rounds` advance, all in place. On the card that body is
captured once per KV bucket (the engine keys its graphs by the kind and
the caches' rows; the output buffer is sized for any request the engine
takes) into a `torch.cuda.CUDAGraph` over static buffers, and the body writes the new state back into them with
`copy_`, so the next replay reads it. The host replays and reads one small
pinned buffer a replay (n_out, done, commit_len), and stops on the JAX
loop's condition `~done & (n_out < budget) & (commit_len <= commit_cap)`.
On the CPU the same body runs without capture, reading the same values.

Capture follows one eager run of the body on the graph's buffers, which
are then loaded again from the request's state: the kernels build at their
first launch (`ops/_build.py`), and so do their plans and their opt-ins to
large shared memory. A kernel wrapper counts a launch when its Python code
issues it, which under capture is once for all replays; so the capture's
counts (and the dequant-matmuls' `fixup_tiles`) are kept as the graph's
own, per replay, and taken back from the wrappers, and each replay adds
them again. The graphs of one engine share one memory pool: they run one
at a time, and what a body leaves for the next one lives in the static
buffers, outside the pool.

Lanes (`runtime/batched.py`). Two more bodies run the round over B lanes:
`_lane_body`, the counterpart of `_spec_decode_loop(gate_lanes=True)`
under vmap (`flowspec_tpu/runtime/engine.py:831-891`: a lane past its
budget, EOS or commit cap stops advancing while the others go on, and the
host replays until no lane is active), and `_serve_body`, the counterpart
of the serve scan's body (`flowspec_tpu/runtime/batched.py:310-406`): the
round over mixed prompt-chain and decoding lanes, the packed row of the
round, and the refill of finished lanes from a device-resident request
queue (the lanes' lengths reset to the prefix template's, the first suffix
token patched into the pending pairs, a fresh draw stream keyed by the
seed and the queue position). The lane loop is captured once per (kind, KV
rows, lanes). The serve body runs over `ServeLanes`, the static buffers of
one width for one (KV rows, queue capacity), whose request queue and
constants every width shares; it is captured once per tree variant over
those same buffers (`DecodeGraph(shared=True)`), so a dynamic tree's
switch of variant replays another graph on the same state and copies
nothing. Both read one small pinned row a replay.

No capture runs beside another thread's launches (`serve_stream` joins its
prefix-template thread before a dispatch that would capture): a capture
tallies the process-wide launch counters, and a CUDA call from another
thread may break it. Nor does the cyclic garbage collector run inside a
capture: a CUDA graph it frees there aborts the process.

A capture that fails raises: there is no fallback to the eager loop.

With the recorder on (`utils/profiler.py prof.enabled`), a segment of
`spec_decode_loop` records `segment.load` (its carry made, the first read,
the graph found or captured and loaded), a `round` span a replay (launch,
sync, read; on the card with the graph's device ms and the device's idle
since the previous round's graph ended, from a pair of timing events a
round of the segment, kept by the graph and reused) and `segment.read`
(the end reads); a capture records `capture`. The rounds' events are read
and their spans written after the segment's last replay (`_replays`), so
none of that host work lies between two rounds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import time

import torch

from flowspec_tpu_torch.models.kv_cache import KVCache
from flowspec_tpu_torch.ops import counted_wrappers
from flowspec_tpu_torch.utils.profiler import prof, timing_events


@dataclasses.dataclass
class LoopBuffers:
    """The decode loop's carry besides the engine state, on the device."""
    out_buf: torch.Tensor   # (cap + 1,) int32; slot cap takes the padding
    n_out: torch.Tensor     # () int32 tokens written
    done: torch.Tensor      # () bool an EOS was written
    rounds: torch.Tensor    # () int32 bodies run
    eos_id: torch.Tensor    # () int32 (< 0: none)


def _loop_buffers(cap: int, eos_id: int, device) -> LoopBuffers:
    z = lambda dt: torch.zeros((), dtype=dt, device=device)
    return LoopBuffers(
        out_buf=torch.zeros((cap + 1,), dtype=torch.int32, device=device),
        n_out=z(torch.int32), done=z(torch.bool), rounds=z(torch.int32),
        eos_id=torch.full((), eos_id, dtype=torch.int32, device=device))


def _spec_body(eng, st, lp: LoopBuffers):
    """One speculative round and the JAX loop body's bookkeeping
    (`flowspec_tpu/runtime/engine.py:863-888`, gate_lanes=False: the host
    checks the loop condition before every body)."""
    st2, accepted, n_acc = eng._round(st)
    cap = lp.out_buf.shape[0] - 1
    d_idx = torch.arange(accepted.shape[0], device=accepted.device)
    pv = d_idx < n_acc
    wpos = torch.where(pv, lp.n_out + d_idx, cap)
    lp.out_buf.index_copy_(0, wpos, torch.where(pv, accepted, 0))
    lp.n_out.add_(n_acc)
    lp.done.logical_or_((pv & (accepted == lp.eos_id)
                         & (lp.eos_id >= 0)).any())
    lp.rounds.add_(1)
    return st2


def _ar_body(eng, st, lp: LoopBuffers):
    """One autoregressive step and its bookkeeping (`:894-911`)."""
    tok = st.root_token
    lp.out_buf.index_copy_(0, lp.n_out.long().view(1), tok.view(1))
    st2, _ = eng._ar(st)
    lp.n_out.add_(1)
    lp.done.logical_or_(((tok == lp.eos_id) & (lp.eos_id >= 0)).any())
    lp.rounds.add_(1)
    return st2


def _readback(st, lp: LoopBuffers) -> torch.Tensor:
    """(n_out, done, commit_len): what the host's loop condition reads."""
    return torch.stack([lp.n_out, lp.done.to(torch.int32),
                        st.commit_len.reshape(()).to(torch.int32)])


@dataclasses.dataclass
class LaneLoop:
    """The gated lane loop's carry besides the lane state, on the device:
    per lane the output buffer, the tokens written, EOS, rounds run and the
    token budget; the EOS id and the commit cap of the KV bucket."""
    out_buf: torch.Tensor     # (B, cap + 1) int32; slot cap takes padding
    n_out: torch.Tensor       # (B,) int32
    done: torch.Tensor        # (B,) bool
    rounds: torch.Tensor      # (B,) int32
    budget: torch.Tensor      # (B,) int32
    eos_id: torch.Tensor      # () int32 (< 0: none)
    commit_cap: torch.Tensor  # () int32


def _lane_active(st, lp: LaneLoop) -> torch.Tensor:
    """(B,) the JAX loop condition of each lane."""
    return ~lp.done & (lp.n_out < lp.budget) & (st.commit_len
                                                 <= lp.commit_cap)


def _lane_body(eng, st, lp: LaneLoop):
    """One round over the lanes with the vmapped loop body's bookkeeping
    (`flowspec_tpu/runtime/engine.py:863-885`, gate_lanes=True): a lane
    whose condition fails keeps its state and writes nothing."""
    active = _lane_active(st, lp)
    st2, accepted, n_acc = eng._lane_round(st, live=active)
    cap = lp.out_buf.shape[1] - 1
    d_idx = torch.arange(accepted.shape[1], device=accepted.device)
    pv = active[:, None] & (d_idx < n_acc[:, None])
    wpos = torch.where(pv, lp.n_out[:, None] + d_idx, cap).long()
    lp.out_buf.scatter_(1, wpos, torch.where(pv, accepted, 0))
    lp.n_out.add_(torch.where(active, n_acc, 0))
    lp.done.logical_or_((pv & (accepted == lp.eos_id)
                         & (lp.eos_id >= 0)).any(dim=1))
    lp.rounds.add_(active.to(torch.int32))
    return st2


def _lane_readback(st, lp: LaneLoop) -> torch.Tensor:
    """(1,): whether any lane is still active."""
    return _lane_active(st, lp).any().to(torch.int32).reshape(1)


@dataclasses.dataclass
class ServeLoop:
    """The serve body's carry besides the lane state, on the device: the
    lanes' `ServeCtx` fields, request ids (-1 idle, <= -2 held for a host
    snapshot), tokens emitted and budgets, the queue head, the last round's
    packed row; the request queue and its constants; the prefix template's
    lengths and pending pairs (zeros without a shared prefix)."""
    prompt_buf: torch.Tensor   # (B, P) int32
    prompt_len: torch.Tensor   # (B,) int32
    prompt_pos: torch.Tensor   # (B,) int32
    active: torch.Tensor       # (B,) bool
    req: torch.Tensor          # (B,) int32 queue position a lane serves
    em: torch.Tensor           # (B,) int32
    bud: torch.Tensor          # (B,) int32
    qh: torch.Tensor           # () int32 next queue position
    row: torch.Tensor          # (B, depth_cap + 2) int32: tokens, n, req
    q_prompts: torch.Tensor    # (Q, P) int32
    q_lens: torch.Tensor       # (Q,) int32
    q_budgets: torch.Tensor    # (Q,) int32
    n_q: torch.Tensor          # () int32 requests the device may admit
    eos_id: torch.Tensor       # () int32
    seed: torch.Tensor         # () int32
    hold: torch.Tensor         # () bool: park finished lanes, no refill
    tp_commit: torch.Tensor    # () int32
    tp_draft_len: torch.Tensor  # () int32
    tp_pt: torch.Tensor        # (CTX,) int32
    tp_ph: torch.Tensor        # (1, CTX, H)
    tp_np: torch.Tensor        # () int32

    def ctx(self):
        from flowspec_tpu_torch.runtime.engine import ServeCtx
        return ServeCtx(prompt_buf=self.prompt_buf,
                        prompt_len=self.prompt_len,
                        prompt_pos=self.prompt_pos, active=self.active)


BIG_BUDGET = 2 ** 30


def _serve_body(eng, st, lp: ServeLoop, tree_cfg=None):
    """One serve round (`flowspec_tpu/runtime/batched.py:310-406`): lanes
    past the KV headroom freeze, the round runs over chain and decoding
    lanes (drafting `tree_cfg`, the engine's tree when None), its packed
    row is recorded before the refill, then every lane whose request
    finished (budget or EOS; not held) or that idles takes the next queued
    request, on the device."""
    from flowspec_tpu_torch.runtime.engine import (
        EngineState, ServeCtx, select_lanes,
    )
    from flowspec_tpu_torch.tree.sampling import lane_rng
    d_cap = eng.cfg.tree.depth_cap
    seq_limit = eng.cfg.max_seq_len - d_cap - 1
    b, p_cap = lp.prompt_buf.shape
    n_pad = lp.q_prompts.shape[0]
    dev = lp.prompt_buf.device
    ctx = lp.ctx()
    ok = st.commit_len <= seq_limit
    st3, accepted, n_emit, ctx2 = eng._lane_round(st, serve=ctx, live=ok,
                                                  tree_cfg=tree_cfg)
    ctx3 = select_lanes(ok, ctx2, ctx)
    n_j = torch.where(ok, n_emit, 0)
    valid = torch.arange(d_cap, device=dev)[None, :] < n_j[:, None]
    eos_hit = (valid & (accepted == lp.eos_id) & (lp.eos_id >= 0)).any(1)
    req = lp.req
    em2 = lp.em + n_j
    fin = (req >= 0) & (eos_hit | (em2 >= lp.bud))
    held = fin & lp.hold
    free = (fin & ~lp.hold) | ((req == -1) & ~ctx3.active)
    # record before the refill: this round's tokens belong to the
    # finishing request
    row = torch.cat([accepted, n_j[:, None], req[:, None]], dim=1)

    # ---- the refill, on the device --------------------------------------
    qidx = lp.qh + torch.cumsum(free.to(torch.int32), 0) - 1
    has = free & (qidx < lp.n_q)
    qsafe = qidx.clamp(0, n_pad - 1).long()
    req2 = torch.where(free, torch.where(has, qidx, -1),
                       torch.where(held, -2 - req, req)).to(torch.int32)
    em3 = torch.where(free, 0, em2)
    bud2 = torch.where(free, torch.where(has, lp.q_budgets[qsafe],
                                         BIG_BUDGET), lp.bud)
    qh2 = lp.qh + has.to(torch.int32).sum()
    q_rows = lp.q_prompts[qsafe]                                # (B, P)
    tp_commit = lp.tp_commit.reshape(1).expand(b)
    ctx4 = select_lanes(free, ServeCtx(
        prompt_buf=q_rows, prompt_len=lp.q_lens[qsafe],
        prompt_pos=tp_commit, active=has), dataclasses.replace(
        ctx3, active=ctx3.active & ~held))
    # the lanes' state resets to the prefix template (all zero without a
    # shared prefix): lengths back to its watermark, its pending pairs with
    # the request's first suffix token patched into the root slot, a fresh
    # draw stream. KV rows stay: rows below the watermark hold the prefix
    # (written once, never touched), rows past the length are masked.
    first_sfx = torch.gather(q_rows, 1, lp.tp_commit.clamp(0, p_cap - 1)
                             .long().reshape(1, 1).expand(b, 1))[:, 0]
    ctxn = lp.tp_pt.shape[0]
    patched_pt = torch.where(
        torch.arange(ctxn, device=dev)[None, :] == lp.tp_np - 1,
        first_sfx[:, None], lp.tp_pt[None, :])
    fresh = EngineState(
        base_cache=st3.base_cache.with_length(tp_commit),
        draft_cache=st3.draft_cache.with_length(
            lp.tp_draft_len.reshape(1).expand(b)),
        commit_len=tp_commit,
        root_token=torch.where(has, first_sfx, 0).to(torch.int32),
        pending_tokens=patched_pt.to(torch.int32),
        pending_hidden=lp.tp_ph.expand_as(st3.pending_hidden),
        n_pending=lp.tp_np.reshape(1).expand(b),
        root_hidden=torch.zeros_like(st3.root_hidden),
        rng=lane_rng(lp.seed + req2.clamp_min(0)))
    st4 = select_lanes(free, fresh, st3)
    for dst, src in ((lp.prompt_buf, ctx4.prompt_buf),
                     (lp.prompt_len, ctx4.prompt_len),
                     (lp.prompt_pos, ctx4.prompt_pos),
                     (lp.active, ctx4.active), (lp.req, req2),
                     (lp.em, em3), (lp.bud, bud2), (lp.qh, qh2),
                     (lp.row, row)):
        dst.copy_(src)
    return st4


def _serve_readback(st, lp: ServeLoop) -> torch.Tensor:
    """The packed row, then req, em and bud of every lane, the queue head
    and whether any lane is active: B * (depth_cap + 5) + 2 int32."""
    return torch.cat([lp.row.reshape(-1), lp.req, lp.em, lp.bud,
                      lp.qh.reshape(1),
                      lp.active.any().to(torch.int32).reshape(1)])


# the ServeLoop fields of each lane; the others (the queue head, the queue,
# its constants and the template's) are one for every width
SERVE_LANE_FIELDS = ("prompt_buf", "prompt_len", "prompt_pos", "active",
                     "req", "em", "bud", "row")


def serve_loop(b: int, share: ServeLoop) -> ServeLoop:
    """An idle ServeLoop of `b` lanes whose queue head, queue and constants
    are `share`'s tensors (so one in-place write reaches every width)."""
    p_cap, dev = share.prompt_buf.shape[1], share.prompt_buf.device
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    return dataclasses.replace(
        share, prompt_buf=z(b, p_cap), prompt_len=z(b), prompt_pos=z(b),
        active=torch.zeros((b,), dtype=torch.bool, device=dev),
        req=torch.full((b,), -1, dtype=torch.int32, device=dev), em=z(b),
        bud=torch.full((b,), BIG_BUDGET, dtype=torch.int32, device=dev),
        row=z(b, share.row.shape[1]))


def _fields(x, payload: bool = True):
    """The tensors of an engine state or loop carry, in field order (a KV
    cache gives its row buffers and length; only its length without
    `payload`)."""
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, KVCache):
            yield from ((*v.buffers, v.length) if payload
                        else (v.length,))
        elif isinstance(v, torch.Tensor):
            yield v


def _clone(x):
    """`x` with every tensor field (and KV cache) copied."""
    def one(v):
        if isinstance(v, KVCache):
            return KVCache(k=v.k.clone(),
                           v=None if v.v is None else v.v.clone(),
                           length=v.length.clone())
        return v.clone() if isinstance(v, torch.Tensor) else v
    return dataclasses.replace(x, **{f.name: one(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


def _load(dst, src) -> None:
    """Copy every tensor of `src` into the same field of `dst` (same
    shapes), skipping a field that is already the same tensor."""
    for a, b in zip(_fields(dst), _fields(src)):
        if a is not b:
            a.copy_(b)


@contextlib.contextmanager
def _no_cyclic_gc():
    """The cyclic garbage collector off: freeing a CUDA graph (say, of an
    engine dropped in a reference cycle) inside a capture aborts the
    process, and a collection may start at any allocation."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


class DecodeGraph:
    """One decode-loop body captured over static buffers: `state` and
    `loop` (cloned from the first request that needed it, or with `shared`
    the buffers given, which other graphs read too; the draw streams are
    state tensors like any other), `host` (pinned, what `readback` gives),
    `launches` {kernel: launches a replay}, `fixup_tiles` {dequant-matmul:
    split tiles a replay finishes}, `capture_s` (warm-up and capture,
    seconds: the `capture` span's interval).

    The warm-up body runs on the static buffers before the capture. A body
    writes KV rows only at or past each lane's length (a stopped lane: its
    scratch row), and those are written again before they are read; so
    over shared buffers the warm-up is undone by restoring every other
    field, and no KV is copied."""

    def __init__(self, eng, body, state, loop, readback=_readback,
                 shared: bool = False):
        t0 = time.time_ns()
        sp = prof.open("capture", t0) if prof.enabled else -1
        self.device = dev = state.commit_len.device
        self._events = []       # the recorder's (start, end) a round
        self._stream = None     # and the stream it records them on
        if shared:
            self.state, self.loop = state, loop
            saved = [t.clone() for t in self._carry()]
        else:
            self.state, self.loop = _clone(state), _clone(loop)
        self.host = torch.zeros((readback(state, loop).numel(),),
                                dtype=torch.int32, pin_memory=True)
        wrappers = counted_wrappers()
        with _no_cyclic_gc():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), torch.no_grad():
                body(eng, self.state, self.loop)      # the warm-up body
            torch.cuda.current_stream(dev).wait_stream(side)
            if shared:
                for a, b in zip(self._carry(), saved):
                    a.copy_(b)
            else:
                self.load(state, loop)
            before = {n: fn.launches for n, fn in wrappers.items()}
            fixed = {n: fn.fixup_tiles for n, fn in wrappers.items()
                     if hasattr(fn, "fixup_tiles")}
            self.graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(self.graph,
                                                   pool=eng._graph_pool):
                _load(self.state, body(eng, self.state, self.loop))
                self.host.copy_(readback(self.state, self.loop),
                                non_blocking=True)
        self.launches = {n: fn.launches - before[n]
                         for n, fn in wrappers.items()
                         if fn.launches != before[n]}
        self.fixup_tiles = {n: wrappers[n].fixup_tiles - k
                            for n, k in fixed.items()
                            if wrappers[n].fixup_tiles != k}
        for n, fn in wrappers.items():
            fn.launches = before[n]
        for n, k in fixed.items():
            wrappers[n].fixup_tiles = k
        eng._graph_pool = self.graph.pool()
        torch.cuda.synchronize(dev)
        t1 = time.time_ns()
        if sp >= 0:
            prof.close(sp, t1)
        self.capture_s = (t1 - t0) / 1e9

    def _carry(self):
        """Every buffer but the KV rows."""
        return [*_fields(self.state, payload=False), *_fields(self.loop)]

    def load(self, state, loop) -> None:
        """Copy a request's state and loop carry into the static buffers."""
        _load(self.state, state)
        _load(self.loop, loop)

    def replay(self) -> list:
        """Run the body once; returns what `readback` reads (for the
        single-request loops [n_out, done, commit_len])."""
        self.graph.replay()
        return self._read()

    def _read(self) -> list:
        torch.cuda.current_stream(self.device).synchronize()
        wrappers = counted_wrappers()
        for n, k in self.launches.items():
            wrappers[n].launches += k
        for n, k in self.fixup_tiles.items():
            wrappers[n].fixup_tiles += k
        return self.host.tolist()

    def replay_timed(self, k: int) -> list:
        """`replay` between the timing events of round `k` of a segment
        (made at the first segment that reaches `k` rounds, then reused);
        `record_rounds` reads them."""
        if k == 0:
            self._stream = torch.cuda.current_stream(self.device)
        if k == len(self._events):
            self._events.append(timing_events(2))
        start, end = self._events[k]
        start.record(self._stream)
        self.graph.replay()
        end.record(self._stream)
        return self._read()

    def record_rounds(self, times: list) -> None:
        """Record a segment's rounds, replayed by `replay_timed` at host
        times `times` [(t0_ns, t1_ns)], as `round` spans: `device_ms` from
        the event before the graph to the one after it, `gap_ms` from the
        previous round's end event to this start (none for the first)."""
        prev = None
        for (t0, t1), (start, end) in zip(times, self._events):
            prof.add("round", t0, t1, start.elapsed_time(end),
                     None if prev is None else prev.elapsed_time(start))
            prev = end


class EagerBody:
    """The CPU's counterpart of a `DecodeGraph`: the same body run on
    `state` and `loop` themselves, with the same `replay` and `load`."""

    def __init__(self, eng, body, state, loop, readback=_readback):
        self.eng, self.body, self.readback = eng, body, readback
        self.state, self.loop = state, loop

    def load(self, state, loop) -> None:
        self.state, self.loop = state, loop

    def replay(self) -> list:
        self.state = self.body(self.eng, self.state, self.loop)
        return self.readback(self.state, self.loop).tolist()

    def replay_timed(self, k: int) -> list:
        return self.replay()

    def record_rounds(self, times: list) -> None:
        for t0, t1 in times:
            prof.add("round", t0, t1)


class ServeLanes:
    """The serve body's static buffers for one width: a lane `state` and a
    `loop` whose queue head, queue and constants every width of the same
    (KV rows, queue capacity) shares. `key` is ("serve", base rows, draft
    rows, width, queue capacity); a graph's key adds its tree variant. On
    the card each variant's graph is captured over these buffers at its
    first use and kept in the engine's graphs; on the CPU the body runs on
    them. (The engine keeps its ServeLanes, so they take it as an argument
    rather than hold it: no reference cycle keeps a dropped engine's
    graphs for the cyclic collector.)"""

    def __init__(self, key, state, loop: ServeLoop):
        self.key, self.state, self.loop = key, state, loop

    def load(self, state, loop: ServeLoop) -> None:
        """Copy a request's lane state and loop carry into the buffers."""
        _load(self.state, state)
        _load(self.loop, loop)

    def ready(self, eng, tree_cfg) -> bool:
        """Whether a round drafting `tree_cfg` runs without a capture."""
        return (self.state.commit_len.device.type != "cuda"
                or self.key + (tree_cfg,) in eng._graphs)

    def graph(self, eng, tree_cfg):
        """The graph of the body drafting `tree_cfg` over these buffers
        (captured now if it is new); None on the CPU."""
        if self.state.commit_len.device.type != "cuda":
            return None
        key = self.key + (tree_cfg,)
        g = eng._graphs.get(key)
        if g is None:
            g = eng._graphs[key] = DecodeGraph(
                eng, functools.partial(_serve_body, tree_cfg=tree_cfg),
                self.state, self.loop, _serve_readback, shared=True)
        return g

    def replay(self, eng, tree_cfg) -> list:
        """One serve round drafting `tree_cfg`; returns `_serve_readback`."""
        g = self.graph(eng, tree_cfg)
        if g is not None:
            return g.replay()
        self.state = _serve_body(eng, self.state, self.loop, tree_cfg)
        return self.readback()

    def readback(self) -> list:
        return _serve_readback(self.state, self.loop).tolist()


def runner(eng, key, body, state, loop, readback=_readback):
    """The engine's graph for `key` (captured at its first use) loaded
    with `state` and `loop` on the card, an `EagerBody` on the CPU."""
    if state.commit_len.device.type != "cuda":
        return EagerBody(eng, body, state, loop, readback)
    g = eng._graphs.get(key)
    if g is None:
        g = eng._graphs[key] = DecodeGraph(eng, body, state, loop, readback)
    g.load(state, loop)
    return g


def _replays(r, vals: list, cond):
    """Replay runner `r` while `cond(*vals)` holds, `vals` its last read;
    returns (state, loop) after the last replay. With the recorder on, each
    replay is a `round` span, written once the last has been read."""
    if not prof.enabled:
        while cond(*vals):
            vals = r.replay()
        return r.state, r.loop
    times = []
    while cond(*vals):
        t0 = time.time_ns()
        vals = r.replay_timed(len(times))
        times.append((t0, time.time_ns()))
    r.record_rounds(times)
    return r.state, r.loop


def _run(eng, key, body, state, loop: LoopBuffers, cond):
    """Run `body` while `cond(n_out, done, commit_len)` holds: replays of
    the engine's graph for `key` on the card, the body itself on the CPU.
    Returns (state, loop) after the last body."""
    vals = _readback(state, loop).tolist()
    return _replays(runner(eng, key, body, state, loop), vals, cond)


def spec_decode_loop(eng, state, eos_id: int, budget: int,
                     commit_cap: int):
    """The counterpart of `_spec_decode_loop`: rounds while no EOS was
    written, fewer than `budget` tokens were and commit_len <= commit_cap.
    Returns (tokens written, rounds, done, state): the state comes back so
    a bucketed caller can grow it and go on. `budget` + depth_cap + 1 <=
    max_seq_len (`SpecEngine._check_budget`), and a round writes at most
    depth_cap + 1 tokens, so an output buffer of max_seq_len slots takes
    any request."""
    rec = prof.enabled
    sp = prof.open("segment.load") if rec else -1
    loop = _loop_buffers(eng.cfg.max_seq_len, eos_id,
                         state.commit_len.device)
    key = ("spec", state.base_cache.max_len, state.draft_cache.max_len)
    vals = _readback(state, loop).tolist()
    r = runner(eng, key, _spec_body, state, loop)
    if sp >= 0:
        prof.close(sp)
    state, loop = _replays(
        r, vals, lambda n, done, commit: not done and n < budget
        and commit <= commit_cap)
    sp = prof.open("segment.read") if rec else -1
    n_out, done, rounds = torch.stack(
        [loop.n_out, loop.done.to(torch.int32), loop.rounds]).tolist()
    toks = loop.out_buf[:n_out].tolist()
    if sp >= 0:
        prof.close(sp)
    return toks, rounds, bool(done), state


def ar_decode_loop(eng, state, eos_id: int, *, max_out: int) -> list:
    """The counterpart of `_ar_decode_loop`: steps while no EOS was written
    and fewer than `max_out` tokens were. Returns the tokens written."""
    loop = _loop_buffers(eng.cfg.max_seq_len, eos_id,
                         state.commit_len.device)   # max_out < max_seq_len
    key = ("ar", state.base_cache.max_len)
    _, loop = _run(eng, key, _ar_body, state, loop,
                   lambda n, done, commit: not done and n < max_out)
    return loop.out_buf[:int(loop.n_out)].tolist()


def lane_decode_loop(eng, state, eos_id: int, budgets, commit_cap: int):
    """The counterpart of the vmapped `_spec_decode_loop` over the lanes of
    `state`: rounds while any lane has no EOS written, fewer tokens than
    its budget and commit_len <= commit_cap. Returns (per-lane tokens
    written, per-lane rounds, per-lane done, state)."""
    dev = state.commit_len.device
    b = state.commit_len.shape[0]
    z = lambda dt: torch.zeros((b,), dtype=dt, device=dev)
    loop = LaneLoop(
        out_buf=torch.zeros((b, eng.cfg.max_seq_len + 1), dtype=torch.int32,
                            device=dev),
        n_out=z(torch.int32), done=z(torch.bool), rounds=z(torch.int32),
        budget=torch.tensor(budgets, dtype=torch.int32).to(dev),
        eos_id=torch.full((), eos_id, dtype=torch.int32, device=dev),
        commit_cap=torch.full((), commit_cap, dtype=torch.int32,
                              device=dev))
    key = ("lanes", state.base_cache.max_len, state.draft_cache.max_len, b)
    r = runner(eng, key, _lane_body, state, loop, _lane_readback)
    vals = _lane_readback(state, loop).tolist()
    while vals[0]:
        vals = r.replay()
    lp = r.loop
    n_out, done, rounds = torch.stack(
        [lp.n_out, lp.done.to(torch.int32), lp.rounds]).tolist()
    bufs = lp.out_buf.tolist()
    return ([bufs[i][:n_out[i]] for i in range(b)], rounds,
            [bool(d) for d in done], r.state)
