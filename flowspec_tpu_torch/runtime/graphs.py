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
counts are kept as the graph's launches per replay and taken back from the
wrappers, and each replay adds them again. The graphs of one engine share
one memory pool: they run one at a time, and what a body leaves for the
next one lives in the static buffers, outside the pool.

A capture that fails raises: there is no fallback to the eager loop.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from flowspec_tpu_torch.models.kv_cache import KVCache
from flowspec_tpu_torch.ops import counted_wrappers


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
    lp.done.logical_or_((tok == lp.eos_id) & (lp.eos_id >= 0))
    lp.rounds.add_(1)
    return st2


def _readback(st, lp: LoopBuffers) -> torch.Tensor:
    """(n_out, done, commit_len): what the host's loop condition reads."""
    return torch.stack([lp.n_out, lp.done.to(torch.int32),
                        st.commit_len.to(torch.int32)])


def _fields(x):
    """The tensors of an engine state or loop carry, in field order (a KV
    cache gives k, v and length)."""
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, KVCache):
            yield from (v.k, v.v, v.length)
        elif isinstance(v, torch.Tensor):
            yield v


def _clone(x):
    """`x` with every tensor field (and KV cache) copied."""
    def one(v):
        if isinstance(v, KVCache):
            return KVCache(k=v.k.clone(), v=v.v.clone(),
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


class DecodeGraph:
    """One decode-loop body captured over static buffers: `state` and
    `loop` (cloned from the first request that needed it, with a sampling
    generator of its own, registered with the graph), `host` (pinned),
    `launches` {kernel: launches a replay}, `capture_s` (warm-up and
    capture, seconds)."""

    def __init__(self, eng, body, state, loop: LoopBuffers):
        t0 = time.perf_counter()
        self.device = dev = state.commit_len.device
        self.state, self.loop = _clone(state), _clone(loop)
        # a generator of the graph's own, loaded from each request's
        self.state.generator = torch.Generator(device=dev)
        self.host = torch.zeros((3,), dtype=torch.int32, pin_memory=True)
        wrappers = counted_wrappers()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad():
            body(eng, self.state, self.loop)          # the warm-up body
        torch.cuda.current_stream(dev).wait_stream(side)
        self.load(state, loop)
        before = {n: fn.launches for n, fn in wrappers.items()}
        self.graph = torch.cuda.CUDAGraph()
        # the sampling generator's draws advance with every replay
        self.graph.register_generator_state(self.state.generator)
        with torch.no_grad(), torch.cuda.graph(self.graph,
                                               pool=eng._graph_pool):
            _load(self.state, body(eng, self.state, self.loop))
            self.host.copy_(_readback(self.state, self.loop),
                            non_blocking=True)
        self.launches = {n: fn.launches - before[n]
                         for n, fn in wrappers.items()
                         if fn.launches != before[n]}
        for n, fn in wrappers.items():
            fn.launches = before[n]
        eng._graph_pool = self.graph.pool()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def load(self, state, loop: LoopBuffers) -> None:
        """Copy a request's state and loop carry into the static buffers,
        its generator's state into the registered generator."""
        _load(self.state, state)
        _load(self.loop, loop)
        if state.generator is not self.state.generator:
            self.state.generator.set_state(state.generator.get_state())

    def replay(self) -> list:
        """Run the body once; returns [n_out, done, commit_len]."""
        self.graph.replay()
        torch.cuda.current_stream(self.device).synchronize()
        wrappers = counted_wrappers()
        for n, k in self.launches.items():
            wrappers[n].launches += k
        return self.host.tolist()


def _run(eng, key, body, state, loop: LoopBuffers, cond):
    """Run `body` while `cond(n_out, done, commit_len)` holds: replays of
    the engine's graph for `key` on the card, the body itself on the CPU.
    Returns (state, loop) after the last body."""
    vals = _readback(state, loop).tolist()
    if state.commit_len.device.type != "cuda":
        while cond(*vals):
            state = body(eng, state, loop)
            vals = _readback(state, loop).tolist()
        return state, loop
    g = eng._graphs.get(key)
    if g is None:
        g = eng._graphs[key] = DecodeGraph(eng, body, state, loop)
    g.load(state, loop)
    while cond(*vals):
        vals = g.replay()
    return g.state, g.loop


def spec_decode_loop(eng, state, eos_id: int, budget: int,
                     commit_cap: int):
    """The counterpart of `_spec_decode_loop`: rounds while no EOS was
    written, fewer than `budget` tokens were and commit_len <= commit_cap.
    Returns (tokens written, rounds, done, state): the state comes back so
    a bucketed caller can grow it and go on. `budget` + depth_cap + 1 <=
    max_seq_len (`SpecEngine._check_budget`), and a round writes at most
    depth_cap + 1 tokens, so an output buffer of max_seq_len slots takes
    any request."""
    loop = _loop_buffers(eng.cfg.max_seq_len, eos_id,
                         state.commit_len.device)
    key = ("spec", state.base_cache.max_len, state.draft_cache.max_len)
    state, loop = _run(
        eng, key, _spec_body, state, loop,
        lambda n, done, commit: not done and n < budget
        and commit <= commit_cap)
    n_out, done, rounds = torch.stack(
        [loop.n_out, loop.done.to(torch.int32), loop.rounds]).tolist()
    return loop.out_buf[:n_out].tolist(), rounds, bool(done), state


def ar_decode_loop(eng, state, eos_id: int, *, max_out: int) -> list:
    """The counterpart of `_ar_decode_loop`: steps while no EOS was written
    and fewer than `max_out` tokens were. Returns the tokens written."""
    loop = _loop_buffers(eng.cfg.max_seq_len, eos_id,
                         state.commit_len.device)   # max_out < max_seq_len
    key = ("ar", state.base_cache.max_len)
    _, loop = _run(eng, key, _ar_body, state, loop,
                   lambda n, done, commit: not done and n < max_out)
    return loop.out_buf[:int(loop.n_out)].tolist()
