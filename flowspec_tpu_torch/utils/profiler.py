"""Named-span profiler with a cumulative timestamp stream.

Port of `flowspec_tpu/utils/profiler.py`. Reference: profiler/profiler.py —
named start/stop timers with optional device sync, context managers, and a
per-run cumulative timestamp stream (every event name + perf_counter
appended, :33-43) pickled to records/*.rec for pipeline-bubble analysis.
Here, as in the JAX package: JSON output in the JAX package's format (so
`tools/show_timestamps.py` renders a file either package saved), a device
fence that is `torch.cuda.synchronize` on a card and nothing on the CPU,
`torch.profiler` traces, and the CUDA caching allocator's counters for the
memory sections.

The profiler's device is `cuda` unless the caller names another; it is
resolved when first needed (a fence or a memory reading), so that a
profiler that only times host spans, as the module singleton `prof` does,
needs no device, and a CUDA one raises without a card.

The recorder. The module singleton `prof` is also the one recorder the
serving path writes into: set `prof.enabled = True` and
`SpecEngine.generate_fused` records a `Span` at each layer boundary it
crosses (the request, each prefill chunk and its finish, a segment's load
and end reads, each round's replay, each KV growth, each graph capture and
kernel build, and each device tally's counts over the request), with
per-name `counters`. A span's times are
`time.time_ns()`, the clock torch.profiler (kineto) stamps its host events
with, so spans line up with a device trace. On the card some spans carry
device figures from CUDA timing events that are made once per engine or
graph and read once they have completed (after the stream's sync that the
path makes anyway): the recorder never fences. A segment's rounds are
written as spans only after its last replay, so between one round's graph
and the next the recorder adds two clock reads and an event record. Off
(the default), each call site costs one attribute test.

Device tallies (`tally`) are counts that device code adds into while the
recorder is on, such as a DeepSeek base's routing (`models/deepseek.py`):
a call site adds into one only if the recorder is on when it runs, so a
CUDA graph captured with the recorder on adds into it on every replay and
one captured while it is off adds nothing. `SpecEngine.generate_fused`
zeroes them when a request opens and reads each once when it closes, as a
span of the tally's name that carries the counts as `values`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch

# the spans whose number the recorder counts, and the counter's name
COUNTED = {"round": "rounds", "prefill.chunk": "prefill_chunks",
           "grow_kv": "kv_grows", "capture": "graph_captures",
           "kernel_build": "kernel_builds"}


def resolve_device(device=None) -> torch.device:
    # imported here: the engine imports this module
    from flowspec_tpu_torch.runtime.engine import resolve_device as resolve
    return resolve(device)


def timing_events(n: int) -> list:
    """`n` CUDA events that record timing, for one engine's or one graph's
    spans to reuse."""
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


@dataclasses.dataclass
class Span:
    """One recorded span: `t0_ns`, `t1_ns` on `time.time_ns()`; `parent`
    the index of the span open around it (-1: none); `request` the index
    of the `request` span it lies in (-1: outside a request); `device_ms`
    and `gap_ms` the device figures some spans carry on the card."""
    name: str
    t0_ns: int
    t1_ns: int = 0
    parent: int = -1
    request: int = -1
    device_ms: Optional[float] = None
    gap_ms: Optional[float] = None
    values: Optional[dict] = None


class Profiler:
    def __init__(self, sync: bool = True, device=None):
        self.sync = sync
        self.device = device
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.stream: list[tuple[str, float]] = []   # (event, t) timestamps
        self.memory: dict[str, dict] = {}           # memory_context results
        self._t0 = time.perf_counter()
        self._open: dict[str, float] = {}
        # the recorder (module docstring)
        self.enabled = False
        self.spans: list[Span] = []
        self.counters = defaultdict(int)
        self._stack: list[int] = []       # the open spans, innermost last
        self._request = -1
        self._pending: list = []          # (span, (start, end) events)
        # (name, n, device) -> (counts, values, counter)
        self._tallies: dict = {}

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _device(self) -> torch.device:
        return resolve_device(self.device)

    def _maybe_sync(self, x=None):
        """A device fence: wait for the card that `x` (a tensor) lives on,
        else for the profiler's device; nothing on the CPU."""
        if self.sync:
            dev = x.device if isinstance(x, torch.Tensor) else self._device()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def start(self, name: str, sync_on=None):
        self._maybe_sync(sync_on)
        t = self._now()
        self._open[name] = t
        self.stream.append((f"{name}:start", t))

    def stop(self, name: str, sync_on=None):
        self._maybe_sync(sync_on)
        t = self._now()
        self.stream.append((f"{name}:stop", t))
        if name in self._open:
            self.totals[name] += t - self._open.pop(name)
            self.counts[name] += 1

    @contextlib.contextmanager
    def time_context(self, name: str, sync_on=None):
        """Ref: prof.time_context(...) guards saturating the pipeline code
        (e.g. stage_ea_model.py:1135,1154)."""
        self.start(name)
        try:
            yield
        finally:
            self.stop(name, sync_on=sync_on)

    def mark(self, name: str):
        """Append a bare event to the timestamp stream."""
        self.stream.append((name, self._now()))

    @contextlib.contextmanager
    def trace(self, log_dir: str):
        """A `torch.profiler` trace of the section (host, and the card's
        kernels on a CUDA device), written as a Chrome trace to
        `log_dir/trace.json`."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._device().type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as p:
            yield
        p.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    # ---- device memory (ref memory_context/profile_context,
    # profiler/profiler.py:137-194: named sections record allocated/peak
    # deltas; here the CUDA caching allocator's counters) ----------------
    @staticmethod
    def memory_stats(device=None) -> dict:
        """{'bytes_in_use', 'peak_bytes_in_use', 'bytes_limit'} of the
        device (`cuda` unless named): the allocator's current and peak
        allocated bytes and the card's memory; zeros on the CPU, as the
        JAX package gives there."""
        dev = resolve_device(device)
        if dev.type != "cuda":
            return {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                    "bytes_limit": 0}
        st = torch.cuda.memory_stats(dev)
        return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak",
                                                0)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(dev).total_memory)}

    @contextlib.contextmanager
    def memory_context(self, name: str, device=None, sync_on=None):
        """Record the named section's allocated-bytes delta and the peak
        observed across it. Results land in `self.memory[name]` as
        {'alloc_delta', 'peak', 'peak_is_new', 'count'} and the timestamp
        stream gets start/stop events like time_context. `device` defaults
        to the profiler's.

        As in the JAX package, `peak` is the PROCESS-LIFETIME peak as of
        section exit: the section never resets the allocator's peak counter
        (`torch.cuda.reset_peak_memory_stats`), since callers read
        `torch.cuda.max_memory_allocated` across sections. `peak_is_new`
        disambiguates: True means the peak ROSE during this section (so it
        was reached inside it); False means some earlier allocation still
        holds the high-water mark and the section's own peak is unknown,
        <= the reported value."""
        dev = device if device is not None else self.device
        before = self.memory_stats(dev)
        self.start(name)
        try:
            yield
        finally:
            self._maybe_sync(sync_on)
            self.stop(name)
            after = self.memory_stats(dev)
            m = self.memory.setdefault(
                name, {"alloc_delta": 0, "peak": 0, "peak_is_new": False,
                       "count": 0})
            m["alloc_delta"] += (after["bytes_in_use"]
                                 - before["bytes_in_use"])
            m["peak"] = max(m["peak"], after["peak_bytes_in_use"])
            m["peak_is_new"] = bool(
                m["peak_is_new"] or after["peak_bytes_in_use"]
                > before["peak_bytes_in_use"])
            m["count"] += 1

    @contextlib.contextmanager
    def profile_context(self, name: str, device=None, sync_on=None):
        """time_context + memory_context in one (ref profile_context,
        profiler/profiler.py:196-220)."""
        with self.memory_context(name, device=device, sync_on=sync_on):
            yield

    # ---- the recorder ----------------------------------------------------
    def open(self, name: str, t0_ns: Optional[int] = None) -> int:
        """Open a span inside the innermost open one; returns its index."""
        i = len(self.spans)
        self.spans.append(Span(
            name, time.time_ns() if t0_ns is None else t0_ns,
            parent=self._stack[-1] if self._stack else -1,
            request=self._request))
        self._stack.append(i)
        return i

    def close(self, i: int, t1_ns: Optional[int] = None,
              events=None) -> None:
        """Close span `i` (and any left open inside it). `events`: a
        (start, end) pair of timing events whose start the caller recorded;
        the end is recorded now, and the span's `device_ms` is read between
        them once both have completed (`resolve`)."""
        if events is not None:
            events[1].record()
            self._pending.append((i, events))
        sp = self.spans[i]
        sp.t1_ns = time.time_ns() if t1_ns is None else t1_ns
        if i in self._stack:
            del self._stack[self._stack.index(i):]
        self._count(sp.name)

    def _count(self, name: str) -> None:
        counter = COUNTED.get(name)
        if counter:
            self.counters[counter] += 1

    def add(self, name: str, t0_ns: int, t1_ns: int,
            device_ms: Optional[float] = None,
            gap_ms: Optional[float] = None,
            values: Optional[dict] = None) -> int:
        """Record a span already over, inside the innermost open one;
        returns its index."""
        i = len(self.spans)
        self.spans.append(Span(
            name, t0_ns, t1_ns, self._stack[-1] if self._stack else -1,
            self._request, device_ms, gap_ms, values))
        self._count(name)
        return i

    def tally(self, name: str, n: int, device, values,
              counter: str) -> torch.Tensor:
        """The (n,) int64 tally `name` on `device`: zeros made on the first
        call, which may not be inside a graph capture, and the same tensor
        on every later one for the life of the recorder (a captured graph
        keeps adding into its memory). `values` turns the read counts (a
        list) into the span's `values`; each such span adds one to the
        counter named `counter`."""
        device = torch.device(device)
        key = (name, n, str(device))
        entry = self._tallies.get(key)
        if entry is None:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"tally {name!r}: first made inside a "
                                   "graph capture")
            entry = self._tallies[key] = (
                torch.zeros((n,), dtype=torch.int64, device=device), values,
                counter)
        return entry[0]

    def zero_tallies(self) -> None:
        for counts, *_ in self._tallies.values():
            counts.zero_()

    def read_tallies(self) -> None:
        """A span for each tally that counted anything since
        `zero_tallies`, its counts read once (`tolist` waits for them)."""
        for (name, _, _), (counts, values, counter) in self._tallies.items():
            t0 = time.time_ns()
            read = counts.tolist()
            if any(read):
                self.add(name, t0, time.time_ns(), values=values(read))
                self.counters[counter] += 1

    def open_request(self) -> int:
        """Open a `request` span: every span until it closes carries its
        index as `request`."""
        self._stack.clear()
        self._request = i = len(self.spans)
        return self.open("request")

    def close_request(self, i: int) -> None:
        self.close(i)
        self._request = -1
        self.resolve()

    def resolve(self) -> None:
        """Read the device ms of every pending span whose end event has
        completed (`query` does not wait)."""
        left = []
        for i, events in self._pending:
            if events[1].query():
                self.spans[i].device_ms = events[0].elapsed_time(events[1])
            else:
                left.append((i, events))
        self._pending = left

    def pending(self, events) -> bool:
        """Whether a span still waits to read `events` (`resolve`): the
        pair may not be recorded again until it has been read."""
        return any(ev is events for _, ev in self._pending)

    def summary(self) -> dict:
        out = {name: {"total_s": round(self.totals[name], 6),
                      "count": self.counts[name],
                      "mean_ms": round(1e3 * self.totals[name]
                                       / max(self.counts[name], 1), 3)}
               for name in sorted(self.totals)}
        for name, m in self.memory.items():
            out.setdefault(name, {}).update(
                {"alloc_delta_mb": round(m["alloc_delta"] / 2 ** 20, 2),
                 "peak_mb": round(m["peak"] / 2 ** 20, 2),
                 # lifetime peak, not per-section (see memory_context)
                 "peak_is_new": m.get("peak_is_new", False)})
        return out

    def save(self, path: str):
        """Ref: save_as -> records/*.rec (profiler/profiler.py:14-16)."""
        out = {"summary": self.summary(), "stream": self.stream}
        if self.spans:
            out["spans"] = [dataclasses.asdict(sp) for sp in self.spans]
            out["counters"] = dict(self.counters)
        with open(path, "w") as f:
            json.dump(out, f)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.stream.clear()
        self.memory.clear()
        self._open.clear()
        self._t0 = time.perf_counter()
        self.spans.clear()
        self.counters.clear()
        self._stack.clear()
        self._request = -1
        self._pending.clear()
        # kept, zeroed: a captured graph may still add into a tally
        self.zero_tallies()


# Module singleton mirroring the reference's `prof` (profiler/profiler.py:275),
# and the recorder the serving path writes into once `enabled` is set.
prof = Profiler(sync=False)
