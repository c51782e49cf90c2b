"""The port's recorder (`flowspec_tpu_torch/utils/profiler.py prof`): the
spans `SpecEngine.generate_fused` records at its layer boundaries, their
nesting and counters, nothing when the recorder is off, the clock shared
with torch.profiler, the saved record and its rendering, device figures
read only once their events have completed, and a kernel build recorded
only when it compiles. On the CPU, without device figures (a card's are
checked in tests/test_torch_cuda.py)."""

import json
import os
import sys

import pytest
import torch

from flowspec_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingConfig, TreeConfig,
)
from flowspec_tpu_torch.draft.eagle import init_eagle_params
from flowspec_tpu_torch.models.llama import init_llama_params
from flowspec_tpu_torch.ops import _build
from flowspec_tpu_torch.runtime import SpecEngine
from flowspec_tpu_torch.utils.profiler import COUNTED, Profiler, Span, prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 8


@pytest.fixture(scope="module")
def engine():
    """A tiny float32 engine on the CPU with KV buckets 32 / 64 of 128."""
    mc = ModelConfig.tiny(vocab_size=64, n_layers=2)
    mc = ModelConfig(**{**mc.__dict__, "dtype": "float32"})
    gen = torch.Generator().manual_seed(0)
    params = init_llama_params(gen, mc, device="cpu")
    draft = init_eagle_params(gen, mc, embed=params.embed, device="cpu")
    tree = TreeConfig(top_k=4, depth=3, total_tokens=12, node_cap=16,
                      leaf_cap=16, depth_cap=6)
    cfg = EngineConfig(model=mc, tree=tree, sampling=SamplingConfig(),
                       max_seq_len=128, kv_buckets=(32, 64),
                       prefill_chunk=CHUNK)
    return SpecEngine(params, draft, cfg, device="cpu")


@pytest.fixture
def recorder():
    """The module recorder, on and empty; off and empty after."""
    prof.reset()
    prof.enabled = True
    yield prof
    prof.enabled = False
    prof.reset()


def _prompt(n):
    return [(7 * i + 3) % 60 + 2 for i in range(n)]


@pytest.mark.parametrize("p_len,new", [(5, 60), (19, 30), (25, 8)])
def test_generate_fused_records_its_spans(engine, recorder, p_len, new):
    out, stats = engine.generate_fused(_prompt(p_len), max_new_tokens=new,
                                       eos_token_id=-1)
    spans = recorder.spans
    names = [s.name for s in spans]
    segments = stats["kv_buckets_used"]
    assert names.count("request") == 1 and spans[0].name == "request"
    assert names.count("prefill.chunk") == -(-p_len // CHUNK)
    assert names.count("prefill.finish") == 1
    assert names.count("round") == stats["rounds"] > 0
    assert names.count("grow_kv") == segments - 1
    assert names.count("segment.load") == names.count("segment.read") \
        == segments
    assert set(names) <= {"request", "prefill.chunk", "prefill.finish",
                          "grow_kv", "segment.load", "segment.read",
                          "round"}
    # every span lies in the request and inside its parent; the request
    # holds the prefill, the growths and the segments, a segment's rounds
    # lie between its load and its read
    for i, s in enumerate(spans):
        assert s.request == 0 and s.t0_ns <= s.t1_ns, s
        if i:
            par = spans[s.parent]
            assert par.t0_ns <= s.t0_ns and s.t1_ns <= par.t1_ns
            assert par.name == "request", s
    order = [n for n in names if n not in ("prefill.chunk", "round")]
    assert order == (["request", "prefill.finish", "segment.load",
                      "segment.read"]
                     + ["grow_kv", "segment.load", "segment.read"]
                     * (segments - 1))
    assert all(s.device_ms is None and s.gap_ms is None for s in spans)
    assert dict(recorder.counters) == {
        "prefill_chunks": -(-p_len // CHUNK), "rounds": stats["rounds"],
        **({"kv_grows": segments - 1} if segments > 1 else {})}
    assert recorder._stack == [] and recorder._request == -1


def test_off_records_nothing_and_serves_the_same_tokens(engine):
    prof.reset()
    assert not prof.enabled
    off, off_stats = engine.generate_fused(_prompt(19), max_new_tokens=30,
                                           eos_token_id=-1)
    assert prof.spans == [] and not prof.counters
    prof.enabled = True
    try:
        on, on_stats = engine.generate_fused(_prompt(19), max_new_tokens=30,
                                             eos_token_id=-1)
    finally:
        prof.enabled = False
        n_spans = len(prof.spans)
        prof.reset()
    assert on == off and on_stats == off_stats and n_spans > 0


def test_nesting_request_ids_and_counters():
    p = Profiler(sync=False)
    outside = p.open("kernel_build")
    p.close(outside)
    req = p.open_request()
    a = p.open("prefill.chunk")
    b = p.open("inner")                       # left open
    p.close(a)                                # closes `inner` with it
    c = p.open("capture", 10)
    p.close(c, 20)
    p.close_request(req)
    after = p.open("round")
    p.close(after)
    s = p.spans
    assert [x.request for x in s] == [-1, req, req, req, req, -1]
    assert [x.parent for x in s] == [-1, -1, req, a, req, -1]
    assert s[c].t0_ns == 10 and s[c].t1_ns == 20
    assert s[b].t1_ns == 0                    # never closed itself
    assert dict(p.counters) == {"kernel_builds": 1, "prefill_chunks": 1,
                                "graph_captures": 1, "rounds": 1}
    assert set(COUNTED.values()) == {"rounds", "prefill_chunks", "kv_grows",
                                     "graph_captures", "kernel_builds"}


class _Event:
    """A stand-in for a CUDA timing event: completed once `done`."""

    def __init__(self, t):
        self.t, self.done, self.recorded = t, False, 0

    def record(self, stream=None):
        self.recorded += 1

    def query(self):
        return self.done

    def elapsed_time(self, other):
        if not (self.done and other.done):
            raise RuntimeError("not ready: elapsed_time would fail")
        return other.t - self.t


def test_device_figures_read_only_once_their_events_completed():
    p = Profiler(sync=False)
    start, end = _Event(1.0), _Event(3.5)
    i = p.open("grow_kv")
    p.close(i, events=(start, end))
    assert end.recorded == 1 and start.recorded == 0
    p.resolve()                               # not complete: nothing read
    assert p.spans[i].device_ms is None and len(p._pending) == 1
    start.done = end.done = True
    p.resolve()
    assert p.spans[i].device_ms == 2.5 and p._pending == []


def test_a_pending_pair_is_not_recorded_again(engine, recorder):
    """Two prefills with no sync between them (lanes admitted one after
    another): the second finds the engine's pair still pending, records
    neither event and goes without device figures; the first reads its
    own pair once it completes."""
    start, end = _Event(0.0), _Event(4.0)
    engine._events["prefill"] = (start, end)
    try:
        for _ in range(2):
            engine.prefill(engine.init_state(0, max_seq=32), _prompt(9))
    finally:
        del engine._events["prefill"]
    first, second = [i for i, s in enumerate(recorder.spans)
                     if s.name == "prefill.finish"]
    assert start.recorded == end.recorded == 1
    assert [i for i, _ in recorder._pending] == [first]
    start.done = end.done = True
    recorder.resolve()
    assert recorder.spans[first].device_ms == 4.0
    assert recorder.spans[second].device_ms is None


def test_a_segments_rounds_are_written_after_its_last_replay(recorder):
    """`DecodeGraph.record_rounds` on a graph's per-round pairs: each
    round's device ms between its own pair, its gap from the previous
    round's end to its start, none for the first; spans inside the open
    request, counted; a longer segment's pairs beyond these go unread."""
    from flowspec_tpu_torch.runtime.graphs import DecodeGraph
    g = object.__new__(DecodeGraph)
    g._events = [(_Event(0.0), _Event(10.0)), (_Event(10.25), _Event(20.0)),
                 (_Event(20.5), _Event(31.0)), (_Event(99.0), None)]
    for pair in g._events[:3]:
        for ev in pair:
            ev.done = True
    req = recorder.open_request()
    g.record_rounds([(1, 2), (3, 4), (5, 6)])
    recorder.close_request(req)
    rounds = recorder.spans[1:]
    assert [(s.t0_ns, s.t1_ns) for s in rounds] == [(1, 2), (3, 4), (5, 6)]
    assert [s.device_ms for s in rounds] == [10.0, 9.75, 10.5]
    assert [s.gap_ms for s in rounds] == [None, 0.25, 0.5]
    assert all(s.parent == req == s.request for s in rounds)
    assert dict(recorder.counters) == {"rounds": 3}


def test_spans_share_the_profilers_clock():
    """A span around a `record_function` brackets its kineto event's start
    and end, within 1 ms: spans and a torch.profiler trace share a clock."""
    from torch.profiler import ProfilerActivity, profile, record_function
    p = Profiler(sync=False)
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        for _ in range(3):
            i = p.open("probe")
            with record_function("probe"):
                torch.ones(64).sum()
            p.close(i)
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in tp.profiler.kineto_results.events()
           if e.name() == "probe"]
    assert len(evs) == 3
    for (s, e), sp in zip(sorted(evs), p.spans):
        assert sp.t0_ns - 1_000_000 <= s <= e <= sp.t1_ns + 1_000_000


def test_save_round_trips_and_renders(engine, recorder, tmp_path, capsys):
    engine.generate_fused(_prompt(19), max_new_tokens=30, eos_token_id=-1)
    rec = tmp_path / "spans.json"
    recorder.save(str(rec))
    saved = json.loads(rec.read_text())
    assert set(saved) == {"summary", "stream", "spans", "counters"}
    assert [Span(**d) for d in saved["spans"]] == recorder.spans
    assert saved["counters"] == dict(recorder.counters)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import show_timestamps
    finally:
        sys.path.pop(0)
    show_timestamps.main([str(rec), "--top", "2"])
    out = capsys.readouterr().out
    assert "round:start" in out and "prefill.finish:stop" in out
    assert "top 2 gaps" in out and "segment.load" in out


def test_kernel_build_recorded_only_when_it_compiles(tmp_path, monkeypatch,
                                                     recorder):
    """`ops/_build.py build` with an `nvcc` that only writes its output:
    the first build of a missing library is a `kernel_build` span, the
    second finds it and records nothing."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "libs")
    assert set(_build.build(("int8_matmul",))) == {"int8_matmul"}
    assert [s.name for s in recorder.spans] == ["kernel_build"]
    assert _build.build(("int8_matmul",)) == {}
    assert len(recorder.spans) == 1
    assert dict(recorder.counters) == {"kernel_builds": 1}
