"""The readers of the program's spans (`lib/program_spans.py`): each on
spans planted in the recorder, None without a sample and with a program
that records none; the first block's untraced requests found through their
`request` spans; loading a reader leaves the recorder as it was; and on the
CPU, a tiny cell's requests served with the recorder on give the readers
their spans, without device figures."""

import json

import pytest

from benchmark import run
from benchmark.lib import program_spans, spec, traffic
from benchmark.tests import tiny
from flowspec_tpu_torch.utils.profiler import Span, prof

@pytest.fixture(autouse=True)
def recorder():
    """The module recorder, off and empty before and after each test."""
    prof.enabled = False
    prof.reset()
    yield prof
    prof.enabled = False
    prof.reset()


NEW = ("round_device_ms", "round_gap_us", "prefill_ms_per_chunk", "grow_ms",
       "capture_s")


def served(block, size, ns0, ns1):
    return run.Served(block, size, [1] * 4, 2, [2, 2], 2, 1, 0.0, 1.0,
                      ns0, ns1)


def request(spans, t0, t1, *, chunks, finish_ms, rounds, grows=()):
    """Append one request's spans in [t0, t1]: `rounds` (device ms, gap ms)
    pairs, `grows` device ms."""
    rid = len(spans)
    spans.append(Span("request", t0, t1, -1, rid))
    for k in range(chunks):
        spans.append(Span("prefill.chunk", t0 + 1 + k, t0 + 2 + k, rid, rid))
    spans.append(Span("prefill.finish", t0 + 10, t0 + 11, rid, rid,
                      device_ms=finish_ms))
    for ms in grows:
        spans.append(Span("grow_kv", t0 + 20, t0 + 21, rid, rid,
                          device_ms=ms))
    for dev, gap in rounds:
        spans.append(Span("round", t0 + 30, t0 + 31, rid, rid,
                          device_ms=dev, gap_ms=gap))


def planted():
    """A run whose spans are planted in the recorder: set-up (captures at 100-300, a kernel build inside the first), then
    block 0: an untraced size 0, a traced size 1 (read by no reader), an
    untraced size 2; block 1."""
    spans = [Span("capture", 100, 200), Span("kernel_build", 150, 160),
             Span("capture", 250, 300), Span("kernel_build", 310, 320)]
    request(spans, 1000, 1100, chunks=4, finish_ms=8.0,
            rounds=[(10.0, None), (12.0, 0.2), (14.0, 0.4)], grows=[0.5])
    request(spans, 2000, 2100, chunks=9, finish_ms=99.0,
            rounds=[(99.0, 9.0)], grows=[9.0])
    request(spans, 3000, 3100, chunks=1, finish_ms=2.0,
            rounds=[(16.0, None), (18.0, 0.6)])
    request(spans, 4000, 4100, chunks=7, finish_ms=70.0,
            rounds=[(70.0, 7.0)], grows=[7.0])
    reqs = [served(0, 0, 999, 1101), served(0, 1, 1999, 2101),
            served(0, 2, 2999, 3101), served(1, 0, 3999, 4101)]
    prof.spans[:] = spans
    return run.Run(cfg={}, mix={}, dims=None, requests=reqs, window_s=1.0,
                   setup_s=950e-9)


def read(name, r):
    return spec.reader(name)(r)


def test_readers_on_planted_spans():
    r = planted()
    assert read("round_device_ms", r) == pytest.approx(70.0 / 5)
    assert read("round_gap_us", r) == pytest.approx(1e3 * 1.2 / 3)
    assert read("prefill_ms_per_chunk", r) == pytest.approx(10.0 / 5)
    assert read("grow_ms", r) == pytest.approx(0.5)
    # the build inside a capture is not a capture's time; the one after is
    # no capture's
    assert read("capture_s", r) == pytest.approx(140e-9)


def test_readers_without_a_sample_read_none():
    r = planted()
    prof.spans[:] = [s for s in prof.spans
                     if s.name not in ("grow_kv", "capture")]
    for s in prof.spans:
        s.device_ms = s.gap_ms = None
    assert all(read(name, r) is None for name in NEW)
    prof.spans.clear()                     # the recorder left off
    assert all(read(name, r) is None for name in NEW)


def test_a_request_is_read_through_its_one_request_span():
    r = planted()
    assert [len(q) for q in program_spans.requests(r)] == [10, 5]
    r.requests[0] = served(0, 0, 1001, 1101)       # starts after the span
    assert [len(q) for q in program_spans.requests(r)] == [5]


def test_loading_a_reader_leaves_the_recorder_as_it_was():
    for name in NEW:
        spec.reader(name)
        assert not prof.enabled and prof.spans == []


def test_a_tiny_cells_requests_recorded_on_the_cpu(tmp_path):
    """With the recorder on, the window's requests each hold one `request`
    span with their prefill chunks and rounds (no device figures on the
    CPU, so the device readers read None)."""
    root, bench = tiny.make_root(tmp_path)
    cfg = spec.config("tinyqwen", root)
    mix = spec.mix("tinymix", root)
    prof.enabled = True
    _, eng = run.build(cfg, mix, 3, "cpu")
    src = traffic.requests(mix, 3, cfg["vocab_size"])
    reqs = [run.serve(eng, next(src)) for _ in range(mix["block"])]
    r = run.Run(cfg=cfg, mix=mix, dims=None, requests=reqs,
                window_s=1.0, setup_s=1.0)
    got = program_spans.requests(r)
    untraced = [q for q in reqs if not traffic.traced(q.size)]
    assert len(got) == len(untraced) > 0
    chunk = mix["engine"]["prefill_chunk"]
    for q, spans in zip(untraced, got):
        names = [s.name for s in spans]
        assert names.count("round") == q.rounds
        assert names.count("prefill.chunk") == -(-q.prompt_len // chunk)
        assert names.count("grow_kv") == q.buckets - 1
    assert read("round_device_ms", r) is None
    json.dumps([s.__dict__ for s in prof.spans])
