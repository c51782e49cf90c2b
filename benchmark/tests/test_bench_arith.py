"""The roofline, MFU and trace arithmetic on hand-worked shapes."""

import pytest

from benchmark.lib import bounds, trace, work
from benchmark.run import Run, Served


def dims(**kw):
    base = dict(hidden=8, inter=16, layers=2, nq=2, nkv=1, head_dim=4,
                vocab=32, experts=0, experts_per_token=0, base_int8=True,
                depth=2, top_k=3, tree_rows=5, chunk=4)
    base.update(kw)
    return work.Dims(**base)


def req(prompt, new, rounds):
    return Served(0, 0, [0] * prompt, new, [1] * new, rounds, 1, 0.0, 1.0)


def test_bound_is_the_larger_of_bytes_and_flops():
    assert bounds.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert bounds.bound_s(0, 989e12) == pytest.approx(1.0)
    assert bounds.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_int8_product_work():
    # codes 8*16, scales 16*4, x 3*8*2, y 3*16*2; 2*3*8*16 flops
    assert bounds.int8_matmul_work(3, 8, 16) == (128 + 64 + 48 + 96, 768.0)


def test_calls_of_a_request():
    d = dims()
    r = req(prompt=6, new=4, rounds=2)      # 2 tokens a round
    assert list(work.base_calls(r, d)) == [(4, 4), (2, 6), (5, 11), (5, 13)]
    # prefill context forwards, round 0's beam, round 1's context + beam
    assert list(work.draft_calls(r, d)) == [
        (4, 4), (2, 6), (3, 9), (3, 12), (2, 8), (3, 11), (3, 14)]
    assert list(work.head_rows(r, d)) == [1, 3, 3, 1, 3, 3]
    assert work.lm_head_rows(r, d) == 2 + 2 * 5


def test_attention_work():
    d = dims()
    # K and V: 2 * 11 keys * 1 head * 4 * 2 B; q and out 2 * 5 * 2 * 4 * 2
    assert work.attention_work(work.Call(5, 11), d) == (
        176 + 160, 4.0 * 5 * 11 * 2 * 4)


def test_head_and_moe_bounds():
    d = dims(experts=4, experts_per_token=2, base_int8=False)
    r = req(prompt=4, new=1, rounds=1)
    head = sum(bounds.bound_s(8 * 32 + 4 * 32 + rows * 8 * 2,
                              2.0 * rows * 8 * 32) for rows in (1, 3, 3))
    assert work.head_bound_s([r], d) == pytest.approx(head)
    w = 4 * 3 * 8 * 16 * 2
    moe = 2 * sum(bounds.bound_s(w + 2 * rows * 8 * 2,
                                 2.0 * rows * 2 * 3 * 8 * 16)
                  for rows in (4, 5))
    assert work.moe_bound_s([r], d) == pytest.approx(moe)
    assert work.moe_bound_s([r], dims()) == 0.0


def test_model_flops_by_hand():
    d = dims()
    r = req(prompt=4, new=1, rounds=1)
    attn_proj = 2 * (8 * 8 + 8 * 4 + 8 * 4 + 8 * 8)
    mlp = 2 * 3 * 8 * 16
    base_row = 2 * (attn_proj + mlp)
    draft_row = 2 * 16 * 8 + attn_proj + mlp
    att = lambda rows, keys: 4.0 * rows * keys * 2 * 4
    flops = (4 * base_row + 2 * att(4, 4) + 5 * base_row + 2 * att(5, 9)
             + 4 * draft_row + att(4, 4)
             + 3 * draft_row + att(3, 7) + 3 * draft_row + att(3, 10)
             + 2 * 8 * 32 * (1 + 5 + 1 + 3 + 3))
    assert work.model_flops([r], d) == pytest.approx(flops)


def test_union_gaps_and_their_names():
    ops = [(0, 10), (5, 20), (30, 40), (45, 60)]
    assert trace.union_s(ops, 0, 50) == pytest.approx(35e-9)
    gaps = trace.gaps(ops, 0, 50)
    assert gaps == [(20, 30), (40, 45)]
    spans = [("request", 0, 50), ("prefill", 18, 35)]
    named = trace.name_gaps(gaps, spans)
    assert named == {
        f"{trace.SPAN_NAMES['prefill']}; gaps < 10 us": pytest.approx(10e-9),
        f"{trace.SPAN_NAMES['request']}; gaps < 10 us": pytest.approx(5e-9)}


def test_trace_metrics_read_the_window():
    ops = [("void qmm_kernel<0, 1>", 1000, 4000),
           ("qmm_reduce_kernel", 3000, 5000),
           ("tree_attention_mma<128>", 6000, 7000),
           ("nvjet_tst_gemm", 7000, 7500),
           ("void at::native::add_kernel", 9000, 9500),
           ("outside", 20000, 30000)]
    t = trace.Trace(ops, [("request", 0, 10000)])
    assert t.window_s == pytest.approx(10e-6)
    assert t.busy_s == pytest.approx(6e-6)          # 1000-5000, 6000-7500,
    assert t.family_s == pytest.approx({             # 9000-9500
        "int8_matmul": 3e-6, "matmul_reduce": 2e-6, "tree_attention": 1e-6,
        "cublas_gemm": 0.5e-6, "other": 0.5e-6})
    # the traced request, then an untraced block of two, 8 us end to end
    later = [Served(1, 0, [0] * 4, 1, [1], 1, 1, 2e-6, 6e-6),
             Served(1, 1, [0] * 4, 1, [1], 1, 1, 7e-6, 10e-6)]
    run = Run(cfg={}, mix={}, dims=dims(), requests=[req(4, 1, 1)] + later,
              window_s=1.0, setup_s=1.0, traced=[req(4, 1, 1)], trace=t)
    from benchmark.lib import spec
    assert spec.reader("mfu")(run) == pytest.approx(
        100 * work.model_flops(later, dims()) / (8e-6 * 989e12))
    assert spec.reader("other_ms_per_round")(run) == pytest.approx(0.5e-3)
    assert spec.reader("moe_roofline")(run) is None
    assert spec.reader("attention_roofline")(run) == pytest.approx(
        100 * work.attention_bound_s([req(4, 1, 1)], dims()) / 1e-6)
