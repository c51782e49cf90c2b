"""Every reader of both real cells, and every bound of their work, on one
fixed run at the configurations' own widths: fixed requests (prompt
lengths, new tokens, rounds), a trace of fixed kernel times and the
port's spans planted in its recorder. The values pinned here were read by
the harness before a family could bring its own work, reference and kernel
names, on this same run: a change to how the harness reaches the work or
names a kernel that moves any reading, by a bit, shows here."""

import pytest

from benchmark import run
from benchmark.lib import spec, trace, traffic
from flowspec_tpu_torch.utils.profiler import Span, prof

# (prompt tokens, new tokens, rounds, KV buckets): the chat mix's sizes
SIZES = [(211, 128, 128, 2), (223, 128, 97, 2), (231, 120, 120, 2),
         (239, 128, 64, 2), (251, 128, 101, 2), (268, 100, 51, 1),
         (300, 128, 128, 1), (481, 128, 77, 2)]
SETUP_S = 16.625
# kernel, device seconds over the traced half
KERNELS = {
    "qwen2-7b-int8": [
        ("void qmm_kernel<0, 128, 4>(bf16 const*, signed char const*)",
         3.1782),
        ("void tree_attention_mma<128, 4>(x)", 0.4589),
        ("head_wgmma_kernel<2>", 0.9397), ("head_select_kernel", 0.4053),
        ("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_TNT", 0.2024),
        ("void at::native::vectorized_elementwise_kernel<4>", 1.5047)],
    "mixtral-8x7b-bf16-16l": [
        ("nvjet_tst_256x128_64x4_2x1_v_bz_coopA_NNT", 8.2875),
        ("void qmm_kernel<0, 128, 4>(bf16 const*, signed char const*)",
         0.5949),
        ("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_TNT", 0.5068),
        ("void tree_attention_mma<128, 4>(x)", 0.3054),
        ("head_wgmma_kernel<2>", 0.2332), ("head_select_kernel", 0.2578),
        ("void at::native::vectorized_elementwise_kernel<4>", 1.1276)]}
MOE = {"mixtral-8x7b-bf16-16l":
       frozenset({"nvjet_tst_256x128_64x4_2x1_v_bz_coopA_NNT"})}
READERS = ["tok_s", "ms_per_token_p50", "ms_per_token_p95", "setup_s",
           "accept_per_round", "other_ms_per_round", "moe_roofline",
           "int8_roofline", "attention_roofline", "head_roofline", "mfu",
           "round_device_ms", "round_gap_us", "prefill_ms_per_chunk",
           "grow_ms", "capture_s"]

# read by the harness before the family hooks, on the run below
PINNED = {
    "qwen2-7b-int8": {
        "tok_s": 37.61445186834943,
        "ms_per_token_p50": 26.21901041666665,
        "ms_per_token_p95": 28.21093749999995,
        "setup_s": 16.625,
        "accept_per_round": 1.2898172323759791,
        "other_ms_per_round": 5.206574394463667,
        "moe_roofline": None,
        "int8_roofline": 26.596633866724527,
        "attention_roofline": 1.307375965017889,
        "head_roofline": 31.49948498127948,
        "mfu": 3.918583830585404,
        "round_device_ms": 18.259635220125784,
        "round_gap_us": 146.01395348837212,
        "prefill_ms_per_chunk": 0.9370588235294117,
        "grow_ms": 0.314,
        "capture_s": 1.1,
    },
    "mixtral-8x7b-bf16-16l": {
        "tok_s": 37.61445186834943,
        "ms_per_token_p50": 26.21901041666665,
        "ms_per_token_p95": 28.21093749999995,
        "setup_s": 16.625,
        "accept_per_round": 1.2898172323759791,
        "other_ms_per_round": 3.901730103806228,
        "moe_roofline": 50.37823564083654,
        "int8_roofline": 33.31844079090177,
        "attention_roofline": 1.9432409035373235,
        "head_roofline": 20.758304235851483,
        "mfu": 3.398639281015597,
        "round_device_ms": 18.259635220125784,
        "round_gap_us": 146.01395348837212,
        "prefill_ms_per_chunk": 0.9370588235294117,
        "grow_ms": 0.314,
        "capture_s": 1.1,
    },
}
# the same run's bounds (seconds) and model FLOPs; a dense model answers
# None for the experts it does not launch
PINNED_BOUNDS = {
    "qwen2-7b-int8": {
        "attention_bound_s": 0.005999548303467092,
        "int8_bound_s": 0.8452942175522389,
        "head_bound_s": 0.42366807299820897,
        "moe_bound_s": None,
        "model_flops": 2035789333258240.0,
    },
    "mixtral-8x7b-bf16-16l": {
        "attention_bound_s": 0.005934657719402985,
        "int8_bound_s": 0.1982114042650746,
        "head_bound_s": 0.10192327359044775,
        "moe_bound_s": 4.175096278734328,
        "model_flops": 1765666856960000.0,
    },
}


def requests() -> list:
    """Two blocks of the chat sizes, one after another on the host clock
    and, in ns, on the recorder's."""
    reqs, t = [], 100.0
    for block in (0, 1):
        for k, (p, n, rounds, buckets) in enumerate(SIZES):
            dt = 0.5 + 0.02 * n + 0.001 * p + 0.01 * k
            reqs.append(run.Served(block, k, [1] * p, n, [2] * n, rounds,
                                   buckets, t, t + dt, int(t * 1e9),
                                   int((t + dt) * 1e9)))
            t += dt + 0.003
    return reqs


def plant_spans(reqs: list) -> None:
    """The recorder's spans: three captures in set-up (a kernel build in
    one), and each request's prefill chunks, growths and rounds."""
    start = reqs[0].ns0 - int(SETUP_S * 1e9)
    spans = [Span("capture", start + 10**9, start + 14 * 10**8),
             Span("kernel_build", start + 11 * 10**8, start + 12 * 10**8),
             Span("capture", start + 2 * 10**9, start + 23 * 10**8),
             Span("capture", start + 3 * 10**9, start + 35 * 10**8)]
    for k, r in enumerate(reqs):
        rid = len(spans)
        spans.append(Span("request", r.ns0 + 1000, r.ns1 - 1000, -1, rid))
        chunks = -(-r.prompt_len // 64)
        for c in range(chunks):
            spans.append(Span("prefill.chunk", r.ns0 + 2000 + c,
                              r.ns0 + 2001 + c, rid, rid))
        spans.append(Span("prefill.finish", r.ns0 + 3000, r.ns0 + 3001,
                          rid, rid, device_ms=0.93 * chunks + 0.01 * k))
        for g in range(r.buckets - 1):
            spans.append(Span("grow_kv", r.ns0 + 4000, r.ns0 + 4001, rid,
                              rid, device_ms=0.31 + 0.002 * k))
        for j in range(r.rounds):
            spans.append(Span("round", r.ns0 + 5000 + j, r.ns0 + 5001 + j,
                              rid, rid, device_ms=18.2 + 0.001 * j,
                              gap_ms=None if j == 0 else 0.14 + 1e-4 * j))
    prof.spans[:] = spans


def fixed_run(cell: str, dims, keys=()) -> run.Run:
    """The fixed run of configuration `cell` with work `dims` and the
    family's kernel names `keys`."""
    cfg = spec.config(cell)
    reqs = requests()
    traced = [r for r in reqs if r.block == 0 and traffic.traced(r.size)]
    ops, t = [], 0
    for name, s in KERNELS[cell]:
        ops.append((name, t, t + int(s * 1e9)))
        t += int(s * 1e9) + 1000
    tr = trace.Trace(ops, [("request", 0, t)], MOE.get(cell, frozenset()),
                     keys)
    plant_spans(reqs)
    return run.Run(cfg=cfg, mix=spec.mix("chat"), dims=dims, requests=reqs,
                   window_s=reqs[-1].t1 - reqs[0].t0, setup_s=SETUP_S,
                   traced=traced, trace=tr)


def readings(r: run.Run) -> dict:
    return {name: spec.reader(name)(r) for name in READERS}


@pytest.fixture(autouse=True)
def recorder():
    prof.enabled = False
    prof.reset()
    yield prof
    prof.reset()


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_every_reader_reads_as_before(cell):
    cfg = spec.config(cell)
    fam = spec.family(cfg["family"])
    r = fixed_run(cell, fam.work(cfg, spec.mix("chat")),
                  fam.kernel_families)
    assert readings(r) == PINNED[cell]


@pytest.mark.parametrize("cell", sorted(PINNED_BOUNDS))
def test_the_work_is_bit_identical(cell):
    cfg = spec.config(cell)
    work = spec.family(cfg["family"]).work(cfg, spec.mix("chat"))
    r = fixed_run(cell, work)
    got = {"attention_bound_s": work.attention_bound_s(r.traced),
           "int8_bound_s": work.int8_bound_s(r.traced),
           "head_bound_s": work.head_bound_s(r.traced),
           "moe_bound_s": work.moe_bound_s(r.traced),
           "model_flops": work.model_flops(r.requests)}
    assert got == PINNED_BOUNDS[cell]
