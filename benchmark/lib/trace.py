"""Reading a torch.profiler trace of the traced window.

`device_events`, `family`, `GEMM_KEYS` and `moe_gemm_names` are frozen
copies of `chip_smoke.py`'s (`device_events` also keeps each event's start;
`moe_gemm_names` takes the row counts of the cell's base forwards). Later
changes to the program's kernel names do not reach them: where a kernel is
renamed and a family reads 0, only a change to the benchmark repoints it.

The profiler records device activity only, which is all the metrics
read. Even so its per-kernel records stretch the traced requests (by
about half at Qwen2-7B chat on the card), so the idle share read from
`busy_s` and `window_s` overstates the untraced one. What the host was
doing comes from the harness's own spans, taken on the profiler's clock.

`Trace` holds what the metrics read: the device operations of the window
(kernels, copies, fills) with their family, the window's bounds from the
harness's "request" spans, the busy time as the union of the device
intervals (the split-K reduce and the head's select overlap their main
kernels, so a sum would overstate it), and the idle gaps named by the
harness's span that covers them.
"""

from __future__ import annotations

import functools
import heapq
from collections import defaultdict

REQUEST_SPAN = "request"
PREFILL_SPAN = "prefill"
GEMM_KEYS = ("gemm", "sm90_xmma", "nvjet", "cutlass")

_FAMILY_KEYS = (("qmm_kernel<0", "int8_matmul"),
                ("qmm_kernel<1", "nf4_matmul"),
                ("qmm_kernel<2", "int4_matmul"),
                ("qmm_reduce", "matmul_reduce"),
                ("int8_matmul_kernel", "int8_matmul_strip"),
                ("p4_matmul_kernel<true", "nf4_matmul_strip"),
                ("p4_matmul_kernel<false", "int4_matmul_strip"),
                ("int4_splitk", "int4_matmul_splitk"),
                ("tree_attention_simt", "tree_attention_simt"),
                ("tree_attention_mma", "tree_attention"),
                ("head_wgmma_kernel", "head_topk"),
                ("head_select_kernel", "head_select"),
                ("head_partial_kernel", "head_topk_strip"),
                ("head_merge_kernel", "head_topk_strip"),
                ("gemm", "cublas_gemm"), ("sm90_xmma", "cublas_gemm"),
                ("nvjet", "cublas_gemm"), ("cutlass", "cublas_gemm"),
                ("sort", "sort_topk"), ("topk", "sort_topk"),
                ("radix", "sort_topk"))


def family(name: str, moe=frozenset(), keys=()) -> str:
    """The kernel family of a device kernel's name in a profiler trace: the
    port's six CUDA kernels, the split-K reduce pass of int8 / nf4 / int4
    as `matmul_reduce`, the head's merge pass as `head_select`, the GEMMs
    named in `moe` (Mixtral's expert products, `moe_gemm_names`) as
    `moe_experts`, the other cuBLAS GEMMs (the lm_head, a bf16 base's
    projections), sort/top-k, everything else as `other`. `keys`: a model
    family's own (substring, family) pairs, tried before the frozen ones
    (`families/__init__.py KERNEL_FAMILIES`)."""
    if name in moe:
        return "moe_experts"
    n = name.lower()
    for key, fam in (*keys, *_FAMILY_KEYS):
        if key in n:
            return fam
    return "other"


def device_events(prof):
    """(name, start ns, duration ns) of each device event of a finished
    torch.profiler session, read from its raw kineto records (the filter
    and the demangled names of `prof.events()`, without building its
    Python event objects)."""
    import torch
    from torch.autograd.profiler_util import _filter_name
    cuda = torch.autograd.DeviceType.CUDA
    names = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        raw = ev.name()
        if (_filter_name(raw) or raw == REQUEST_SPAN
                or getattr(ev, "is_hidden_event", lambda: False)()):
            continue
        if raw not in names:
            names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        yield names[raw], ev.start_ns(), ev.duration_ns()


def moe_gemm_names(params, layer, cfg, rows, device) -> frozenset:
    """The GEMM kernels of Mixtral's expert products: the GEMM names one
    layer's `moe_block` launches at each row count in `rows` under the
    profiler, less those of the layer's attention projections, its router
    and the lm_head at the same rows. A shared name stays in the cuBLAS
    family, so the MoE family is never overstated. A trace without a GEMM,
    which each of these calls launches, raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from flowspec_tpu_torch.models.llama import lm_head_logits
    from flowspec_tpu_torch.models.mixtral import moe_block
    from flowspec_tpu_torch.ops.quant import matmul_f32_out, qmatmul

    def gemms(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {name for name, _, _ in device_events(prof)
                 if any(k in name.lower() for k in GEMM_KEYS)}
        if not names:
            raise RuntimeError("moe_gemm_names: no GEMM kernel in the trace")
        return names

    xs = [torch.randn((1, t, cfg.hidden_size), device=device).to(
        torch.bfloat16) for t in rows]
    moe = gemms(lambda: [moe_block(x, layer, cfg) for x in xs])
    dense = gemms(lambda: [([qmatmul(x, w) for w in (layer.wq, layer.wk,
                                                    layer.wo)],
                            matmul_f32_out(x, layer.router),
                            lm_head_logits(params, x)) for x in xs])
    if not moe - dense:
        raise RuntimeError("moe_gemm_names: every GEMM kernel of the expert "
                           f"products is a dense one's: {sorted(moe)}")
    return frozenset(moe - dense)


def union_s(intervals, lo: int, hi: int) -> float:
    """Seconds of [lo, hi) (ns) that the (start, end) intervals cover."""
    busy, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy / 1e9


def gaps(intervals, lo: int, hi: int):
    """The (start, end) ns stretches of [lo, hi) that no interval covers."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(s, e) for s, e in out if e > s]


# what the host was doing in a span of the harness's: the innermost span
# that covers a gap names it
SPAN_NAMES = {PREFILL_SPAN: "prefill: the eager chunks",
              REQUEST_SPAN: "in a request, outside prefill: graph replays, "
                            "reads, KV growth",
              None: "between requests: the client"}
GAP_CLASSES = ((1e-5, "< 10 us"), (1e-4, "10-100 us"), (1e-3, "0.1-1 ms"),
               (float("inf"), ">= 1 ms"))


def name_gaps(gap_list, spans) -> dict:
    """{what the host was doing, gap length class: idle seconds}: each
    gap goes to the innermost of the harness's spans (name, start, end)
    covering its start (the one that began last), or to "between
    requests" where none does."""
    by = defaultdict(float)
    events = sorted(spans, key=lambda ev: ev[1])
    active, i = [], 0
    for s, e in sorted(gap_list):
        while i < len(events) and events[i][1] <= s:
            name, es, ee = events[i]
            heapq.heappush(active, (-es, ee, name))
            i += 1
        while active and active[0][1] < s:
            heapq.heappop(active)
        what = SPAN_NAMES[active[0][2] if active else None]
        dt = (e - s) / 1e9
        cls = next(c for lim, c in GAP_CLASSES if dt < lim)
        by[f"{what}; gaps {cls}"] += dt
    return dict(by)


class Trace:
    """The traced window of one run. `ops`: (name, start, end) ns of every
    device operation in the window; `spans`: the harness's host spans
    (name, start, end) on the profiler's clock (`time.time_ns`), "request"
    around each `generate_fused` call and "prefill" around the engine's
    prefill; `lo`, `hi`: the window, from the first request's start to the
    last one's end; `moe`: the expert GEMMs' names; `keys`: the model
    family's own kernel families (`family`)."""

    def __init__(self, ops, spans, moe=frozenset(), keys=()):
        req = [(s, e) for n, s, e in spans if n == REQUEST_SPAN]
        if not req:
            raise RuntimeError("trace: no request span in the traced window")
        self.lo = min(s for s, _ in req)
        self.hi = max(e for _, e in req)
        self.ops = [(n, s, e) for n, s, e in ops
                    if e > self.lo and s < self.hi]
        if not self.ops:
            raise RuntimeError("trace: no device operation in the traced "
                               "window (the profiler recorded no device "
                               "activity)")
        self.spans = spans
        self.moe = moe
        self.keys = tuple(keys)
        self._fam = {}

    @classmethod
    def from_profile(cls, prof, spans, moe=frozenset(), keys=()) -> "Trace":
        return cls([(n, s, s + d) for n, s, d in device_events(prof)],
                   spans, moe, keys)
    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @functools.cached_property
    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.ops], self.lo, self.hi)

    def family_of(self, name: str) -> str:
        if name not in self._fam:
            self._fam[name] = family(name, self.moe, self.keys)
        return self._fam[name]

    @functools.cached_property
    def family_s(self) -> dict:
        """{family: summed device seconds}."""
        out = defaultdict(float)
        for n, s, e in self.ops:
            out[self.family_of(n)] += (e - s) / 1e9
        return dict(out)

    def family_count(self) -> dict:
        out = defaultdict(int)
        for n, _, _ in self.ops:
            out[self.family_of(n)] += 1
        return dict(out)

    def device_ops(self, n: int = 10) -> list:
        """The `n` costliest device operations: each family's total, the
        `other` family split by kernel name."""
        out = defaultdict(float)
        for name, s, e in self.ops:
            fam = self.family_of(name)
            out[fam if fam != "other" else f"other: {name[:80]}"] += (
                (e - s) / 1e9)
        return sorted(([k, v] for k, v in out.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The `n` largest sums of idle seconds by what the host was doing
        and the gaps' length."""
        by = name_gaps(gaps([(s, e) for _, s, e in self.ops], self.lo,
                            self.hi), self.spans)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]
