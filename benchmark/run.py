"""Run one benchmark cell once and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` "workloads") names a configuration
(`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<mix>.json`). Set-up draws the weights on the card
from the seed, builds the port's `SpecEngine`, and serves warm requests
that pass through every KV bucket the mix meets (capturing each bucket's
CUDA graph). The window then serves the mix's requests one at a time
through `SpecEngine.generate_fused`, whole blocks of the mix's sizes,
until the first block boundary at or past `--seconds`. With `--trace 1`
half of the first block's sizes run under torch.profiler (device
activity only), and at least one whole block after them untraced.
With `--trace 1` the port's recorder (`flowspec_tpu_torch.utils.profiler
prof`) is on from the start of set-up to the end of the first block, for
the readers of its spans (`lib/program_spans.py`); `--trace 0` leaves it
off. Once the window has closed, the peak memory is read, the engine is
freed, and a sample of the served requests goes to the family's plain
float32 reference (`benchmark/lib/check.py`).

The result's metrics are the cell's end-to-end metrics (`--trace 0`) or
its per-layer metrics (`--trace 1`), each read by `metrics/<name>.py`.
Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from benchmark.lib import check, spec, traffic  # noqa: E402
from benchmark.lib import trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flowspec_tpu")


@dataclasses.dataclass
class Served:
    """One request of the window as the client saw it."""
    block: int
    size: int
    prompt: list
    max_new: int
    tokens: list            # the new tokens served
    rounds: int
    buckets: int            # KV buckets it ran in (1: it never grew)
    t0: float               # host clock before generate_fused
    t1: float               # and at its return
    ns0: int = 0            # the same on the profiler's clock
    ns1: int = 0
    failed: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def new_tokens(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (`metrics/<name>.py read(run)`)."""
    cfg: dict
    mix: dict
    dims: object            # the family's work (`spec.Family.work`)
    requests: list          # every request of the window, in order
    window_s: float
    setup_s: float
    traced: list | None = None      # the traced requests
    trace: object = None            # benchmark.lib.trace.Trace
    launches: dict | None = None    # kernel launches over the traced ones


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def build(cfg: dict, mix: dict, seed: int, device, root: Path = spec.ROOT):
    """(drawn weights, engine): the base and draft drawn on `device` from
    `seed` by the configuration's family, served by the port's SpecEngine
    as the configuration and the mix's engine settings say."""
    import torch
    from flowspec_tpu_torch.runtime import SpecEngine
    from flowspec_tpu_torch.config import (
        EngineConfig, SamplingConfig, TreeConfig,
    )
    from benchmark.families.common import Draw
    fam = spec.family(cfg["family"], root)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draw = Draw(gen, device, getattr(torch, cfg["torch_dtype"]))
    w = fam.draw(cfg, draw)
    draft = fam.draft(cfg, draw, w)
    e = mix["engine"]
    ecfg = EngineConfig(
        model=fam.model_config(cfg), tree=TreeConfig(**cfg["tree"]),
        sampling=SamplingConfig(),
        max_new_tokens=max(n for _, n in traffic.sizes(mix)),
        max_seq_len=e["max_seq_len"], kv_buckets=tuple(e["kv_buckets"]),
        prefill_chunk=e["prefill_chunk"],
        beam_head_quant=cfg["beam_head_quant"])
    return w, SpecEngine(fam.port_params(w), draft, ecfg, device=device)


def serve(eng, q: traffic.Request) -> Served:
    ns0, t0 = time.time_ns(), time.perf_counter()
    try:
        out, stats = eng.generate_fused(q.prompt, max_new_tokens=q.max_new,
                                        eos_token_id=-1)
    except Exception as exc:              # a failed request is counted
        print(f"request failed: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return Served(q.block, q.size, q.prompt, q.max_new, [], 0, 0, t0,
                      time.perf_counter(), ns0, time.time_ns(), failed=True)
    t1, ns1 = time.perf_counter(), time.time_ns()
    return Served(q.block, q.size, q.prompt, q.max_new,
                  out[len(q.prompt):], stats["rounds"],
                  stats["kv_buckets_used"], t0, t1, ns0, ns1)


def prefill_spans(eng, spans: list) -> None:
    """Record a host span (name, start, end on the profiler's clock) around
    each of the engine's prefills; `del eng.prefill` undoes it."""
    inner = eng.prefill

    def prefill(state, prompt):
        ns0 = time.time_ns()
        out = inner(state, prompt)
        spans.append((tr.PREFILL_SPAN, ns0, time.time_ns()))
        return out
    eng.prefill = prefill


def reference_logits(w, cfg, reqs, device, weight=None, dtype=None,
                     margins=None, root: Path = spec.ROOT) -> list:
    """Per request, the configuration's family's reference logits at the
    positions of its served tokens (`weight`, `dtype`: a control's or a
    witness's; `margins` receives each served position's smallest router
    margin, as the reference's `next_token_logits` gives it)."""
    import torch
    from benchmark.reference import precision
    seqs, rows = check.sequences(reqs, device)
    return spec.family(cfg["family"], root).reference_logits(
        w, cfg, seqs, rows, weight or precision.exact,
        dtype or torch.float32, margins)


def warm_profiler(device) -> None:
    """Start the process's first profiler session in set-up (it loads the
    device tracer, seconds on the card's host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def note(what: str, t0: float) -> float:
    """Print a phase's host seconds to standard error; the time now."""
    t = time.perf_counter()
    print(f"{what}: {t - t0:.3f} s", file=sys.stderr, flush=True)
    return t


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = spec.ROOT, bench: dict | None = None,
             t_start: float = T_START) -> dict:
    """One run of cell `name`; returns the result line's object."""
    import torch
    from flowspec_tpu_torch.ops import counted_wrappers
    from flowspec_tpu_torch.utils.profiler import prof as recorder

    bench = bench or spec.load_benchmark()
    c = spec.cell(bench, name)
    cfg, mix = spec.config(c["config"], root), spec.mix(c["traffic"], root)
    fam = spec.family(cfg["family"], root)
    limits = spec.limits(name, root)
    wanted = spec.metrics_of(bench, name, trace)
    readers = {m["name"]: spec.reader(m["name"], root) for m in wanted}
    on_card = torch.device(device).type == "cuda"
    if trace and not on_card:
        raise RuntimeError("--trace 1 reads the device's trace: its metrics "
                           "need a CUDA card, and this run has none")

    # ---- set-up ---------------------------------------------------------
    if trace:
        recorder.reset()
        recorder.enabled = True
    t = note("imports", t_start)
    w, eng = build(cfg, mix, seed, device, root)
    sync(device)
    t = note("weights drawn, engine built", t)
    warm_rng = np.random.default_rng(seed + 2)
    for p, n in traffic.warmup(mix, eng.cfg.tree.depth_cap):
        r = serve(eng, traffic.Request(-1, -1, warm_rng.integers(
            0, cfg["vocab_size"], p).tolist(), n))
        if r.failed:
            raise RuntimeError("a warm request failed")
    sync(device)
    t = note("warm requests", t)
    moe = frozenset()
    if trace:
        warm_profiler(device)
        moe = fam.expert_gemm_names(eng, cfg, mix, device)
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window -----------------------------------------------------
    reqs, prof, launches, spans = [], None, None, []
    counted = {"set-up": dict(recorder.counters)} if trace else {}
    source = traffic.requests(mix, seed, cfg["vocab_size"])
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    deadline = t_window + seconds
    per_block = mix["block"]
    while True:
        block = [next(source) for _ in range(per_block)]
        if trace and prof is None:
            # the traced half of the first block's sizes, under one
            # profiler session, then the rest of the block
            from torch.profiler import ProfilerActivity, profile
            before = {k: f.launches for k, f in counted_wrappers().items()}
            prefill_spans(eng, spans)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for q in block:
                    if traffic.traced(q.size):
                        reqs.append(serve(eng, q))
                sync(device)
            del eng.prefill
            spans += [(tr.REQUEST_SPAN, r.ns0, r.ns1) for r in reqs]
            launches = {k: f.launches - before[k]
                        for k, f in counted_wrappers().items()
                        if f.launches != before[k]}
            block = [q for q in block if not traffic.traced(q.size)]
        for q in block:
            reqs.append(serve(eng, q))
        if trace and reqs[-1].block == 0:
            recorder.enabled = False
            counted["block 0"] = {
                k: n - counted["set-up"].get(k, 0)
                for k, n in recorder.counters.items()}
        # a traced run serves a whole block untraced too (`metrics/mfu.py`)
        if reqs[-1].t1 >= deadline and (not trace or reqs[-1].block >= 1):
            break
    window_s = reqs[-1].t1 - t_window
    sync(device)
    t = note(f"window of {len(reqs)} requests", t_window)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    run = Run(cfg=cfg, mix=mix, dims=fam.work(cfg, mix), requests=reqs,
              window_s=window_s, setup_s=setup_s)
    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": (torch.cuda.get_device_name(device) if on_card
                              else "cpu"),
                     "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        run.traced = [r for r in reqs if r.block == 0
                      and traffic.traced(r.size)]
        run.trace = tr.Trace.from_profile(prof, spans, moe,
                                          fam.kernel_families)
        run.launches = launches
        prof = None
        result_device["busy_s"] = run.trace.busy_s
        result_device["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.device_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
        t = note("trace read", t)
        kernels = run.trace.family_count()
        print("traced kernels against counted launches: "
              + json.dumps({k: [kernels.get(k, 0), n]
                            for k, n in launches.items()}), file=sys.stderr)
        print("recorder counters: " + json.dumps({
            part: {k: n.get(k, 0) for k in ("graph_captures",
                                            "kernel_builds")}
            for part, n in counted.items()}), file=sys.stderr)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    for i, r in enumerate(reqs):
        print(f"request {i}: block {r.block} prompt {r.prompt_len} new "
              f"{r.new_tokens} rounds {r.rounds} buckets {r.buckets} "
              f"ms {(r.t1 - r.t0) * 1e3:.1f}",
              file=sys.stderr)
    run = None

    # ---- the check, after the program's state is freed ------------------
    del eng
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = judge(w, cfg, mix, reqs, seed, device,
                    limits.get("router_margin"), root)
    t = note("reference", t)
    correct, numbers = check.compare(numbers, limits["limits"])
    return result_line(correct, reqs, metrics, result_device, breakdown,
                       numbers)


def judge(w, cfg: dict, mix: dict, reqs: list, seed: int, device,
          router_margin=None, root: Path = spec.ROOT) -> dict:
    """The check's numbers (`lib/check.py`) over the seed's sample of the
    finished requests, the requests that raised, and those that served
    fewer tokens than they asked for."""
    done = [r for r in reqs if not r.failed]
    out = {"failed": sum(r.failed for r in reqs),
           "short": sum(r.new_tokens < r.max_new for r in done),
           "max_gap": float("inf"), "decided_mean_gap": float("inf")}
    picked = [done[i] for i in check.sample(
        done, seed, mix["check"]["served_tokens"])] if done else []
    if picked:
        margins = []
        logits = reference_logits(w, cfg, picked, device, margins=margins,
                                  root=root)
        out.update(check.numbers(logits, [r.tokens for r in picked],
                                 margins, router_margin))
    return out


def result_line(correct: bool, reqs: list, metrics: dict, device: dict,
                breakdown: dict | None, numbers: dict) -> dict:
    """The result line's object: its required keys, then the check's
    numbers beside their limits, last."""
    result = {"correct": correct, "attempted": len(reqs),
              "failed": sum(r.failed for r in reqs), "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = numbers
    return result


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    print(f"card: {power_limit()}", file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bench=bench)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
