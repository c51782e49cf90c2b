"""The multi-process dry run: the port's counterpart of
`tools/multihost_dryrun.py`.

    python -m flowspec_tpu_torch.multihost_dryrun --out DIR [--procs 2]
        [--stages 8] [--device cuda|cpu] [--timeout SECONDS]

The parent spawns `--procs` processes (`subprocess`: no fork after CUDA is
up), each of which joins one `torch.distributed` world on a free localhost
port (`parallel/mesh.py init_multihost`), draws the same seeded weights
(`entry.dryrun_model`'s tiny model, 2 layers a stage: f32 on the CPU, bf16
at hidden 512 on the card) and runs, each against the AR stream of a local
`SpecEngine` (`entry._check`: equal on the CPU, equal up to a near-tie of
the AR model on the card):

- every schedule of `SCHEDULES` through `generate_fused` on a distributed
  `stage_mesh(stages)`: a block of stages / procs stages a process, the
  ring hops and the completed chunk crossing processes;
- continuous on a distributed `stage_tp_mesh(stages / 2, 2)`: the TP pair
  inside each process, the stage ring across them (the JAX dryrun's
  (stage 4, tp 2) mesh at 8 stages);
- galaxy TP over the processes (`tp_mesh(procs, distributed=True)`, a TP
  rank a process, its rings over `comm.DistGroup`).

On the CPU the processes talk over gloo. On a CUDA device they share one
card, where NCCL refuses two ranks, so the dry run names the one transport
that works there, gloo through pinned host buffers (`host_staging`), and
prints it. Each rank writes `rank<r>.json` and its log into `--out`; the
parent prints one JSON summary and exits non-zero if a process fails or
outlives `--timeout`.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--stages", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True,
                    help="directory for each rank's report and log")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the whole run; each collective fails "
                         "after a quarter of it")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # a child of the parent
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def child(args) -> dict:
    """One rank's runs (module docstring); returns its report."""
    import dataclasses

    import numpy as np
    import torch

    from flowspec_tpu_torch.config import (
        EngineConfig, SamplingConfig, StageTopology)
    from flowspec_tpu_torch.draft.eagle import init_eagle_params
    from flowspec_tpu_torch.entry import _check, dryrun_model, random_llama
    from flowspec_tpu_torch.parallel import (
        PipelineEngine, TPEngine, init_multihost, stage_mesh, stage_tp_mesh,
        tp_mesh)
    from flowspec_tpu_torch.parallel.pipeline import SCHEDULES
    from flowspec_tpu_torch.runtime.engine import SpecEngine, resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    staged = dev.type == "cuda"
    init_multihost(f"127.0.0.1:{args.port}", args.procs, args.rank,
                   device=dev, host_staging=staged,
                   timeout=args.timeout / 4)
    p = args.stages
    mc, tc = dryrun_model(p, dev)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=256, prefill_chunk=8,
                       topology=StageTopology.even(2 * p, p))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = random_llama(mc, gen, dev)
    draft = init_eagle_params(gen, mc, embed=params.embed)
    prompt = np.arange(10, 30).tolist()
    new = 6
    ref = SpecEngine(params, draft, cfg, device=dev)
    ar, _ = ref.generate_ar(prompt, max_new_tokens=new, eos_token_id=-1)
    report = {"rank": args.rank, "procs": args.procs, "stages": p,
              "device": str(dev), "dtype": mc.dtype,
              "transport": ("gloo through pinned host buffers" if staged
                            else "gloo")}

    def run(name, eng, method="generate_fused"):
        t0 = time.perf_counter()
        out, stats = getattr(eng, method)(prompt, max_new_tokens=new,
                                          eos_token_id=-1)
        if stats["new_tokens"] != new:
            raise AssertionError(f"multihost {name}: {stats}")
        report[name] = {**_check(name, out, ar, ref, prompt,
                                 dev.type == "cpu"),
                        **{k: stats[k] for k in ("rounds", "turns")
                           if k in stats},
                        "seconds": time.perf_counter() - t0}
        print(f"[rank {args.rank}] {name}: ok {stats}", flush=True)

    for schedule in SCHEDULES:
        eng = PipelineEngine(params, draft, cfg, schedule=schedule,
                             device=dev, mesh=stage_mesh(p, distributed=True))
        run(schedule, eng)
        report[schedule]["layers_here"] = eng.n_layers
    cfg2 = dataclasses.replace(cfg, topology=StageTopology.even(2 * p,
                                                                p // 2))
    run("continuous_pp_x_tp", PipelineEngine(
        params, draft, cfg2, schedule="continuous", device=dev,
        mesh=stage_tp_mesh(p // 2, 2, distributed=True)))
    gal = TPEngine(params, draft, cfg, mesh=tp_mesh(args.procs,
                                                   distributed=True),
                   galaxy=True, device=dev)
    run(f"galaxy_tp{args.procs}", gal, "generate")
    if not gal.forward_fn.engaged:
        raise AssertionError("multihost galaxy: the galaxy forward never ran")
    report[f"galaxy_tp{args.procs}"]["engaged"] = gal.forward_fn.engaged
    report["comm"] = {op: {"calls": c, "bytes": b, "seconds": t}
                      for op, (c, b, t) in gal.mesh.group.stats.items()}
    return report


def parent(args) -> int:
    from flowspec_tpu_torch.runtime.engine import resolve_device
    resolve_device(args.device)          # no card: raise, never fall back
    if args.stages % args.procs or (args.stages // 2) % args.procs:
        raise ValueError(f"{args.stages} stages (and {args.stages // 2} for "
                         f"the stage x tp mesh) must split over "
                         f"{args.procs} processes")
    out = Path(args.out).resolve()        # the children run from ROOT
    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(args.procs):
        (out / f"rank{r}.json").unlink(missing_ok=True)
        logs.append(open(out / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "flowspec_tpu_torch.multihost_dryrun",
             "--rank", str(r), "--port", str(port), "--procs",
             str(args.procs), "--stages", str(args.stages), "--device",
             args.device, "--out", str(out), "--timeout",
             str(args.timeout)],
            cwd=ROOT, stdout=logs[-1], stderr=subprocess.STDOUT))
    codes = []
    try:
        for q in procs:
            left = args.timeout - (time.perf_counter() - t0)
            try:
                codes.append(q.wait(timeout=max(left, 1.0)))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        for log in logs:
            log.close()
    reports = [json.loads((out / f"rank{r}.json").read_text())
               if (out / f"rank{r}.json").exists() else None
               for r in range(args.procs)]
    ok = all(c == 0 for c in codes) and all(reports)
    for r, code in enumerate(codes):
        if code != 0:
            tail = (out / f"rank{r}.log").read_text().strip().splitlines()
            print(f"--- rank {r} (exit {code}):\n" + "\n".join(tail[-20:]),
                  file=sys.stderr)
    print(json.dumps({"ok": ok, "procs": args.procs, "stages": args.stages,
                      "device": args.device, "exit_codes": codes,
                      "wall_s": time.perf_counter() - t0,
                      "ranks": reports}))
    return 0 if ok else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank is None:
        return parent(args)
    report = child(args)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    (Path(args.out) / f"rank{args.rank}.json").write_text(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
