#!/usr/bin/env python3
"""The wgmma dequant-matmuls and the head top-k under
torch.profiler, on one card.

    python3 tools/torch_matmul_profile.py [--sass]
                                          [--kernels int8,nf4,int4,head]

What chip_smoke.py's event timing cannot separate: at each base and draft
shape of the 7B paths and of the benchmark cells (Qwen2-7B, Mixtral-8x7B's
draft; int4: the 13B attention projections at M 64 / 81; head:
chip_smoke.py's HEAD_SHAPES, V 32000, k 10), the device times of the main
kernel and, for the head, of its merge pass and the gap between them (the
merge is a dependent launch that starts early and waits; a dequant-matmul
is one kernel), and the timing floor, i.e. what one tiny elementwise
launch reads when it is timed like a kernel. The L2 is flushed before every
launch. `--sass` also dumps `cuobjdump -sass` of the libraries. One JSON
line per row on stdout and in chiprun_out/matmul_profile.jsonl; the ptxas
report goes to ptxas_matmul.log beside it. Builds the named kernels only
(seconds). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def operands(kind, m, n_in, n_out, dev, gen):
    import torch
    x = torch.randn((1, m, n_in), generator=gen, device=dev).to(
        torch.bfloat16)
    if kind == "int8":
        q = torch.randint(-127, 128, (n_in, n_out), generator=gen,
                          device=dev).to(torch.int8)
        s = (torch.rand((n_out,), generator=gen, device=dev) + 0.5) * (
            n_in ** -0.5 / 127.0)
    else:
        q = torch.randint(0, 256, (n_in // 2, n_out), generator=gen,
                          device=dev).to(torch.uint8)
        s = (torch.rand((n_in // 64, n_out), generator=gen, device=dev)
             + 0.5) * n_in ** -0.5
    return x, q, s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", action="store_true",
                    help="dump cuobjdump -sass of the libraries")
    ap.add_argument("--kernels", default="int8,nf4",
                    help="comma-separated of int8, nf4, int4, head")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_matmul_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from flowspec_tpu_torch.ops import _build
    from flowspec_tpu_torch.ops import quant_matmul as qm
    from flowspec_tpu_torch.ops.head_topk import head_plan, head_topk_int8

    dev = torch.device("cuda")
    kinds = args.kernels.split(",")
    names = [{"head": "head_topk"}.get(k, f"{k}_matmul") for k in kinds]
    cs.OUT_DIR.mkdir(exist_ok=True)
    _build.build(names)
    logs = {n: _build.lib_path(n).with_suffix(".log").read_text()
            for n in names}
    (cs.OUT_DIR / "ptxas_matmul.log").write_text("\n".join(
        f"== {n}\n{log}" for n, log in logs.items()))
    if args.sass:
        for n in names:
            r = subprocess.run(
                ["/usr/local/cuda/bin/cuobjdump", "-sass",
                 str(_build.lib_path(n))], capture_output=True, text=True)
            (cs.OUT_DIR / f"sass_{n}.txt").write_text(r.stdout + r.stderr)
    out = open(cs.OUT_DIR / "matmul_profile.jsonl", "w")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    emit({"device": torch.cuda.get_device_name(0),
          "nvidia_smi": cs.nvidia_smi(),
          "ptxas": {n: cs.ptxas_summary(log) for n, log in logs.items()}})
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    tiny = torch.zeros(32, device=dev)
    emit({"floor_ms": cs.time_ms(lambda: tiny.add_(1.0), flush),
          "what": "one tiny elementwise launch, timed like a kernel"})
    fns = {"int8": (qm.int8_matmul, cs.INT8_SHAPES),
           "nf4": (qm.nf4_matmul, cs.NF4_SHAPES),
           "int4": (qm.int4_matmul, cs.INT4_SHAPES),
           "head": (None, [(n, t, h, 32000) for n, t, h in cs.HEAD_SHAPES])}
    # (main kernel, second pass) by the name the profiler gives them
    parts = {"head": ("head_wgmma_kernel", "head_select_kernel")}
    prefixes = ("base_", "draft_", "qwen2_", "mixtral_")
    for kind in kinds:
        fn, shapes = fns[kind]
        main_name, second = parts.get(kind, ("qmm_kernel", None))
        for name, m, n_in, n_out in shapes:
            if kind in ("int8", "nf4") and (
                    not name.startswith(prefixes) or m in (9, 96)):
                continue
            if kind == "head":
                x, q, s = operands("int8", m, n_in, n_out, dev, gen)
                x = x[0]
                call = lambda: head_topk_int8(x, q, s, 10)
                plan = head_plan(m, n_in, n_out)._asdict()
            else:
                x, q, s = operands(kind, m, n_in, n_out, dev, gen)
                call = lambda: fn(x, q, s)
                plan = qm.matmul_plan(m, n_in, n_out, kind)._asdict()
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    cs.flush_l2(flush)
                    call()
                torch.cuda.synchronize()
            ev = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
            main_ev = [e for e in ev if main_name in e.name]
            red = [e for e in ev if second and second in e.name]
            row = {"profile": kind, "shape": name, "plan": plan,
                   "main_us": [e.time_range.elapsed_us() for e in main_ev]}
            if red:
                row["second_us"] = [e.time_range.elapsed_us() for e in red]
                row["gap_us"] = [r.time_range.start - a.time_range.end
                                 for a, r in zip(main_ev, red)]
            emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
