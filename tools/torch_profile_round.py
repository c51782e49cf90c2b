#!/usr/bin/env python3
"""Where a speculative round of the PyTorch port spends its time.

    python3 tools/torch_profile_round.py [--model 7b|13b]
                                         [--quant int8|nf4|int4|mixed]

Builds the chip_smoke.py serving setup (random base of the given model and
quantization kind from a seeded torch.Generator, the committed thin draft,
bench.py's d8/tau0.2 tree; default 7b int8), runs one warm-up request, then
profiles one request of 64 prompt + 128 new tokens with torch.profiler
(CPU + CUDA activities). Prints one JSON line: wall time, summed
device-kernel time, the device's idle share of the wall time, rounds, and
device time by kernel family (this port's six CUDA kernels; cuBLAS GEMMs
(the f32 lm_head); sort/top-k; everything else). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def family(name: str) -> str:
    n = name.lower()
    for key, fam in (("int8_matmul_kernel", "int8_matmul"),
                     ("p4_matmul_kernel<true", "nf4_matmul"),
                     ("p4_matmul_kernel<false", "int4_matmul"),
                     ("int4_splitk", "int4_matmul_smallm"),
                     ("tree_attention_kernel", "tree_attention"),
                     ("head_partial_kernel", "head_topk"),
                     ("head_merge_kernel", "head_topk"),
                     ("gemm", "cublas_gemm"), ("sm90_xmma", "cublas_gemm"),
                     ("cutlass", "cublas_gemm"), ("sort", "sort_topk"),
                     ("topk", "sort_topk"), ("radix", "sort_topk")):
        if key in n:
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="7b", choices=("7b", "13b"))
    ap.add_argument("--quant", default="int8",
                    choices=("int8", "nf4", "int4", "mixed"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_round: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    eng, prompts, _ = cs.make_engine(dev, args.model, args.quant)
    eng.generate(prompts[0], max_new_tokens=cs.NEW_TOKENS, eos_token_id=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = eng.generate(prompts[1], max_new_tokens=cs.NEW_TOKENS,
                                eos_token_id=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_family, n_kernels, device_s = {}, 0, 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = ev.time_range.elapsed_us() / 1e6
        fam = family(ev.name)
        by_family[fam] = by_family.get(fam, 0.0) + dt
        n_kernels += 1
        device_s += dt
    print(json.dumps({
        "model": args.model, "quant": args.quant,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": cs.nvidia_smi(), "wall_s": wall,
        "rounds": stats["rounds"], "new_tokens": stats["new_tokens"],
        "wall_ms_per_round": wall * 1e3 / stats["rounds"],
        "device_busy_s": device_s, "device_idle_share": 1 - device_s / wall,
        "device_kernels": n_kernels,
        "kernels_per_round": n_kernels / stats["rounds"],
        "device_s_by_family": by_family}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
