#!/usr/bin/env python3
"""Where a speculative round of the PyTorch port spends its time.

    python3 tools/torch_profile_round.py [--model 7b|13b]
                                         [--quant int8|nf4|int4|mixed]
                                         [--old-turns]

Builds the chip_smoke.py serving setup (random base of the given model and
quantization kind from a seeded torch.Generator, the committed thin draft,
bench.py's d8/tau0.2 tree; default 7b int8), runs one warm-up request, then
profiles one request of 64 prompt + 128 new tokens with torch.profiler
(CPU + CUDA activities). Prints one JSON line: wall time, summed
device-kernel time, the device's idle share of the wall time, rounds, and
device time by kernel family (this port's six CUDA kernels, the split-K
reduce pass of int8 / nf4 / int4 as `matmul_reduce`, the head's merge pass
as `head_select`; cuBLAS GEMMs (the f32 lm_head); sort/top-k; everything
else). The wgmma int4 kernel runs under both `int4_matmul` and
`int4_matmul_smallm` and is counted as `int4_matmul`.

`--old-turns` instead serves chip_smoke.py's three requests four times
without the profiler, in turns (new, old, old, new): "old" routes the
products, the attention and the head of the serving path to the earlier
versions of the six redesigned kernels (`int8_matmul_strip`,
`nf4_matmul_strip`, `int4_matmul_strip` above 32 rows and
`int4_matmul_splitk` up to 32, `tree_attention_simt`, `head_topk_strip`)
for the length of the turn. It prints tok/s and wall ms per round of each turn and of each
side, so what the redesigned kernels and their wrappers cost or gain end to
end is read inside one process. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def family(name: str) -> str:
    n = name.lower()
    for key, fam in (("qmm_kernel<0", "int8_matmul"),
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
                     ("cutlass", "cublas_gemm"), ("sort", "sort_topk"),
                     ("topk", "sort_topk"), ("radix", "sort_topk")):
        if key in n:
            return fam
    return "other"


def old_turns(eng, prompts, new_tokens) -> dict:
    """Serve `prompts` in turns new, old, old, new; per turn and per side
    tok/s and wall ms per round (prefill included in the wall time)."""
    import torch
    from flowspec_tpu_torch.draft import beam
    from flowspec_tpu_torch.models import llama
    from flowspec_tpu_torch.ops import head_topk as hk
    from flowspec_tpu_torch.ops import quant_matmul as qm
    from flowspec_tpu_torch.ops import tree_attention as ta
    from flowspec_tpu_torch.ops.quant import Int8Tensor

    def int4_old(x, q, s):
        if x.shape[0] * x.shape[1] <= qm.SMALL_M:
            return qm.int4_matmul_splitk(x, q, s)
        return qm.int4_matmul_strip(x, q, s)

    def head_old(x, head, k):        # `hk.head_topk` with the old kernel
        if not isinstance(head, Int8Tensor):
            return hk.head_topk(x, head, k)
        lp, tok = hk.head_topk_strip(x.reshape(-1, x.shape[-1]), head.q,
                                     head.scale, k)
        return (lp.reshape(*x.shape[:-1], k),
                tok.reshape(*x.shape[:-1], k))

    new = {(qm, "int8_matmul"): qm.int8_matmul,
           (qm, "nf4_matmul"): qm.nf4_matmul,
           (qm, "int4_matmul"): qm.int4_matmul,
           (llama, "tree_attention"): ta.tree_attention,
           (beam, "head_topk"): hk.head_topk}
    old = {(qm, "int8_matmul"): qm.int8_matmul_strip,
           (qm, "nf4_matmul"): qm.nf4_matmul_strip,
           (qm, "int4_matmul"): int4_old,
           (llama, "tree_attention"): ta.tree_attention_simt,
           (beam, "head_topk"): head_old}

    def serve(route):
        for (mod, name), fn in route.items():
            setattr(mod, name, fn)
        try:
            t0 = time.perf_counter()
            rounds = tokens = 0
            for p in prompts:
                _, stats = eng.generate(p, max_new_tokens=new_tokens,
                                        eos_token_id=-1)
                rounds += stats["rounds"]
                tokens += stats["new_tokens"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for (mod, name), fn in new.items():
                setattr(mod, name, fn)
        return {"tok_s": tokens / wall, "rounds": rounds,
                "wall_ms_per_round": wall * 1e3 / rounds}

    for route in (new, old):                         # warm-up of both
        serve(route)
    turns = [serve(r) for r in (new, old, old, new)]
    sides = {"new": [turns[0], turns[3]], "old": [turns[1], turns[2]]}
    return {"turns": dict(zip(("new_1", "old_1", "old_2", "new_2"),
                              turns)),
            **{side: {k: statistics.mean(r[k] for r in rows)
                      for k in ("tok_s", "wall_ms_per_round")}
               for side, rows in sides.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="7b", choices=("7b", "13b"))
    ap.add_argument("--quant", default="int8",
                    choices=("int8", "nf4", "int4", "mixed"))
    ap.add_argument("--old-turns", action="store_true",
                    help="serve with the new and the old kernels in turns")
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
    if args.old_turns:
        print(json.dumps({
            "model": args.model, "quant": args.quant,
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": cs.nvidia_smi(), "requests": len(prompts),
            "new_tokens_each": cs.NEW_TOKENS,
            **old_turns(eng, prompts, cs.NEW_TOKENS)}))
        return 0
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
