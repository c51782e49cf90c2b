#!/usr/bin/env python3
"""Where a speculative round of the PyTorch port spends its time.

    python3 tools/torch_profile_round.py [--model 7b|13b]
                                         [--quant int8|nf4|int4|mixed]
                                         [--fused] [--old-turns]

Builds the chip_smoke.py serving setup (random base of the given model and
quantization kind from a seeded torch.Generator, the committed thin draft,
bench.py's d8/tau0.2 tree; default 7b int8), runs one warm-up request, then
profiles one request of 64 prompt + 128 new tokens with torch.profiler
(CPU + CUDA activities). Prints one JSON line: wall time, summed
device-kernel time, the device's idle share of the wall time, rounds, and
device time by kernel family (`chip_smoke.family`: this port's six CUDA
kernels, the head's merge pass as `head_select`; cuBLAS GEMMs (the lm_head);
sort/top-k; everything else).

`--fused` profiles `generate_fused` instead: the round as a replayed CUDA
graph (one warm-up request captures it first). The line adds the graph's
launches a replay as the wrappers counted them at capture, the profiler's
kernels a replay by family, and the capture's seconds; then, from one more
request served untraced with the port's recorder on
(`flowspec_tpu_torch/utils/profiler.py prof`), the mean device ms of a
round's graph and the mean device idle between two rounds, in
microseconds, as its `round` spans read them (the benchmark's
`round_device_ms` and `round_gap_us`).

The idle share is one less the device's busy time over the wall, the busy
time being the union of the kernels' intervals.

`--old-turns` instead serves chip_smoke.py's three requests four times
without the profiler (through `generate_fused` with `--fused`, each side
with graphs of its own), in turns (new, old, old, new): "old" routes the
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


def old_turns(eng, prompts, new_tokens, fused=False) -> dict:
    """Serve `prompts` in turns new, old, old, new; per turn and per side
    tok/s and wall ms per round (prefill included in the wall time). With
    `fused`, through generate_fused, each side with graphs of its own
    (captured in the warm-up)."""
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

    graphs = {"new": {}, "old": {}}
    serve_fn = eng.generate_fused if fused else eng.generate

    def serve(side):
        for (mod, name), fn in (new if side == "new" else old).items():
            setattr(mod, name, fn)
        eng._graphs = graphs[side]
        try:
            t0 = time.perf_counter()
            rounds = tokens = 0
            for p in prompts:
                _, stats = serve_fn(p, max_new_tokens=new_tokens,
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

    for side in ("new", "old"):                      # warm-up of both
        serve(side)
    turns = [serve(side) for side in ("new", "old", "old", "new")]
    sides = {"new": [turns[0], turns[3]], "old": [turns[1], turns[2]]}
    return {"turns": dict(zip(("new_1", "old_1", "old_2", "new_2"),
                              turns)),
            **{side: {k: statistics.mean(r[k] for r in rows)
                      for k in ("tok_s", "wall_ms_per_round")}
               for side, rows in sides.items()}}


def recorded_rounds(eng, prompt, new_tokens) -> dict:
    """One request through generate_fused with the recorder on: its rounds'
    mean graph device ms and mean device idle between rounds (us)."""
    from flowspec_tpu_torch.utils.profiler import prof
    prof.reset()
    prof.enabled = True
    try:
        eng.generate_fused(prompt, max_new_tokens=new_tokens,
                           eos_token_id=-1)
    finally:
        prof.enabled = False
    rounds = [sp for sp in prof.spans if sp.name == "round"]
    gaps = [sp.gap_ms for sp in rounds if sp.gap_ms is not None]
    prof.reset()
    return {"round_device_ms": statistics.mean(sp.device_ms
                                               for sp in rounds),
            "round_gap_us": 1e3 * statistics.mean(gaps) if gaps else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="7b", choices=("7b", "13b"))
    ap.add_argument("--quant", default="int8",
                    choices=("int8", "nf4", "int4", "mixed"))
    ap.add_argument("--fused", action="store_true",
                    help="profile generate_fused (replayed CUDA graphs)")
    ap.add_argument("--old-turns", action="store_true",
                    help="serve with the new and the old kernels in turns")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_round: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    eng, prompts, _ = cs.make_engine(dev, args.model, args.quant)
    head = {"model": args.model, "quant": args.quant,
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": cs.nvidia_smi()}
    if args.old_turns:
        print(json.dumps({
            **head, "requests": len(prompts),
            "new_tokens_each": cs.NEW_TOKENS, "fused": args.fused,
            **old_turns(eng, prompts, cs.NEW_TOKENS, args.fused)}))
        return 0
    fn = eng.generate_fused if args.fused else eng.generate
    fn(prompts[0], max_new_tokens=cs.NEW_TOKENS, eos_token_id=-1)
    torch.cuda.synchronize()
    row = {**head, "path": "fused" if args.fused else "eager",
           **cs.profile_request(fn, prompts[1], cs.NEW_TOKENS)}
    if args.fused:
        (g,) = cs.graphs_of(eng, "spec")
        row.update(graph_launches_per_replay=g.launches,
                   graph_capture_s=g.capture_s, **recorded_rounds(
                       eng, prompts[1], cs.NEW_TOKENS))
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
