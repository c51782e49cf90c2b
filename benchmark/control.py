"""The readings a cell's check limits are set from (not run by the
benchmark's runs).

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--out f.jsonl]

For each seed, in one process: the cell's weights and engine from the
seed, one block of the seed's requests (every size of the mix, the longest
among them) served through `SpecEngine.generate_fused`, the run's sample
of them (`lib/check.py`), and the family's plain reference over the
sample. Each line gives the check's numbers (`check.numbers`) for
- `program`: the served tokens, as the benchmark's runs judge them;
- `control_<precision>`: at each served position the token that the
  reference computed in a lower precision (`CONTROLS`, the first one the
  configuration's control) puts first: what the program would read if it
  served that precision;
- `witness_bf16`: the same for a plain bfloat16 forward of the reference,
  the configuration's own precision.
A limit lies between the program's largest reading and the control's
smallest.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import run as bench_run
from benchmark.lib import check, spec, traffic
from benchmark.reference import precision


# the lower precisions read beside a configuration's weights: the first
# is its control (`reference/precision.py LOWER`)
CONTROLS = {"int8": ("int4",), "bfloat16": ("fp8", "int8")}


def readings(name_: str, seed: int, device="cuda", root=spec.ROOT,
             bench: dict | None = None) -> dict:
    bench = bench or spec.load_benchmark()
    c = spec.cell(bench, name_)
    cfg, mix = spec.config(c["config"], root), spec.mix(c["traffic"], root)
    w, eng = bench_run.build(cfg, mix, seed, device, root)
    source = traffic.requests(mix, seed, cfg["vocab_size"])
    reqs = [bench_run.serve(eng, next(source)) for _ in range(mix["block"])]
    del eng
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    if any(r.failed for r in reqs):
        raise RuntimeError(f"seed {seed}: a request failed")
    picked = [reqs[i] for i in check.sample(
        reqs, seed, mix["check"]["served_tokens"])]
    margins = []
    exact = bench_run.reference_logits(w, cfg, picked, device,
                                       margins=margins, root=root)
    chosen = {"program": [r.tokens for r in picked]}
    for name in CONTROLS[cfg["weights"]["precision"]]:
        lower = bench_run.reference_logits(w, cfg, picked, device,
                                           weight=getattr(precision, name),
                                           root=root)
        chosen[f"control_{name}"] = [lo.argmax(-1) for lo in lower]
    witness = bench_run.reference_logits(w, cfg, picked, device,
                                         dtype=torch.bfloat16, root=root)
    chosen["witness_bf16"] = [x.argmax(-1) for x in witness]
    margin = spec.limits(name_, root).get("router_margin")
    out = {"cell": name_, "seed": seed}
    for what, toks in chosen.items():
        out[what] = check.numbers(exact, toks, margins, margin)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
