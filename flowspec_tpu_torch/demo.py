"""Interactive demo: speculative decoding on a chat prompt.

Port of the root `demo.py`: the same engines, flags and printed lines, on
the card unless `--cpu`. Reference: run_pipe.py — loads the stage model,
builds a vicuna/llama chat prompt, warms up, runs N timed generations,
prints the decoded output and throughput. Here: one process, any engine
(single-device / pipeline / TP / galaxy / serve).

With real checkpoints (the tokenizer needs `transformers`):
    python -m flowspec_tpu_torch.demo --model /path/to/vicuna-7b \
        --draft /path/to/EAGLE-vicuna --engine pipeline \
        --schedule continuous --prompt "Tell me a story."

Without checkpoints (random weights from a generator seeded 0, the draft
from one seeded 1; token-level demo):
    python -m flowspec_tpu_torch.demo --random 7b \
        --thin-draft checkpoints/draft_7b_thin_fp16.npz --max-new-tokens 64
    python -m flowspec_tpu_torch.demo --cpu --random tiny
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="HF model dir (safetensors)")
    ap.add_argument("--draft", help="EAGLE draft checkpoint dir")
    ap.add_argument("--thin-draft", help="distilled thin-draft npz "
                    "(tools/train_bench_draft.py checkpoint)")
    ap.add_argument("--random", choices=["tiny", "1b", "7b"],
                    help="use random weights of this size instead")
    ap.add_argument("--engine", default="single",
                    choices=["single", "pipeline", "tp", "galaxy", "serve"])
    ap.add_argument("--slots", type=int, default=4,
                    help="serve engine: concurrent decode slots")
    ap.add_argument("--requests", type=int, default=8,
                    help="serve engine: queued copies of the prompt")
    ap.add_argument("--queue-order", default="fifo",
                    choices=["fifo", "sjf", "lpt"],
                    help="serve engine: admission policy")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="serve engine: shared_prefix='auto' — the common"
                         " prompt prefix is prefilled once and cached")
    ap.add_argument("--schedule", default="continuous")
    ap.add_argument("--template", default="vicuna")
    ap.add_argument("--prompt", default="Tell me a short story about a robot.")
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch "
                         "versions); the default is the card")
    args = ap.parse_args(argv)

    from flowspec_tpu_torch.config import (
        EngineConfig, SamplingConfig, StageTopology, TreeConfig,
    )
    from flowspec_tpu_torch.eval.sweep import load_pair
    from flowspec_tpu_torch.runtime import SpecEngine
    from flowspec_tpu_torch.runtime.engine import resolve_device
    from flowspec_tpu_torch.utils.chat import build_prompt

    dev = resolve_device("cpu" if args.cpu else None)
    # the sweep's loader and sizes, unquantized; the demo's tiny model
    # keeps 2 layers
    mc, params, draft, tokenizer = load_pair(
        args.model, args.draft, args.random, trained_draft=args.thin_draft,
        cpu=args.cpu, tiny_layers=2)

    tc = TreeConfig(node_cap=96, leaf_cap=96, depth_cap=16)
    topo = StageTopology.even(mc.num_hidden_layers, args.stages)
    cfg = EngineConfig(model=mc, tree=tc,
                       sampling=SamplingConfig(temperature=args.temperature),
                       topology=topo, max_new_tokens=args.max_new_tokens,
                       max_seq_len=1152)

    if args.engine == "pipeline":
        from flowspec_tpu_torch.parallel import PipelineEngine
        eng = PipelineEngine(params, draft, cfg, schedule=args.schedule,
                             device=dev)
        gen = eng.generate_fused
    elif args.engine in ("tp", "galaxy"):
        from flowspec_tpu_torch.parallel import TPEngine
        eng = TPEngine(params, draft, cfg, galaxy=args.engine == "galaxy",
                       device=dev)
        gen = eng.generate_fused
    elif args.engine == "serve":
        from flowspec_tpu_torch.runtime.batched import BatchedSpecEngine
        eng = BatchedSpecEngine(params, draft, cfg, batch_size=args.slots,
                                device=dev)
        gen = None   # serve path handled below
    else:
        eng = SpecEngine(params, draft, cfg, device=dev)
        gen = eng.generate_fused

    if tokenizer is not None:
        text = build_prompt([(args.prompt, None)], template=args.template)
        prompt_ids = tokenizer(text).input_ids
        eos = tokenizer.eos_token_id
    else:
        prompt_ids = [int(t) for t in np.random.default_rng(0).integers(
            10, mc.vocab_size - 1, 32)]
        eos = -1

    print(f"engine={args.engine} schedule={args.schedule} "
          f"prompt_len={len(prompt_ids)}")
    if args.engine == "serve":
        prompts = [prompt_ids] * args.requests
        kw = {"queue_order": args.queue_order}
        if args.prefix_cache:
            kw["shared_prefix"] = "auto"
        eng.serve(prompts, max_new_tokens=args.max_new_tokens,
                  eos_token_id=eos, **kw)
        t0 = time.perf_counter()
        outs, stats = eng.serve(prompts, max_new_tokens=args.max_new_tokens,
                                eos_token_id=eos, **kw)
        dt = time.perf_counter() - t0
        out = outs[0]
    else:
        gen(prompt_ids, max_new_tokens=args.max_new_tokens, eos_token_id=eos)
        t0 = time.perf_counter()
        out, stats = gen(prompt_ids, max_new_tokens=args.max_new_tokens,
                         eos_token_id=eos)
        dt = time.perf_counter() - t0

    new = out[len(prompt_ids):]
    if tokenizer is not None:
        print("---\n" + tokenizer.decode(new) + "\n---")
    else:
        print("generated token ids:", new[:32], "..." if len(new) > 32 else "")
    line = (f"{stats['new_tokens']} tokens in {dt:.2f}s = "
            f"{stats['new_tokens'] / dt:.2f} tok/s | "
            f"accept/round = {stats.get('accept_per_round') or 0:.2f}")
    if "slot_utilization" in stats:
        line += f" | slot_utilization = {stats['slot_utilization']:.2f}"
    print(line)
    return stats


if __name__ == "__main__":
    main()
