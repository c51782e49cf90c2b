"""Parameter-sweep CLI: the reference's `eval/eval_params.py` as a module.

Port of `flowspec_tpu/eval/sweep.py`, with its flags and its row keys.
Reference: eval/eval_params.py:196-205 sweeps a (init_depth, expand_depth)
grid by mutating the global run_config between harness runs; here each grid
point builds an immutable TreeConfig and a fresh engine, runs the shared
harness (flowspec_tpu_torch/eval/harness.py) over the question files, and
appends one summary JSON line per (config, dataset) to the results file.

Usage (random weights; on the card unless --cpu):
    python -m flowspec_tpu_torch.eval.sweep --cpu --random tiny \
        --data data/qa/question.jsonl --limit 1 \
        --depths 3,4 --expand-depths 2 --chunk-lens 8 \
        --max-new-tokens 8 --out sweep_results.jsonl

With real checkpoints, pass --model/--draft; the model's HF tokenizer is
used (`transformers`, imported in that branch only). Without checkpoints a
deterministic byte-level tokenizer keeps the pipeline runnable end-to-end
(throughput/acceptance numbers are then architecture smoke numbers, not
model-quality numbers). `--random` draws the base from a torch.Generator
seeded 0 (`models/llama.py random_llama_params` for a quantized base, the
law of `init_llama_params` for a plain one: the JAX package's laws, not
its bits) and a random draft from one seeded 1.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time


def byte_tokenizer(vocab_size: int):
    """Deterministic text<->token fallback so the harness can run without a
    checkpoint: bytes offset past the special-token range, clipped to vocab."""
    lo = 3

    def tok(text: str):
        return [lo + (b % (vocab_size - lo)) for b in text.encode()][:512]

    def detok(tokens):
        return bytes(int(max(0, t - lo)) % 256 for t in tokens).decode(
            "latin-1")

    return tok, detok


def build_engine(args, mc, tc, params, draft, temperature: float):
    from flowspec_tpu_torch.config import (
        EngineConfig, SamplingConfig, StageTopology,
    )

    dev = "cpu" if args.cpu else None
    cfg = EngineConfig(
        model=mc, tree=tc,
        sampling=SamplingConfig(temperature=temperature),
        topology=StageTopology.even(mc.num_hidden_layers, args.stages),
        max_new_tokens=args.max_new_tokens,
        max_seq_len=args.max_seq_len)
    if args.engine == "pipeline":
        from flowspec_tpu_torch.parallel import PipelineEngine
        return PipelineEngine(params, draft, cfg, schedule=args.schedule,
                              device=dev)
    if args.engine == "tp":
        from flowspec_tpu_torch.parallel import TPEngine
        return TPEngine(params, draft, cfg, device=dev)
    if args.engine == "serve":
        from flowspec_tpu_torch.runtime.batched import BatchedSpecEngine
        # adapt_tree=False: the batch-adaptive table would silently cap
        # total_tokens at 47/31 for >=2/>=4 slots, making every sweep row
        # above the cap measure the same tree while recording the requested
        # one. A sweep must run exactly the config it reports.
        return BatchedSpecEngine(params, draft, cfg,
                                 batch_size=args.serve_slots,
                                 adapt_tree=False,
                                 dynamic_tree=args.dynamic_tree, device=dev)
    from flowspec_tpu_torch.runtime import SpecEngine
    return SpecEngine(params, draft, cfg, device=dev)


def random_config(kind: str, stages: int):
    """The ModelConfig of `--random` tiny / 1b / 7b."""
    from flowspec_tpu_torch.config import ModelConfig
    if kind == "tiny":
        return ModelConfig.tiny(vocab_size=1024, n_layers=stages)
    if kind == "1b":
        return ModelConfig(hidden_size=2048, intermediate_size=5504,
                           num_hidden_layers=16, num_attention_heads=16,
                           num_key_value_heads=16)
    return ModelConfig.llama_7b()


def auto_tokenizer(model_dir: str):
    """A checkpoint's HF tokenizer; `transformers` is imported here only,
    and its absence is an error that says so."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            "--model needs the `transformers` package for the checkpoint's "
            "tokenizer, and it is not installed; without a checkpoint use "
            "--random") from e
    return AutoTokenizer.from_pretrained(model_dir)


def load_pair(model=None, draft=None, random=None, quant="none",
              trained_draft=None, cpu=False, tiny_layers=4):
    """(ModelConfig, params, draft, tokenizer) of a checkpoint (`model`,
    `draft`; its HF tokenizer) or of random weights (`random`, `quant`;
    tokenizer None), then the thin draft `trained_draft` in place of the
    draft, quantized as the base ("int8" for "mixed"). `tiny_layers`: the
    depth of the random tiny model."""
    import torch
    from flowspec_tpu_torch.draft.eagle import (
        init_eagle_params, load_eagle_params, load_thin_draft,
        quantize_eagle_params,
    )
    from flowspec_tpu_torch.runtime.engine import resolve_device

    dev = resolve_device("cpu" if cpu else None)

    def generator(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    need_draft = not trained_draft
    tokenizer = None
    if model:
        from flowspec_tpu_torch.models.loader import (
            load_llama_params, load_model_config,
        )
        tokenizer = auto_tokenizer(model)
        mc = load_model_config(model)
        params = load_llama_params(model, mc, device=dev)
        dr = None
        if draft:
            dr = load_eagle_params(draft, embed=params.embed)
        elif need_draft:
            dr = init_eagle_params(generator(1), mc, embed=params.embed)
    else:
        mc = random_config(random or "tiny", tiny_layers)
        if quant != "none":
            from flowspec_tpu_torch.models.llama import random_llama_params
            params = random_llama_params(mc, generator(0), dev, quant)
        else:
            from flowspec_tpu_torch.entry import random_llama
            params = random_llama(mc, generator(0), dev)
        dr = None
        if need_draft:
            dr = init_eagle_params(generator(1), mc, embed=params.embed)
            if quant != "none":
                dr = quantize_eagle_params(
                    dr, "int8" if quant == "mixed" else quant)

    if trained_draft:
        dr = load_thin_draft(trained_draft, params.embed)
        if quant != "none":
            dr = quantize_eagle_params(
                dr, "int8" if quant == "mixed" else quant)
    return mc, params, dr, tokenizer


def tree_config(args, depth: int, expand_depth: int, chunk_len: int,
                score_temp: float):
    """The TreeConfig of one grid point."""
    from flowspec_tpu_torch.config import TreeConfig
    return TreeConfig(top_k=args.top_k, depth=depth,
                      total_tokens=args.total_tokens,
                      expand_depth=expand_depth, chunk_len=chunk_len,
                      depth_cap=max(24, depth + expand_depth + 2),
                      score_temperature=score_temp)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", help="HF model dir")
    ap.add_argument("--draft", help="EAGLE draft dir")
    ap.add_argument("--random", choices=["tiny", "1b", "7b"], default=None,
                    help="random weights of this size instead of --model")
    ap.add_argument("--engine", default="single",
                    choices=["single", "pipeline", "tp", "serve"])
    ap.add_argument("--serve-slots", type=int, default=4,
                    help="serve engine: concurrent decode slots")
    ap.add_argument("--dynamic-tree", action="store_true",
                    help="serve engine: per-dispatch tree variants keyed "
                         "on the live active-lane count")
    ap.add_argument("--queue-order", default="fifo",
                    choices=["fifo", "sjf", "lpt"],
                    help="serve engine: admission policy")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="serve engine: auto-detect the chat template's "
                         "shared preamble and prefill it once "
                         "(shared_prefix='auto')")
    ap.add_argument("--schedule", default="continuous")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--data", nargs="+", required=True,
                    help="question.jsonl path(s)")
    ap.add_argument("--limit", type=int, default=5,
                    help="questions per dataset")
    ap.add_argument("--max-conv-turns", type=int, default=1)
    ap.add_argument("--depths", default="6", help="comma list (ref init_depth)")
    ap.add_argument("--expand-depths", default="6",
                    help="comma list (ref expand_depth)")
    ap.add_argument("--chunk-lens", default="16", help="comma list")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--total-tokens", type=int, default=80)
    ap.add_argument("--score-temps", default="1",
                    help="comma list of beam score temperatures (tree-"
                         "shape knob, TreeConfig.score_temperature)")
    ap.add_argument("--temperatures", default=None,
                    help="comma list — outer sweep axis, like the "
                         "reference's `temperatures` loop "
                         "(eval/run_pipe_eval.py:191); overrides "
                         "--temperature")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--resume", action="store_true",
                    help="multi-turn KV reuse: turn N prefills only the "
                         "new tokens (engine resume_and_generate) instead "
                         "of re-prefilling the whole conversation")
    ap.add_argument("--trained-draft", default=None,
                    help="npz thin-draft checkpoint "
                         "(tools/train_bench_draft.py) to use instead of "
                         "a random draft")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "nf4", "int4", "mixed"])
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--max-seq-len", type=int, default=2560)
    ap.add_argument("--template", default="vicuna")
    ap.add_argument("--out", default="sweep_results.jsonl")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch "
                         "versions); the default is the card")
    ap.add_argument("--no-fused", action="store_true",
                    help="host round loop instead of the fused decode loop "
                         "(the round as a replayed CUDA graph on the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from flowspec_tpu_torch.eval.harness import (
        load_questions, run_eval, run_eval_serve,
    )

    mc, params, draft, tokenizer = load_pair(
        args.model, args.draft, args.random, args.quant, args.trained_draft,
        args.cpu, tiny_layers=args.stages)
    if tokenizer is None:
        tok, detok = byte_tokenizer(mc.vocab_size)
    else:
        tok, detok = (
            lambda s: tokenizer(s).input_ids,
            lambda ts: tokenizer.decode(ts, skip_special_tokens=True))
    temps = ([float(x) for x in args.temperatures.split(",")]
             if args.temperatures else [args.temperature])
    grid = list(itertools.product(
        temps,
        [int(x) for x in args.depths.split(",")],
        [int(x) for x in args.expand_depths.split(",")],
        [int(x) for x in args.chunk_lens.split(",")],
        [float(x) for x in args.score_temps.split(",")]))

    rows = []
    for temperature, depth, expand_depth, chunk_len, stemp in grid:
        tc = tree_config(args, depth, expand_depth, chunk_len, stemp)
        eng = build_engine(args, mc, tc, params, draft, temperature)
        # the fused decode loop unless --no-fused; --resume keeps state
        # across turns through the host round loop (engine.generate /
        # resume_and_generate), whatever the gen_fn
        gen_fn = (eng.generate if args.no_fused else
                  getattr(eng, "generate_fused", eng.generate))
        gen = lambda toks: gen_fn(
            toks, max_new_tokens=args.max_new_tokens, eos_token_id=-1)
        for path in args.data:
            name = os.path.basename(os.path.dirname(path)) or path
            qs = load_questions(path, limit=args.limit)
            t0 = time.perf_counter()
            if args.engine == "serve":
                summary = run_eval_serve(
                    eng, tok, qs, name=name, template=args.template,
                    max_new_tokens=args.max_new_tokens,
                    queue_order=args.queue_order,
                    prefix_cache=args.prefix_cache)
            else:
                res = run_eval(gen, tok, detok, qs, name=name,
                               template=args.template,
                               max_turns=args.max_conv_turns,
                               engine=eng if args.resume else None,
                               resume=args.resume,
                               max_new_tokens=args.max_new_tokens)
                summary = res.summary()
            row = dict(temperature=temperature, depth=depth,
                       expand_depth=expand_depth, score_temp=stemp,
                       chunk_len=chunk_len, engine=args.engine,
                       schedule=args.schedule,
                       draft=("trained" if args.trained_draft else "random"),
                       quant=args.quant,
                       wall_s=round(time.perf_counter() - t0, 3),
                       **summary)
            rows.append(row)
            print(json.dumps(row))
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
