"""Distil a thin EAGLE draft against a random quantized base, on the card.

    python -m flowspec_tpu_torch.train.bench_draft --scale 7b --out draft.npz

The counterpart of `tools/train_bench_draft.py`, same protocol:
  1. the base: the port's seeded random draw of the scale's kind
     (`random_llama_params`: int8 at 7b / 1b, attention int4 + FFN int8 at
     13b; a bf16 `init_llama_params` draw at tiny), or `--base`, a
     checkpoint of `models/checkpoint.py save_params`;
  2. the corpus: the base's greedy rollouts of random prompts (seeds 1..R,
     and the held-out seeds 2000.. never trained on) through
     `SpecEngine.generate_ar_fused`, and its final-norm hiddens by one
     prefill a sequence (`teacher.py`);
  3. a thin draft (width W, its own w_out back to the base's width) from a
     seeded `init_eagle_params`, trained in f32: Huber on the next hidden
     plus CE on the teacher's argmax through the shared head;
  4. the delta shrink: w_out x alpha, alpha chosen on the held-out
     rollouts;
  5. the draft quantized like the base (int8), served by `SpecEngine` on
     held-out prompts (seeds 1000..): accept a round, lossless against AR,
     the matched share;
  6. `--out`: the fp16 npz `load_thin_draft` reads, and its `.json`
     stats. Nothing is written without it.
Runs on the card unless `--device cpu`. `--corpus-cache DIR` keeps the
rollouts and hiddens under a name of this port and this base
(`teacher.corpus_path`).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from flowspec_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingConfig, TreeConfig,
)
from flowspec_tpu_torch.draft.eagle import (
    draft_view, init_eagle_params, quantize_eagle_params,
)
from flowspec_tpu_torch.models.checkpoint import load_params
from flowspec_tpu_torch.models.llama import (
    init_llama_params, random_llama_params,
)
from flowspec_tpu_torch.runtime.engine import SpecEngine, resolve_device
from flowspec_tpu_torch.train import teacher
from flowspec_tpu_torch.train.distill import (
    DraftTrainer, save_thin_draft, spec_eval, trainable_of,
)

PROMPT_LEN = 64
QUANT = {"7b": "int8", "1b": "int8", "13b": "mixed", "tiny": "none"}
ALPHAS = (0.0, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)
BASE_SEED, DRAFT_SEED, BATCH_SEED = 0, 9, 1234


def model_config(scale: str) -> ModelConfig:
    if scale == "7b":
        return ModelConfig.llama_7b()
    if scale == "13b":
        return ModelConfig.llama_13b()
    if scale == "1b":
        return ModelConfig(hidden_size=2048, intermediate_size=5504,
                           num_hidden_layers=16, num_attention_heads=16,
                           num_key_value_heads=16)
    return ModelConfig.tiny(vocab_size=64, n_layers=2)


def engine_config(mc: ModelConfig, gen_tokens: int) -> EngineConfig:
    """The JAX tool's engine: bench.py's tree caps, room for the prompt,
    the tokens and a round."""
    return EngineConfig(model=mc, tree=TreeConfig(node_cap=96, leaf_cap=96,
                                                  depth_cap=16),
                        sampling=SamplingConfig(), max_new_tokens=gen_tokens,
                        max_seq_len=PROMPT_LEN + gen_tokens + 24)


def build_base(args, mc: ModelConfig, dev):
    """(params, its law for the corpus name)."""
    if args.base:
        return load_params(args.base, device=dev), \
            f"{args.scale}_loaded_{Path(args.base).resolve().name}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(BASE_SEED)
    quant = QUANT[args.scale]
    if quant == "none":
        return init_llama_params(gen, mc, device=dev), \
            f"{args.scale}_bf16_seed{BASE_SEED}"
    return random_llama_params(mc, gen, dev, quant), \
        f"{args.scale}_{quant}_seed{BASE_SEED}"


def prompts_of(seeds, vocab: int):
    vmax = min(1000, vocab)
    return [np.random.default_rng(r).integers(10, vmax, PROMPT_LEN)
            for r in seeds]


def run(args, log=print, mark=lambda phase: None) -> dict:
    """The whole protocol; `mark(phase)` is called as each phase begins
    ("rollouts", "teacher", "train", "select", "eval", then "done"), so
    a caller can tell the phases' launches apart. Returns the stats (the
    `.json`), the trainer, the evaluation with its streams and engine, the
    per-step losses and seconds."""
    dev = resolve_device(args.device)
    mc = model_config(args.scale)
    quant = QUANT[args.scale]
    cfg = engine_config(mc, args.gen_tokens)
    dt = getattr(torch, mc.dtype)
    t0 = time.perf_counter()
    params, law = build_base(args, mc, dev)
    log(f"[{args.scale}] {law} base in {time.perf_counter() - t0:.1f}s")

    width = min(args.width, mc.hidden_size) if args.scale != "tiny" else 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(DRAFT_SEED)
    draft0 = init_eagle_params(gen, mc, embed=params.embed,
                               dtype=torch.float32, width=width)
    dcfg = draft_view(draft0, mc)
    trainer = DraftTrainer(
        trainable_of(draft0), params.embed, params.lm_head.float(), dcfg,
        lr=args.lr, decay_steps=args.steps, alpha=0.02,
        hidden_w=args.hidden_w, ce_w=args.ce_w)
    del draft0

    def served(draft):
        d = draft if quant == "none" else quantize_eagle_params(draft, quant)
        return SpecEngine(params, d, cfg, device=dev)

    seq_len = PROMPT_LEN + args.gen_tokens
    n_total = args.rollouts + args.holdout
    path = (teacher.corpus_path(args.corpus_cache, law, BASE_SEED, n_total,
                                seq_len) if args.corpus_cache else None)
    if path is not None and path.exists():
        tokens, hiddens = teacher.load_corpus(path, law, dev)
        log(f"corpus from {path}")
    else:
        mark("rollouts")
        # the untrained draft: the engine's prefill runs it, AR never does
        eng = served(trainer.draft(dt))
        seeds = list(range(1, args.rollouts + 1)) + [
            2000 + i for i in range(args.holdout)]
        t0 = time.perf_counter()
        tokens = teacher.greedy_rollouts(eng, prompts_of(seeds,
                                                         mc.vocab_size),
                                         args.gen_tokens)
        del eng
        uniq = sorted(len(set(s[PROMPT_LEN:].tolist())) for s in tokens)
        log(f"rollouts {tokens.shape} in {time.perf_counter() - t0:.1f}s, "
            f"unique generated tokens min/med/max {uniq[0]}/"
            f"{uniq[len(uniq) // 2]}/{uniq[-1]}")
        mark("teacher")
        hiddens = teacher.teacher_hiddens(params, tokens, mc)
        if path is not None:
            teacher.save_corpus(path, tokens, hiddens, law)
    tok = torch.as_tensor(tokens, device=dev)

    mark("train")
    n_params = sum(t.numel() for t in trainer.trainable.values())
    log(f"thin draft: W={dcfg.hidden_size} heads="
        f"{dcfg.num_attention_heads} inter={dcfg.intermediate_size} "
        f"({n_params / 1e6:.1f}M trainable params)")
    r = args.rollouts
    batches = torch.Generator().manual_seed(BATCH_SEED)
    hist, secs = trainer.run(tok[:r], hiddens[:r], args.steps, args.batch,
                             generator=batches, log=log,
                             log_every=args.log_every)

    mark("select")
    alpha, ho_agree, table = trainer.select_alpha(tok[r:], hiddens[r:],
                                                  ALPHAS, log=log)

    mark("eval")
    eng = served(trainer.draft(dt))
    ev = spec_eval(eng, prompts_of(range(1000, 1000 + args.eval_prompts),
                                   mc.vocab_size), args.gen_tokens, log=log)
    log(f"MEAN accept/round = {ev['accept_per_round']:.3f} (lossless "
        f"{ev['lossless']}/{ev['n_eval']}, match_frac "
        f"{ev['ar_match_frac']:.3f})")
    mark("done")
    stats = {"scale": args.scale, "width": width, "steps": args.steps,
             "rollouts": args.rollouts, "quant_eval": quant, "base": law,
             "accept_per_round": ev["accept_per_round"],
             "lossless": ev["lossless"] == ev["n_eval"],
             "ar_match_frac": round(ev["ar_match_frac"], 4),
             "holdout_top1_agree": round(ho_agree, 4), "w_out_alpha": alpha,
             "alpha_table": table, "device": str(dev),
             "protocol": "flowspec_tpu_torch/train/bench_draft.py (the "
                         "port's base; held-out eval prompts)"}
    if args.out:
        save_thin_draft(trainer.trainable, args.out, stats)
        log(f"saved {args.out}")
    return {"stats": stats, "trainer": trainer, "eval": ev, "engine": eng,
            "losses": hist, "step_s": secs, "params": params}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default="7b", choices=sorted(QUANT))
    ap.add_argument("--base", default=None,
                    help="a save_params checkpoint directory (default: the "
                         "seeded random draw of the scale)")
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--rollouts", type=int, default=160)
    ap.add_argument("--holdout", type=int, default=4)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen-tokens", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hidden-w", type=float, default=0.5)
    ap.add_argument("--ce-w", type=float, default=1.0)
    ap.add_argument("--eval-prompts", type=int, default=6)
    ap.add_argument("--log-every", type=int, default=200)
    ap.add_argument("--corpus-cache", default=None)
    ap.add_argument("--out", default=None,
                    help="the trained draft's .npz (its stats beside it)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
