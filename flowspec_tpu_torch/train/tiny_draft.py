"""Distil the tiny EAGLE draft of the trained-draft fixtures.

    python -m flowspec_tpu_torch.train.tiny_draft --device cpu --out d.npz

The counterpart of `tools/train_tiny_draft.py` (`tests/fixtures/
tiny_draft_trained.npz`, and with `--layers 8` `tiny_draft_trained_l8.npz`):
a full-width draft on a tiny f32 base (vocab 64, `--layers` layers),
trained on the base's greedy rollouts of random 8-token prompts (through
`SpecEngine.generate_ar_fused`) and on random sequences, with Huber on the
next hidden plus a soft CE against the base's next-token distribution
through the shared head; then served against the base on held-out prompts,
where every stream must equal AR. The base is the port's seeded
`init_llama_params` draw, or `--base`, a file in `eval/struct_base.py
save_base`'s layout (`tests/fixtures/tiny_l8_base.npz` holds the JAX
tool's 8-layer base). `--out` gets the fixture's keys: the ten trained
fields (f32) and `accept_per_round`.

The tiny model (f32, head dim 16) is outside the attention kernel, which
takes bf16 at head dim 64 or 128: as the JAX tool runs on the CPU, so does
this one (`--device cpu`); on the card it refuses before it starts.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from flowspec_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingConfig, TreeConfig,
)
from flowspec_tpu_torch.draft.eagle import init_eagle_params
from flowspec_tpu_torch.eval.struct_base import load_base
from flowspec_tpu_torch.models.llama import init_llama_params
from flowspec_tpu_torch.runtime.engine import SpecEngine, resolve_device
from flowspec_tpu_torch.train import teacher
from flowspec_tpu_torch.train.distill import (
    DraftTrainer, spec_eval, trainable_of,
)

VOCAB, SEQ, PROMPT = 64, 64, 8
HIDDEN_W, CE_W = 1.0, 0.3
BASE_SEED, DRAFT_SEED, DATA_SEED = 0, 9, 42
# the engine of the fixture tests (tests/test_trained_draft.py)
TREE = TreeConfig(top_k=6, depth=5, total_tokens=24, expand_tokens=12,
                  expand_depth=2, node_cap=48, leaf_cap=48, depth_cap=10,
                  chunk_len=8)


def tiny_cfg(layers: int) -> ModelConfig:
    return dataclasses.replace(ModelConfig.tiny(vocab_size=VOCAB,
                                                n_layers=layers),
                               dtype="float32")


def run(args, log=print) -> dict:
    """Returns the trained draft's fields, the accept a round of the
    trained and the untrained draft, and the evaluation."""
    dev = resolve_device(args.device)
    mc = tiny_cfg(args.layers)
    if dev.type == "cuda":
        raise ValueError("the tiny model (f32, head dim 16) is outside the "
                         "attention kernel (bf16, head dim 64 or 128): run "
                         "with --device cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(BASE_SEED)
    base = (load_base(args.base, mc, device=dev) if args.base
            else init_llama_params(gen, mc, device=dev))
    gen.manual_seed(DRAFT_SEED)
    draft0 = init_eagle_params(gen, mc, embed=base.embed)
    cfg = EngineConfig(model=mc, tree=TREE, sampling=SamplingConfig(),
                       max_seq_len=256, prefill_chunk=16)
    data = torch.Generator().manual_seed(DATA_SEED)
    prompts = torch.randint(0, VOCAB, (args.rollouts, PROMPT),
                            generator=data).numpy()
    eng0 = SpecEngine(base, draft0, cfg, device=dev)
    rolls = teacher.greedy_rollouts(eng0, prompts, SEQ - PROMPT)
    rand = torch.randint(0, VOCAB, (args.random, SEQ), generator=data)
    tokens = np.concatenate([rolls, rand.numpy().astype(np.int32)])
    hiddens = teacher.teacher_hiddens(base, tokens, mc)
    log(f"corpus: {tokens.shape} tokens, hiddens {tuple(hiddens.shape)}")

    trainer = DraftTrainer(trainable_of(draft0), base.embed, base.lm_head,
                           mc, lr=3e-3, decay_steps=args.steps, alpha=0.05,
                           hidden_w=HIDDEN_W, ce_w=CE_W, soft=True)
    tok = torch.as_tensor(tokens, device=dev)
    trainer.run(tok, hiddens, args.steps, args.batch, generator=data,
                log=log, log_every=args.log_every)

    rng = np.random.default_rng(123)
    eval_prompts = [rng.integers(0, VOCAB, PROMPT).tolist()
                    for _ in range(args.eval_prompts)]
    eng = SpecEngine(base, trainer.draft(torch.float32), cfg, device=dev)
    ev = spec_eval(eng, eval_prompts, 48, log=log)
    if ev["lossless"] != ev["n_eval"]:
        raise AssertionError(f"the trained draft left AR: {ev['ar_match_frac']}")
    untrained = spec_eval(eng0, eval_prompts, 48, log=lambda s: None)
    log(f"accept/round trained: {ev['accept_per_round']:.3f} (untrained: "
        f"{untrained['accept_per_round']:.3f}), lossless on "
        f"{ev['n_eval']}/{ev['n_eval']} prompts")
    fields = {f: t.detach().cpu().numpy()
              for f, t in trainer.trainable.items()}
    if args.out:
        np.savez_compressed(args.out, accept_per_round=ev["accept_per_round"],
                            **fields)
        log(f"saved {args.out}")
    return {"fields": fields, "accept_per_round": ev["accept_per_round"],
            "accept_untrained": untrained["accept_per_round"], "eval": ev}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--base", default=None,
                    help="a base in save_base's layout (default: the seeded "
                         "init_llama_params draw)")
    ap.add_argument("--rollouts", type=int, default=192)
    ap.add_argument("--random", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval-prompts", type=int, default=8)
    ap.add_argument("--log-every", type=int, default=300)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
