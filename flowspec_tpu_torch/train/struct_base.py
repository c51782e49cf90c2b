"""Train a base on the structured corpus, then its draft, on the card.

    python -m flowspec_tpu_torch.train.struct_base --scale mid --out r.json

The counterpart of `tools/train_struct_base.py`: a LLaMA-architecture base
trained from scratch on `eval/synth.py`'s corpus (seed 0; class table,
induction copy, Zipf noise) with f32 masters and bf16 compute through the
port's own decoder stack (`forward.lm_forward`), checked against the Bayes
oracle's top-1 on held-out sequences; then an EAGLE draft distilled on a
stream of fresh pools (seeds 30000 + i, one pass each, so nothing is seen
twice), the delta shrink chosen on a held-out pool; then greedy and T = 1
speculation against AR in the engine on held-out prompts (seed 2). The
engine runs in f32 on the CPU, as the JAX tool's does, and in bf16 on the
card, where the attention kernel takes bf16 only (`eval_dtype` in the
report).

The scales, the draft's fields and the saved files' layout are
`eval/struct_base.py`'s. `--base-init` resumes base training from a
`save_base` snapshot (the step count beside it in `<file>.step.npy`, the
AdamW moments cold and the schedule offset, `:211-225`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from flowspec_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingConfig, TreeConfig,
)
from flowspec_tpu_torch.draft.eagle import draft_view, init_eagle_params
from flowspec_tpu_torch.eval.struct_base import (
    SCALES, load_base, load_draft, model_config, save_base, save_draft,
)
from flowspec_tpu_torch.eval.synth import (
    gen_struct_corpus, oracle_next_token_dist,
)
from flowspec_tpu_torch.models.llama import LlamaParams, init_llama_params
from flowspec_tpu_torch.runtime.engine import SpecEngine, resolve_device
from flowspec_tpu_torch.train import teacher
from flowspec_tpu_torch.train.distill import (
    DraftTrainer, spec_eval, trainable_of,
)
from flowspec_tpu_torch.train.forward import LAYER_FIELDS, cast_floats
from flowspec_tpu_torch.train.losses import lm_loss
from flowspec_tpu_torch.train.optim import AdamW

BASE_SEED, BASE_BATCH_SEED, DRAFT_SEED = 3, 4242, 9
ALPHAS = (0.0, 0.1, 0.25, 0.5, 0.75, 1.0)
HOLDOUT_POOL_SEED = 999_983
SNAPSHOT_EVERY = 2000           # base steps between snapshots (`:519`)


def leaves_of(params: LlamaParams) -> list:
    """Every tensor of the base (None fields skipped)."""
    out = [params.embed, params.final_norm, params.lm_head]
    return out + [t for f in LAYER_FIELDS
                  if (t := getattr(params.layers, f)) is not None]


def f32_masters(params: LlamaParams) -> LlamaParams:
    """f32 copies of every leaf that require grad."""
    def m(t):
        return None if t is None else t.detach().float().clone() \
            .requires_grad_()
    return dataclasses.replace(
        params, embed=m(params.embed), final_norm=m(params.final_norm),
        lm_head=m(params.lm_head), layers=dataclasses.replace(
            params.layers, **{f: m(getattr(params.layers, f))
                              for f in LAYER_FIELDS}))


def train_base(mc: ModelConfig, corpus_train: np.ndarray, s: dict,
               steps: int, device, *, init_from=None, save_every=None,
               save_path=None, batches=None, log=print):
    """Next-token CE on the corpus (`tools/train_struct_base.py:192-267`):
    f32 masters from the seeded `init_llama_params` draw (or the
    `init_from` snapshot, from the step beside it), bf16 compute, AdamW
    (b2 0.95, weight decay 0.01) over a cosine decay of `s["lr"]` to 5 %;
    batches of `s["batch"]` drawn by a generator seeded 4242, or the next
    of `batches` (index arrays, one a step taken). Snapshots
    every `save_every` steps to `save_path`, the step beside it.
    Returns (bf16 params, the f32 masters, per-step (ce, acc))."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(BASE_SEED)
    step0 = 0
    if init_from:
        params = f32_masters(load_base(init_from, mc, device=dev))
        meta = init_from + ".step.npy"
        step0 = int(np.load(meta)) if os.path.exists(meta) else 0
        log(f"base resumed from {init_from} at step {step0} (opt cold)")
    else:
        params = f32_masters(init_llama_params(gen, mc, torch.float32, dev))
    opt = AdamW(leaves_of(params), s["lr"], steps, 0.05, b2=0.95,
                weight_decay=0.01, step0=step0)
    corpus = torch.as_tensor(corpus_train, device=dev)
    draw = torch.Generator().manual_seed(BASE_BATCH_SEED)
    batches = iter(batches) if batches is not None else None
    hist = []
    t0 = time.perf_counter()
    for it in range(step0, steps):
        idx = (torch.as_tensor(np.asarray(next(batches)))
               if batches is not None else
               torch.randint(0, corpus.shape[0], (s["batch"],),
                             generator=draw))
        ce, acc = lm_loss(params, corpus[idx.to(dev)], mc)
        opt.zero_grad()
        ce.backward()
        opt.step()
        hist.append((ce.detach(), acc.detach()))
        done = it + 1
        if done % 100 == 0 or done == steps:
            log(f"base step {done:5d}/{steps} ce {float(hist[-1][0]):.4f} "
                f"top1 {float(acc):.3f} ({time.perf_counter() - t0:.0f}s)")
        if save_every and save_path and done % save_every == 0 \
                and done < steps:
            save_base(params, save_path)
            np.save(save_path + ".step.npy", np.int64(done))
            log(f"checkpoint: {save_path} @ step {done}")
    hist = [(float(c), float(a)) for c, a in hist]
    with torch.no_grad():                 # a served base needs no graph
        return cast_floats(params, torch.bfloat16), params, hist


@torch.no_grad()
def eval_lm(params: LlamaParams, tokens, mc: ModelConfig):
    """(ce, top-1) of the base over (N, T) tokens, 16 sequences a forward,
    averaged over the positions."""
    chunk = 16
    dev = params.embed.device
    tok = torch.as_tensor(tokens).to(dev)
    ces, accs = [], []
    for i in range(0, tok.shape[0], chunk):
        ce, acc = lm_loss(params, tok[i:i + chunk], mc, remat=False)
        n = tok[i:i + chunk].shape[0]
        ces.append(float(ce) * n)
        accs.append(float(acc) * n)
    return sum(ces) / tok.shape[0], sum(accs) / tok.shape[0]


def oracle_top1(corpus_holdout: np.ndarray, s: dict,
                n_positions: int = 512) -> float:
    """Bayes-optimal top-1 on held-out positions (`:270-285`)."""
    rng = np.random.default_rng(7)
    hit = 0
    for _ in range(n_positions):
        r = rng.integers(0, corpus_holdout.shape[0])
        t = rng.integers(s["copy_dist"] + 1, s["seq_len"])
        p = oracle_next_token_dist(corpus_holdout[r], t, s["vocab"],
                                   n_classes=s["n_classes"],
                                   copy_dist=s["copy_dist"], table_seed=0)
        hit += int(np.argmax(p) == corpus_holdout[r, t])
    return hit / n_positions


def distill_draft(params: LlamaParams, mc: ModelConfig, s: dict, *,
                  log=print, mark=lambda phase: None):
    """Streaming distillation (`:288-483`): `s["distill_outer"]` pools of
    `s["distill_pool"]` fresh sequences (seeds 30000 + i), the teacher's
    hiddens of each (`fb` = min(32, pool) lanes a prefill), one pass of
    sequential batches over each; AdamW over a cosine decay of 1e-3 to 2 %
    across every step; the delta shrink on the held-out pool (seed
    999983). `mark` as in `bench_draft.run`, with "teacher" and "train"
    once a pool. Returns (bf16 draft, stats, per-step losses)."""
    pool, n_outer = s["distill_pool"], s["distill_outer"]
    batch = s["distill_batch"]
    seq_len = s["prompt_len"] + s["gen_tokens"]
    fb = min(32, pool)
    dev = params.embed.device

    def pool_of(seed):
        toks = gen_struct_corpus(pool, seq_len, vocab=s["vocab"], seed=seed,
                                 n_classes=s["n_classes"],
                                 copy_dist=s["copy_dist"])
        return (torch.as_tensor(toks, device=dev),
                teacher.teacher_hiddens(params, toks, mc, lanes=fb))

    gen = torch.Generator(device=dev)
    gen.manual_seed(DRAFT_SEED)
    draft0 = init_eagle_params(gen, mc, embed=params.embed,
                               dtype=torch.float32, width=s["draft_width"])
    steps_per = pool // batch
    trainer = DraftTrainer(
        trainable_of(draft0), params.embed, params.lm_head.float(),
        draft_view(draft0, mc), lr=1e-3, decay_steps=n_outer * steps_per,
        alpha=0.02, hidden_w=0.5, ce_w=1.0)
    hist, t0 = [], time.perf_counter()
    for outer in range(n_outer):
        mark("teacher")
        toks, hid = pool_of(30_000 + outer)
        mark("train")
        h, _ = trainer.run(toks, hid, steps_per, batch, batches=(
            range(i * batch, (i + 1) * batch) for i in range(steps_per)))
        hist += h
        if (outer + 1) % max(1, n_outer // 15) == 0:
            log(f"distill pool {outer + 1:4d}/{n_outer} "
                f"({(outer + 1) * steps_per} steps, all data fresh) loss "
                f"{h[-1][0]:.4f} top1-agree {h[-1][3]:.3f} "
                f"({time.perf_counter() - t0:.0f}s)")
    mark("teacher")
    ho_toks, ho_hid = pool_of(HOLDOUT_POOL_SEED)
    mark("select")
    alpha, ho_agree, _ = trainer.select_alpha(ho_toks[:fb], ho_hid[:fb],
                                              ALPHAS, log=log)
    return trainer.draft(torch.bfloat16), {
        "holdout_top1_agree": round(ho_agree, 4), "w_out_alpha": alpha,
        "width": s["draft_width"], "distill_fresh_seqs": n_outer * pool}, \
        hist


def tree_config(depth: int = 6, total: int = 48,
                stemp: float = 1.0) -> TreeConfig:
    """The JAX tool's evaluation tree (`:539-547`)."""
    return TreeConfig(top_k=8, depth=depth, total_tokens=total,
                      expand_tokens=24, expand_depth=2,
                      node_cap=max(64, total + 16),
                      leaf_cap=max(64, total + 16),
                      depth_cap=max(10, depth + 2),
                      score_temperature=stemp)


def run(scale: str, device=None, overrides=None, log=print,
        mark=lambda phase: None, base_load=None, draft_load=None,
        base_init=None, base_batches=None, draft_save=None, snapshot=None,
        n_eval: int = 6, eval_tokens=None, tree=None):
    """The whole protocol at `scale` (SCALES, with `overrides` of its
    keys): base (trained, on `base_batches` if given, as `train_base`'s
    `batches`; or `base_load`), held-out CE / top-1 against the
    oracle, the draft (distilled, or `draft_load`), then `n_eval` prompts
    of `eval_tokens` new tokens (gen_tokens by default) through the engine
    greedy (AR, then spec, fused) and at T = 1. `mark` as in
    `bench_draft.run` ("base", the draft's phases, "eval", "done").
    Returns (bf16 params, bf16 draft, report, per-step base (ce, acc))."""
    dev = resolve_device(device)
    s = {**SCALES[scale], **(overrides or {})}
    mc = model_config(s)
    log(f"[{scale}] corpus {s['n_seqs']}x{s['seq_len']} vocab {s['vocab']}")
    corpus = gen_struct_corpus(s["n_seqs"] + s["holdout"], s["seq_len"],
                               vocab=s["vocab"], seed=0,
                               n_classes=s["n_classes"],
                               copy_dist=s["copy_dist"])
    train, hold = corpus[:s["n_seqs"]], corpus[s["n_seqs"]:]
    base_hist = []
    if base_load:
        params = load_base(base_load, mc, device=dev)
        log(f"loaded base from {base_load}")
    else:
        mark("base")
        params, _, base_hist = train_base(
            mc, train, s, s["steps"], dev, init_from=base_init,
            save_every=SNAPSHOT_EVERY, save_path=snapshot,
            batches=base_batches, log=log)
    ce_h, acc_h = eval_lm(params, hold, mc)
    bayes = oracle_top1(hold, s)
    log(f"held-out: top1 {acc_h:.3f} (Bayes oracle {bayes:.3f}, ratio "
        f"{acc_h / max(bayes, 1e-9):.2f}) ce {ce_h:.3f}")

    if draft_load:
        draft = load_draft(draft_load, params.embed, torch.bfloat16)
        dstats = {"draft": f"loaded from {draft_load}"}
    else:
        draft, dstats, _ = distill_draft(params, mc, s, log=log, mark=mark)
        if draft_save:
            save_draft(draft, draft_save)
            log(f"draft saved: {draft_save}")

    mark("eval")
    prompt_len = s["prompt_len"]
    new = eval_tokens or s["gen_tokens"]
    tc = tree or tree_config()
    eval_dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    emc = dataclasses.replace(mc, dtype=str(eval_dtype).replace("torch.",
                                                                ""))
    cfg = EngineConfig(model=emc, tree=tc, sampling=SamplingConfig(),
                       max_new_tokens=s["gen_tokens"],
                       max_seq_len=prompt_len + s["gen_tokens"] + 24,
                       prefill_chunk=32)
    pe, de = cast_floats(params, eval_dtype), cast_floats(draft, eval_dtype)
    eng = SpecEngine(pe, de, cfg, device=dev)
    eng_t1 = SpecEngine(pe, de, dataclasses.replace(
        cfg, sampling=SamplingConfig(temperature=1.0)), device=dev)
    prompts = gen_struct_corpus(
        n_eval, max(prompt_len + 1, s["copy_dist"] + 2), vocab=s["vocab"],
        seed=2, n_classes=s["n_classes"],
        copy_dist=s["copy_dist"])[:, :prompt_len]
    ev = spec_eval(eng, prompts, new, log=log, fused=True, t1_eng=eng_t1)
    mark("done")

    def rounded(v, nd):
        return None if v is None else round(v, nd)
    res = {"scale": scale, "params_m": round(sum(
        t.numel() for t in leaves_of(params)) / 1e6, 1),
        "base_holdout_top1": round(acc_h, 4),
        "bayes_oracle_top1": round(bayes, 4),
        "base_holdout_ce": round(ce_h, 4),
        "tree": f"d{tc.depth}/tau{tc.score_temperature:g}/"
                f"n{tc.total_tokens}", **dstats,
        "accept_per_round_greedy": round(ev["accept_per_round"], 3),
        "accept_per_round_t1": round(ev["accept_per_round_t1"], 3),
        "greedy_lossless": f"{ev['lossless']}/{ev['n_eval']}",
        "ar_match_frac": round(ev["ar_match_frac"], 4),
        "spec_tok_s": rounded(ev["spec_tok_s"], 2),
        "ar_tok_s": rounded(ev["ar_tok_s"], 2),
        "eval_dtype": str(eval_dtype).replace("torch.", ""),
        "eval_tokens": new, "device": str(dev),
        "protocol": "flowspec_tpu_torch/train/struct_base.py: structured "
                    "corpus (synth seed 0) -> base trained from scratch -> "
                    "streaming teacher-forced distillation (fresh seeds "
                    "30000+, one pass each) -> eval prompts seed 2"}
    return params, draft, res, {"base": base_hist, "eval_engine": eng,
                                "spec": ev["spec"], "ar": ev["ar"]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default="mid", choices=sorted(SCALES))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--distill-outer", type=int, default=None)
    ap.add_argument("--seqs", type=int, default=None)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--total", type=int, default=48)
    ap.add_argument("--stemp", type=float, default=1.0)
    ap.add_argument("--base-load", default=None)
    ap.add_argument("--base-init", default=None,
                    help="resume base training from this snapshot")
    ap.add_argument("--snapshot", default=None,
                    help=f"snapshot the base here every {SNAPSHOT_EVERY} "
                         "steps")
    ap.add_argument("--draft-load", default=None)
    ap.add_argument("--draft-save", default=None)
    ap.add_argument("--base-out", default=None,
                    help="the trained base, in save_base's layout")
    ap.add_argument("--out", default=None, help="the JSON report")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    overrides = {k: v for k, v in (("steps", args.steps),
                                   ("distill_outer", args.distill_outer),
                                   ("n_seqs", args.seqs)) if v is not None}
    params, _, res, _ = run(
        args.scale, args.device, overrides, base_load=args.base_load,
        draft_load=args.draft_load, base_init=args.base_init,
        snapshot=args.snapshot,
        draft_save=args.draft_save,
        tree=tree_config(args.depth, args.total, args.stemp))
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if args.base_out:
        save_base(params, args.base_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
