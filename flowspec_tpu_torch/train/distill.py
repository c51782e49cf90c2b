"""Distilling an EAGLE draft: the training loop, the delta-shrink selection,
the saved draft and the evaluation in the engine.

The loop is the JAX trainers' `one_step` (`tools/train_bench_draft.py:
232-239`, `train_struct_base.py:408-414`, `train_tiny_draft.py:206-211`):
the pairs' loss (`losses.distill_loss`) through `forward.
draft_pairs_forward`, its gradient by autograd, one `optim.AdamW` update
of every trainable field. A step's batch is drawn from an explicit
`torch.Generator`, or is the next index array the caller gives.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.draft.eagle import EagleParams
from flowspec_tpu_torch.eval.struct_base import DRAFT_FIELDS
from flowspec_tpu_torch.train.forward import draft_pairs_forward
from flowspec_tpu_torch.train.losses import distill_loss
from flowspec_tpu_torch.train.optim import AdamW


def trainable_of(draft: EagleParams) -> dict:
    """The draft's fields but the frozen embedding, as f32 leaves that
    require grad (a full-width draft has no w_out)."""
    return {f: getattr(draft, f).detach().float().clone().requires_grad_()
            for f in DRAFT_FIELDS if getattr(draft, f) is not None}


class DraftTrainer:
    """One trainable draft, its optimizer and the loss's constants: the
    frozen embedding, the shared head's values (an f32 copy of the base's
    head, made once) and the draft geometry. Weight decay 1e-4, as in
    every JAX draft trainer."""

    def __init__(self, trainable: dict, embed: torch.Tensor,
                 head: torch.Tensor, dcfg: ModelConfig, *, lr: float,
                 decay_steps: int, alpha: float, hidden_w: float,
                 ce_w: float, soft: bool = False):
        self.trainable = trainable
        self.embed, self.head, self.dcfg = embed, head, dcfg
        self.hidden_w, self.ce_w, self.soft = hidden_w, ce_w, soft
        self.opt = AdamW(trainable.values(), lr, decay_steps, alpha,
                         weight_decay=1e-4)
        self.steps = 0
        self.first_grad_norms = None   # every field's |grad| at step 1

    def loss(self, tokens, hiddens, trainable=None):
        out = draft_pairs_forward(trainable or self.trainable, self.embed,
                                  tokens, hiddens, self.dcfg)
        return distill_loss(out, hiddens, self.head, self.hidden_w,
                            self.ce_w, self.soft)

    def step(self, tokens, hiddens):
        """One update on a batch; (loss, huber, ce, agree) detached."""
        loss, aux = self.loss(tokens, hiddens)
        self.opt.zero_grad()
        loss.backward()
        if self.first_grad_norms is None:
            self.first_grad_norms = {
                f: float(t.grad.norm()) if t.grad is not None else None
                for f, t in self.trainable.items()}
        self.opt.step()
        self.steps += 1
        return tuple(v.detach() for v in (loss, *aux))

    def run(self, tokens, hiddens, steps: int, batch: int, *,
            generator: torch.Generator | None = None, batches=None,
            log=print, log_every: int = 0):
        """`steps` updates on batches of `batch` sequences of (N, T) tokens
        and (N, T, H) hiddens: drawn uniformly by `generator`, or the next
        of `batches` (index arrays). Returns the (loss, huber, ce, agree)
        of every step as floats and the seconds of each."""
        n = tokens.shape[0]
        batches = iter(batches) if batches is not None else None
        hist, secs = [], []
        for i in range(steps):
            idx = (torch.as_tensor(np.asarray(next(batches)))
                   if batches is not None else
                   torch.randint(0, n, (batch,), generator=generator))
            idx = idx.to(tokens.device)
            t0 = time.perf_counter()
            vals = self.step(tokens[idx], hiddens[idx])
            hist.append(vals)
            if tokens.is_cuda:
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if log_every and ((i + 1) % log_every == 0 or i + 1 == steps):
                l, hub, ce, ag = (float(v) for v in vals)
                log(f"step {self.steps:5d} loss {l:.4f} huber {hub:.4f} "
                    f"ce {ce:.4f} top1-agree {ag:.3f}")
        return [[float(v) for v in h] for h in hist], secs

    @torch.no_grad()
    def agree(self, tokens, hiddens, w_out_scale: float = 1.0):
        """(huber, ce, agree) on held-out pairs, w_out scaled by
        `w_out_scale` (thin drafts)."""
        tr = dict(self.trainable)
        if "w_out" in tr:
            tr["w_out"] = tr["w_out"] * w_out_scale
        _, aux = self.loss(tokens, hiddens, tr)
        return tuple(float(v) for v in aux)

    def select_alpha(self, tokens, hiddens, grid, log=print):
        """The delta shrink (`tools/train_bench_draft.py:271-294`,
        `train_struct_base.py:453-476`): the trained delta is linear in
        w_out, so w_out x alpha interpolates between the learned map (1)
        and the identity (0); the alpha of the grid with the highest
        held-out top-1 agreement (the first on a tie) scales w_out in
        place. A full-width draft has no w_out and keeps alpha 1. Returns
        (alpha, held-out agree, {alpha: agree})."""
        if "w_out" not in self.trainable:
            ag = self.agree(tokens, hiddens)[2]
            log(f"full-width draft: held-out top1-agree {ag:.3f}")
            return 1.0, ag, {1.0: ag}
        table, best_a, best_ag = {}, 0.0, -1.0
        for a in grid:
            ag = self.agree(tokens, hiddens, a)[2]
            table[a] = ag
            log(f"alpha {a:4.2f}: held-out top1-agree {ag:.3f}")
            if ag > best_ag:
                best_a, best_ag = a, ag
        log(f"selected alpha={best_a} (held-out agree {best_ag:.3f})")
        with torch.no_grad():
            self.trainable["w_out"].mul_(best_a)
        return best_a, best_ag, table

    def draft(self, dtype) -> EagleParams:
        """The trained draft in `dtype` with the frozen embedding."""
        return EagleParams(embed=self.embed, **{
            f: t.detach().to(dtype) for f, t in self.trainable.items()})


def save_thin_draft(trainable: dict, path: str, stats: dict) -> None:
    """The trained fields as fp16 npz, the format `draft/eagle.py
    load_thin_draft` and the JAX package's read, and `stats` as the JSON
    beside it (`tools/train_bench_draft.py:332-348`)."""
    np.savez_compressed(path, **{
        f: t.detach().float().cpu().numpy().astype(np.float16)
        for f, t in trainable.items()})
    with open(str(path).replace(".npz", ".json"), "w") as f:
        json.dump(stats, f, indent=1)


def spec_eval(eng, prompts, new_tokens: int, log=print, fused: bool = False,
              t1_eng=None) -> dict:
    """The trained draft in the engine on held-out prompts, as the JAX
    tools evaluate it: the AR stream (`generate_ar_fused`) against the
    speculative one (`generate`, or `generate_fused` when `fused`), EOS
    off; accept a round, lossless count and the share of each stream that
    matches AR before the first divergence; with `t1_eng` (the same pair
    sampling at T = 1), its accept a round too. Tok/s of both streams from
    the second prompt on (the first pays the captures). The streams are
    returned too."""
    accs, accs_t1, match, outs, ars, tps_spec, tps_ar = ([] for _ in
                                                         range(7))
    gen = eng.generate_fused if fused else eng.generate
    for i, prompt in enumerate(prompts):
        t0 = time.perf_counter()
        ar, _ = eng.generate_ar_fused(prompt, max_new_tokens=new_tokens,
                                      eos_token_id=-1)
        t1 = time.perf_counter()
        out, st = gen(prompt, max_new_tokens=new_tokens, eos_token_id=-1)
        t2 = time.perf_counter()
        n = min(len(out), len(ar))
        div = next((j for j in range(n) if out[j] != ar[j]), n)
        accs.append(st["accept_per_round"])
        match.append(div / max(n, 1))
        outs.append(out)
        ars.append(ar)
        if i > 0:
            tps_ar.append((len(ar) - len(prompt)) / (t1 - t0))
            tps_spec.append(st["new_tokens"] / (t2 - t1))
        line = (f"eval {i}: accept/round {st['accept_per_round']:.2f} "
                f"lossless={div == n} match_frac={div / max(n, 1):.3f}")
        if t1_eng is not None:
            _, st1 = t1_eng.generate_fused(prompt, max_new_tokens=new_tokens,
                                           eos_token_id=-1)
            accs_t1.append(st1["accept_per_round"])
            line += f" T1-accept {st1['accept_per_round']:.2f}"
        log(line)

    def mean(v):
        return float(np.mean(v)) if v else None
    return {"accept_per_round": mean(accs), "accepts": accs,
            "accept_per_round_t1": mean(accs_t1),
            "lossless": sum(m == 1.0 for m in match),
            "n_eval": len(prompts), "ar_match_frac": mean(match),
            "spec_tok_s": mean(tps_spec), "ar_tok_s": mean(tps_ar),
            "spec": outs, "ar": ars}
