"""The trainers' losses (`tools/train_bench_draft.py:206-225`,
`train_struct_base.py:124-149, 366-380`, `train_tiny_draft.py:184-197`)."""

from __future__ import annotations

import torch

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.models.llama import LlamaParams
from flowspec_tpu_torch.train.forward import head_product, lm_forward


def huber(d: torch.Tensor) -> torch.Tensor:
    """Mean Huber loss of the residual `d`, delta 1 (EAGLE's smooth-l1)."""
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).mean()


def distill_loss(out: torch.Tensor, hid: torch.Tensor, head: torch.Tensor,
                 hidden_w: float, ce_w: float, soft: bool = False):
    """The draft's loss on teacher-forced pairs: `out` (B, T-1, H) f32 the
    draft's predictions of hid[:, 1:], `hid` (B, T, H) the teacher's
    hiddens in the working dtype, `head` the shared lm_head's values (H,
    V). hidden_w * Huber(out - target) + ce_w * CE, the logits the head
    product of operands rounded to the teacher's dtype; CE against the
    teacher's argmax (the bench and struct trainers) or, `soft`, against its
    softmax (the tiny one). Returns (loss, (huber, ce, agree)), agree the
    share of positions whose argmax matches the teacher's."""
    tgt = hid[:, 1:].float()
    hub = huber(out - tgt)
    ld = head_product(out, head, hid.dtype)
    with torch.no_grad():
        lt = head_product(hid[:, 1:], head, hid.dtype)
        lab = lt.argmax(-1)
    lsm = torch.log_softmax(ld, dim=-1)
    if soft:
        ce = -(torch.softmax(lt, dim=-1) * lsm).sum(-1).mean()
    else:
        ce = -lsm.gather(-1, lab[..., None]).mean()
    agree = (ld.argmax(-1) == lab).float().mean()
    return hidden_w * hub + ce_w * ce, (hub, ce, agree)


def lm_loss(params: LlamaParams, tokens: torch.Tensor, mc: ModelConfig,
            remat: bool = True):
    """Next-token CE of the base on (B, T) tokens, bf16 compute, and its
    top-1 accuracy: (ce, acc)."""
    logits = lm_forward(params, tokens, mc, remat)
    labels = tokens[:, 1:].long()
    lsm = torch.log_softmax(logits, dim=-1)
    ce = -lsm.gather(-1, labels[..., None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return ce, acc
