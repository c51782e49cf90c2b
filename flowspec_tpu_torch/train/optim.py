"""AdamW over optax's cosine decay: the JAX trainers' optimizer.

The counterpart of `optax.adamw(optax.cosine_decay_schedule(init,
decay_steps, alpha), b1=0.9, b2, weight_decay=wd)` (eps 1e-8, eps_root 0, one
group, decay on every parameter: the JAX trainers pass no mask). optax's
update is lr_n * (m̂ / (sqrt(v̂) + eps) + wd * p) with the schedule read at
the update's count n before it is incremented; `torch.optim.AdamW` takes
the same step (its decay multiplies p by 1 - lr * wd first, which is the
same term of the old p), and a `LambdaLR` gives lr_n. `step0` offsets the
count, as `tools/train_struct_base.py:223-225` does on a resume (the
moments start cold).
"""

from __future__ import annotations

import math

import torch


def cosine_decay(init: float, decay_steps: int, alpha: float = 0.0,
                 step0: int = 0):
    """optax.cosine_decay_schedule as a function of the update count n:
    init * ((1 - alpha) * (1 + cos(pi * min(n + step0, N) / N)) / 2 +
    alpha)."""
    def lr(n: int) -> float:
        c = min(n + step0, decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cos + alpha)
    return lr


class AdamW:
    """`optax.adamw(cosine_decay_schedule(...))` over `params` (tensors
    that require grad): `step()` applies one update from their `.grad` and
    advances the schedule. A parameter whose `.grad` is None is skipped,
    as torch does; the trainers check that every field has one."""

    def __init__(self, params, init_lr: float, decay_steps: int,
                 alpha: float = 0.0, b2: float = 0.999,
                 weight_decay: float = 1e-4, step0: int = 0):
        self.params = list(params)
        self.schedule = cosine_decay(init_lr, decay_steps, alpha, step0)
        self.opt = torch.optim.AdamW(self.params, lr=init_lr, betas=(0.9, b2),
                                     eps=1e-8, weight_decay=weight_decay,
                                     foreach=False)
        self.lr = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda n: self.schedule(n) / init_lr)

    def step(self) -> None:
        self.opt.step()
        self.lr.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)
