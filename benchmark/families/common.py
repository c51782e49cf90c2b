"""Weight draws shared by the families: everything on the device from one
`torch.Generator` seeded by the run's seed, one call a stacked leaf, in the
type the weights are served in.

Laws (those of the port's random bases, `chip_smoke.py make_engine`, with
the scales and norms drawn too, so that a kernel that ignored a column's
scale or a norm's weight would show): int8 codes uniform in [-127, 127]
with f32 column scales In^-1/2 / 127 x U(0.5, 1.5); bf16 matrices N(0,
In^-1/2); embedding N(0, 0.02); norms N(1, 0.1); biases N(0, 0.1).
"""

from __future__ import annotations

import torch

NORM_STD = 0.1
BIAS_STD = 0.1
EMBED_STD = 0.02


class Draw:
    """Draws on `device` from `gen`, in the order of the calls; floating
    weights in `dtype` (the configuration's `torch_dtype`)."""

    def __init__(self, gen: torch.Generator, device, dtype=torch.bfloat16):
        self.gen, self.device, self.dtype = gen, device, dtype

    def int8(self, *shape) -> dict:
        """Codes (..., In, Out) and scales (..., Out) of an int8 weight."""
        q = torch.empty(shape, dtype=torch.int8, device=self.device)
        q.random_(-127, 128, generator=self.gen)
        scale = torch.empty((*shape[:-2], shape[-1]), dtype=torch.float32,
                            device=self.device)
        scale.uniform_(0.5, 1.5, generator=self.gen)
        return {"q": q, "scale": scale.mul_(shape[-2] ** -0.5 / 127.0)}

    def normal(self, *shape, std: float, mean: float = 0.0) -> torch.Tensor:
        w = torch.empty(shape, dtype=self.dtype, device=self.device)
        return w.normal_(mean, std, generator=self.gen)

    def matrix(self, *shape) -> torch.Tensor:
        return self.normal(*shape, std=shape[-2] ** -0.5)

    def norm(self, *shape) -> torch.Tensor:
        return self.normal(*shape, std=NORM_STD, mean=1.0)


def int8_tensor(leaf: dict):
    from flowspec_tpu_torch.ops.quant import Int8Tensor
    return Int8Tensor(q=leaf["q"], scale=leaf["scale"])


def eagle_draft(draw: Draw, cfg: dict, embed: torch.Tensor):
    """A random full-width EAGLE draft layer (fc 2H -> H, one decoder layer
    of the base's widths, no input norm) in int8, on the base's
    embedding: the draft the port's families are served with
    (`init_eagle_params` at full width, quantized to int8)."""
    from flowspec_tpu_torch.draft.eagle import EagleParams
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    d = h // cfg["num_attention_heads"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    q8 = lambda *s: int8_tensor(draw.int8(*s))
    return EagleParams(
        embed=embed, fc_w=q8(2 * h, h),
        fc_b=draw.normal(h, std=EMBED_STD),
        wq=q8(h, nq * d), wk=q8(h, nkv * d), wv=q8(h, nkv * d),
        wo=q8(nq * d, h), w_gate=q8(h, i), w_up=q8(h, i), w_down=q8(i, h),
        post_ln=draw.norm(h))
