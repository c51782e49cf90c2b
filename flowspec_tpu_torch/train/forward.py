"""The differentiable forwards of training.

The JAX trainers differentiate the model through XLA's dense attention
(`flowspec_tpu/models/llama.py:188-196`: `_use_flash` is off, so no Pallas
kernel is reached) and plain `einsum` products. Here the same stack runs
through the port's own `decoder_layer` / `eagle_layer` with the attention
kernel's plain version, `ops/tree_attention.py tree_attention_plain` (the
same formula as explicit ops, which autograd sees through), in place of
the kernel, whose wrapper refuses an operand that requires a gradient
(`ops/_build.py refuse_grad`). On training's fresh caches of T rows it
reads them all. The KV
append into fresh zero caches stays an in-place `index_copy_`, as JAX's
`dynamic_update_slice` into zeros: autograd carries the gradient through
the written rows.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.draft.eagle import (
    EagleParams, eagle_layer, fuse, project_out,
)
from flowspec_tpu_torch.models.bias import prefill_bias
from flowspec_tpu_torch.models.llama import (
    LlamaLayerParams, LlamaParams, decoder_layer, embed_tokens, final_hidden,
)
from flowspec_tpu_torch.ops.tree_attention import tree_attention_plain


def head_product(x: torch.Tensor, head: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """(..., H) @ head (H, V) -> (..., V) f32, what `einsum(...,
    preferred_element_type=f32)` computes on operands of `dtype`: x rounded
    to `dtype`, products of `dtype` values summed in f32 (exact products of
    bf16 values, so an f32 product of the rounded operands). `head` holds
    values of `dtype` (a frozen head's f32 copy, made once, or a trainable
    master cast to `dtype` in the graph)."""
    return torch.matmul(x.to(dtype).float(), head.float())


def causal_bias(t: int, device) -> torch.Tensor:
    """(T, T) f32: 0 where key j <= query i, -1e9 elsewhere."""
    pos = torch.arange(t, device=device)
    return torch.where(pos[None, :] <= pos[:, None], 0.0,
                       -1e9).to(torch.float32)


def draft_pairs_forward(trainable: dict, embed: torch.Tensor,
                        tokens: torch.Tensor, hiddens: torch.Tensor,
                        dcfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced draft pass over the pairs (token_{i+1}, hidden_i) of
    B sequences (`tools/train_bench_draft.py:184-204`,
    `train_struct_base.py:349-364`, `train_tiny_draft.py:136`): tokens (B,
    T), teacher hiddens (B, T, H) -> predicted hidden_{i+1} (B, T-1, H) in
    f32, through `fuse`, `eagle_layer` over fresh zero caches under the
    causal bias, and `project_out` (hidden_i + delta for a thin draft). The
    B sequences run as B lanes of one pass, each over its own cache, as
    JAX's `vmap` runs them."""
    p = EagleParams(embed=embed, **trainable)
    h_in = hiddens[:, :-1].float()
    x = fuse(p, tokens[:, 1:], h_in)
    b, t, _ = x.shape
    dev = x.device
    k = torch.zeros((b, dcfg.num_key_value_heads, t, dcfg.head_dim_),
                    dtype=torch.float32, device=dev)
    out = eagle_layer(x, p, k, torch.zeros_like(k),
                      torch.arange(t, device=dev), causal_bias(t, dev), 0,
                      dcfg, attn=tree_attention_plain)
    return project_out(p, out, h_in)


LAYER_FIELDS = tuple(f.name for f in dataclasses.fields(LlamaLayerParams))


def cast_floats(t, dtype):
    """Every floating-point leaf of a params dataclass cast to `dtype`, in
    the graph (the JAX trainers' `tree_map(astype)` of the f32 masters, and
    of a bf16 pair to f32 for the CPU engine)."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.to(dtype) if t.is_floating_point() else t
    return dataclasses.replace(t, **{
        f.name: cast_floats(getattr(t, f.name), dtype)
        for f in dataclasses.fields(t)})


def lm_forward(params: LlamaParams, tokens: torch.Tensor, mc: ModelConfig,
               remat: bool = True) -> torch.Tensor:
    """The base's causal-LM logits (`tools/train_struct_base.py:113-149
    make_lm_loss`): f32 master weights cast to bf16 inside the graph, the
    port's `decoder_layer` over fresh zero caches of T rows under the
    prefill bias, each layer recomputed in the backward (`remat`, JAX's
    `jax.checkpoint`), `final_hidden`, then the head product of positions
    0..T-2 -> (B, T-1, V) f32."""
    b, t = tokens.shape
    dev = tokens.device
    dtype = torch.bfloat16
    p = cast_floats(dataclasses.replace(params, layers=None), dtype)
    x = embed_tokens(p, tokens)
    pos = torch.arange(t, device=dev)
    bias = prefill_bias(0, t, t, device=dev)
    shape = (b, mc.num_key_value_heads, t, mc.head_dim_)

    def layer(x, *leaves):
        lp = cast_floats(LlamaLayerParams(**dict(zip(LAYER_FIELDS, leaves))),
                         dtype)
        k = torch.zeros(shape, dtype=dtype, device=dev)
        return decoder_layer(x, lp, k, torch.zeros_like(k), pos, bias, 0, mc,
                             attn=tree_attention_plain)

    for i in range(mc.num_hidden_layers):
        leaves = [None if (a := getattr(params.layers, f)) is None else a[i]
                  for f in LAYER_FIELDS]
        x = (checkpoint(layer, x, *leaves, use_reentrant=False) if remat
             else layer(x, *leaves))
    h = final_hidden(p, x, mc)
    return head_product(h[:, :-1], p.lm_head, dtype)
