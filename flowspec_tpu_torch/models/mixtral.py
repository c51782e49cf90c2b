"""Mixtral-style sparse-MoE decoder with tree-masked attention.

Port of `flowspec_tpu/models/mixtral.py`: the LLaMA layer's attention
(`models/llama.py attention_block`, through the tree-attention kernel) with
`MixtralSparseMoeBlock` MLPs: a full-softmax router in f32, top-k experts
with renormalised weights, and the dense mixture over the stacked experts
(every token through all E experts, weighted by a (T, E) mixture that is
zero off its top-k), as the JAX package computes it. The JAX package runs
the expert products as `jnp.einsum` outside any Pallas kernel; here they
are batched matmuls over the expert axis. Mixtral is bf16 (or f32) only:
the stacked experts have no quantized container in either package.

The top-k order is pinned to `jax.lax.top_k`'s (equal router weights: the
lowest expert first) by a stable descending sort, and the mixture is
scattered into zeros, not built by `one_hot` (which checks its values on
the host, and so breaks CUDA graph capture).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.models.kv_cache import KVCache
from flowspec_tpu_torch.models.llama import (
    attention_block, kv_write, rms_norm,
)
from flowspec_tpu_torch.ops.quant import matmul_f32_out


@dataclasses.dataclass
class MixtralLayerParams:
    """Leading (num_layers,) axis on every tensor."""
    wq: torch.Tensor          # (L, H, nq*D)
    wk: torch.Tensor          # (L, H, nkv*D)
    wv: torch.Tensor
    wo: torch.Tensor          # (L, nq*D, H)
    router: torch.Tensor      # (L, H, E)
    w_gate: torch.Tensor      # (L, E, H, I)
    w_up: torch.Tensor        # (L, E, H, I)
    w_down: torch.Tensor      # (L, E, I, H)
    input_ln: torch.Tensor    # (L, H)
    post_ln: torch.Tensor     # (L, H)

    def layer(self, i: int) -> "MixtralLayerParams":
        return MixtralLayerParams(**{f.name: getattr(self, f.name)[i]
                                     for f in dataclasses.fields(self)})


@dataclasses.dataclass
class MixtralParams:
    embed: torch.Tensor          # (V, H)
    layers: MixtralLayerParams
    final_norm: torch.Tensor     # (H,)
    lm_head: torch.Tensor        # (H, V)


def top_experts(probs: torch.Tensor, k: int):
    """(..., E) -> the k largest (values, indices), equal values lowest
    index first (`jax.lax.top_k`'s order; `torch.topk` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(x: torch.Tensor, lp: MixtralLayerParams,
              cfg: ModelConfig) -> torch.Tensor:
    """x (B, T, H) -> (B, T, H) with one layer's `lp`
    (`flowspec_tpu/models/mixtral.py:53-74`): router logits from products
    of x's dtype summed in f32, softmax, top-k renormalised, then the dense
    mixture over the E experts, the mixture cast to the products' dtype
    before the final sum."""
    return moe_experts(x, lp.w_gate, lp.w_up, lp.w_down,
                       moe_mixture(x, lp.router, cfg))


def moe_mixture(x: torch.Tensor, router: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The (B, T, E) f32 mixture weights of x (B, T, H): the router's
    softmax, zero off each row's renormalised top-k."""
    logits = matmul_f32_out(x, router)                       # (B, T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_experts(probs, cfg.num_experts_per_tok)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(-1, top_i, top_p)


def moe_experts(x: torch.Tensor, w_gate, w_up, w_down,
                mix: torch.Tensor) -> torch.Tensor:
    """sum_e mix[..., e] * expert_e(x) over the stacked experts (E, H, I)
    / (E, I, H) given, with `mix` their (B, T, E) weights: all of a layer's
    experts, or one expert-parallel rank's E/tp (`parallel/tp.py`)."""
    b, t, h = x.shape
    xs = x.reshape(1, b * t, h)
    g = torch.matmul(xs, w_gate)                             # (E, BT, I)
    u = torch.matmul(xs, w_up)
    y = torch.matmul(F.silu(g) * u, w_down)                  # (E, BT, H)
    out = torch.einsum("enh,ne->nh", y,
                       mix.reshape(b * t, -1).to(y.dtype))
    return out.reshape(b, t, h)


def mixtral_decoder_layer(x, lp: MixtralLayerParams, k_cache, v_cache,
                          positions, bias, write_start, cfg: ModelConfig):
    """One decoder layer over one layer's (B, nkv, S, D) cache buffers."""
    res = x
    x = rms_norm(x, lp.input_ln, cfg.rms_norm_eps)
    x = res + attention_block(x, lp.wq, lp.wk, lp.wv, lp.wo, k_cache,
                              v_cache, positions, bias, write_start, cfg)
    res = x
    x = rms_norm(x, lp.post_ln, cfg.rms_norm_eps)
    return res + moe_block(x, lp, cfg)


def mixtral_forward(params: MixtralParams, cache: KVCache,
                    hidden: torch.Tensor, positions: torch.Tensor,
                    bias: torch.Tensor, write_start, cfg: ModelConfig,
                    live: torch.Tensor | None = None):
    """`llama_forward` with MoE layers: (hidden not final-normed, cache
    appended in place); lanes as there, the MoE block over all B*T rows."""
    x = hidden
    write_start = kv_write(write_start, hidden.shape[1], cache.k[0], live)
    for i in range(cache.k.shape[0]):
        x = mixtral_decoder_layer(x, params.layers.layer(i), cache.k[i],
                                  cache.v[i], positions, bias, write_start,
                                  cfg)
    return x, cache


def random_mixtral_params(cfg: ModelConfig, generator: torch.Generator,
                          device, dtype=None) -> MixtralParams:
    """Random params built on `device` in `dtype` (default cfg.dtype) with
    the distributions of `init_mixtral_params`
    (`flowspec_tpu/models/mixtral.py:123-156`): N(0, 1) x fan_in^-1/2, the
    embedding x 2500^-1/2, unit norms. Each layer is drawn in place, with
    no transient copy; `jax.random`'s bits are not reproduced (the same
    law, not the same weights)."""
    dt = dtype or getattr(torch, cfg.dtype)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n, e = cfg.num_hidden_layers, cfg.num_local_experts
    d = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def init(shape, fan):
        w = torch.empty(shape, dtype=dt, device=device)
        for part in (w if len(shape) > 2 else [w]):
            part.normal_(0.0, fan ** -0.5, generator=generator)
        return w

    layers = MixtralLayerParams(
        wq=init((n, h, nq * d), h), wk=init((n, h, nkv * d), h),
        wv=init((n, h, nkv * d), h), wo=init((n, nq * d, h), nq * d),
        router=init((n, h, e), h),
        w_gate=init((n, e, h, i), h), w_up=init((n, e, h, i), h),
        w_down=init((n, e, i, h), i),
        input_ln=torch.ones((n, h), dtype=dt, device=device),
        post_ln=torch.ones((n, h), dtype=dt, device=device))
    return MixtralParams(embed=init((v, h), 2500), layers=layers,
                         final_norm=torch.ones((h,), dtype=dt, device=device),
                         lm_head=init((h, v), h))


def load_mixtral_params(model_dir: str, cfg: ModelConfig | None = None,
                        dtype=torch.bfloat16, device=None) -> MixtralParams:
    """An HF Mixtral checkpoint (`block_sparse_moe.experts.{j}.w1/w2/w3`:
    w1 = gate, w3 = up, w2 = down) as stacked params on `device` (`cuda`
    unless named), transposed to (In, Out) tensor by tensor on the device
    (`models/loader.py`)."""
    from flowspec_tpu_torch.models import loader

    cfg = cfg or loader.load_model_config(model_dir)
    t = loader.Checkpoint(model_dir)
    device = loader.resolve_device(device)
    n, e = cfg.num_hidden_layers, cfg.num_local_experts
    pre = "model.layers.{}."
    moe = pre + "block_sparse_moe.experts.{}.w{}.weight"

    def experts(w_idx):
        return loader.stack_tensors(
            t, [[moe.format(i, j, w_idx) for j in range(e)]
                for i in range(n)], dtype, device, transpose=True)

    def per_layer(name, transpose):
        return loader.stack_tensors(t, [(pre + name).format(i)
                                        for i in range(n)],
                                    dtype, device, transpose)

    layers = MixtralLayerParams(
        wq=per_layer("self_attn.q_proj.weight", True),
        wk=per_layer("self_attn.k_proj.weight", True),
        wv=per_layer("self_attn.v_proj.weight", True),
        wo=per_layer("self_attn.o_proj.weight", True),
        router=per_layer("block_sparse_moe.gate.weight", True),
        w_gate=experts(1), w_up=experts(3), w_down=experts(2),
        input_ln=per_layer("input_layernorm.weight", False),
        post_ln=per_layer("post_attention_layernorm.weight", False))
    return MixtralParams(
        embed=loader.tensor_to(t["model.embed_tokens.weight"], dtype, device),
        layers=layers,
        final_norm=loader.tensor_to(t["model.norm.weight"], dtype, device),
        lm_head=loader.tensor_to(t["lm_head.weight"], dtype, device,
                                 transpose=True))
