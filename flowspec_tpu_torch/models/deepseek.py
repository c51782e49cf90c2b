"""DeepSeek-V3: latent attention (MLA) and a group-limited sigmoid MoE.

The equations of the published `modeling_deepseek.py`
(huggingface.co/deepseek-ai/DeepSeek-V3), served through the port's normal
path (`models/__init__.py model_forward`, the engine's chunked prefill,
captured round graphs and KV growth). Per layer, with x the residual:

- attention (all layers): q = q_b(RMSNorm(q_a(h))) split per head into
  q_nope (qk_nope_head_dim) and q_pe (qk_rope_head_dim); kv_a(h) gives
  c_kv (kv_lora_rank, then RMSNorm) and k_pe (qk_rope_head_dim, one for
  every head); YaRN rope on q_pe and k_pe after the published de-interleave
  of their dims; softmax scale (qk_nope + qk_rope)^-1/2 x mscale^2 with
  mscale = 0.1 x mscale_all_dim x ln(factor) + 1; o_proj.
- MLP: layers below first_k_dense_replace a SwiGLU of intermediate_size;
  the others a mixture: f32 sigmoid scores of the router, the selection
  bias (`e_score_correction_bias`) added for the selection only, the
  n_group groups scored by the sum of their two best biased scores,
  topk_group groups kept, the num_experts_per_tok best experts of those,
  their unbiased scores normalised to sum 1 and x routed_scaling_factor;
  plus n_shared_experts shared SwiGLUs on every token.

Departures, each on purpose:
- Absorbed attention on the cached path: the cache holds one latent row a
  token and layer (`models/kv_cache.py`: the normed c_kv then the roped
  k_pe, kv_lora_rank + qk_rope_head_dim values), never per-head K and V.
  q_nope is multiplied into kv_b's key half (`w_uk`), the attention runs
  over the latent rows (`ops/mla_attention.py`) and its output through
  kv_b's value half (`w_uv`) before o_proj: the same products, summed in
  another order. The published non-absorbed form is the reference's
  (`benchmark/reference/deepseek_v3.py`).
- The expert share: the layer is told which routed experts this card
  holds (`DeepseekConfig.held_experts`, expert parallelism), routes every
  token over all n_routed_experts and returns its own experts' part of
  the mixture plus the shared experts'. The absent experts' part would
  come from the other cards; one card runs without that exchange.
- Ties in the two selections go to the lower index (a stable descending
  sort; `torch.topk` promises no order), and the groups not kept are
  masked with -inf (the published inference code's choice; the HF file
  masks with 0.0, which differs only where every kept score is negative).
- bf16 rounding points follow the LLaMA layer (`models/llama.py`): norms
  and rope in f32, then cast; the router's products summed in f32.

The expert products run through `models/mixtral.py moe_experts` over the
held stack with the shared experts appended to it (weight 1 on every row),
one batched product a layer. While the recorder is on
(`utils/profiler.py prof.enabled`), every MoE-layer forward adds its
routing to the recorder's `moe.load` tally on the device (`count_load`:
per held expert the rows routed to it, the held experts reached by a row,
the forwards and their rows), which the engine reads once at a request's
end; with the recorder off the forward launches none of that.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import torch
import torch.nn.functional as F

from flowspec_tpu_torch.config import DeepseekConfig
from flowspec_tpu_torch.models.kv_cache import KVCache
from flowspec_tpu_torch.models.llama import kv_write, rms_norm
from flowspec_tpu_torch.models.mixtral import moe_experts, top_experts
from flowspec_tpu_torch.ops.mla_attention import mla_attention
from flowspec_tpu_torch.ops.quant import matmul_f32_out, qmatmul
from flowspec_tpu_torch.utils.profiler import prof


def _layer_of(obj, i: int):
    return type(obj)(**{f.name: getattr(obj, f.name)[i]
                        for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class DeepseekAttnParams:
    """MLA weights of every layer, leading (L,) axis."""
    wq_a: torch.Tensor       # (L, H, q_lora_rank)
    q_a_ln: torch.Tensor     # (L, q_lora_rank)
    wq_b: torch.Tensor       # (L, q_lora_rank, nh * (nope + rope))
    wkv_a: torch.Tensor      # (L, H, kv_lora_rank + rope)
    kv_a_ln: torch.Tensor    # (L, kv_lora_rank)
    w_uk: torch.Tensor       # (L, nh, nope, kv_lora_rank): kv_b's key half
    w_uv: torch.Tensor       # (L, nh, kv_lora_rank, v_head_dim): value half
    wo: torch.Tensor         # (L, nh * v_head_dim, H)
    input_ln: torch.Tensor   # (L, H)
    post_ln: torch.Tensor    # (L, H)

    layer = _layer_of


@dataclasses.dataclass
class DeepseekDenseParams:
    """The dense layers' SwiGLUs, leading (first_k_dense_replace,) axis."""
    w_gate: torch.Tensor     # (Ld, H, I)
    w_up: torch.Tensor
    w_down: torch.Tensor     # (Ld, I, H)

    layer = _layer_of


@dataclasses.dataclass
class DeepseekMoeParams:
    """The MoE layers, leading (Lm,) axis. The expert stacks hold this
    card's routed experts (in `DeepseekConfig.held_experts` order) and then
    the shared experts, (In, Out) as `moe_experts` reads them (they may be
    transposed views of (Out, In) stacks)."""
    router: torch.Tensor     # (Lm, H, n_routed_experts)
    score_bias: torch.Tensor  # (Lm, n_routed_experts) f32, selection only
    w_gate: torch.Tensor     # (Lm, held + shared, H, moe_inter)
    w_up: torch.Tensor
    w_down: torch.Tensor     # (Lm, held + shared, moe_inter, H)

    layer = _layer_of


@dataclasses.dataclass
class DeepseekParams:
    embed: torch.Tensor          # (V, H)
    attn: DeepseekAttnParams
    dense: DeepseekDenseParams
    moe: DeepseekMoeParams
    final_norm: torch.Tensor     # (H,)
    lm_head: torch.Tensor        # (H, V)


def absorb_kv_b(wkv_b: torch.Tensor, heads: int, nope: int):
    """kv_b (..., kv_lora_rank, heads * (nope + v)) in (In, Out) layout as
    the absorbed halves (w_uk (..., heads, nope, rank), w_uv (..., heads,
    rank, v)), copies."""
    dn = nope
    w = wkv_b.unflatten(-1, (heads, -1))              # (..., r, nh, dn+dv)
    w_uk = w[..., :dn].movedim(-3, -1).contiguous()   # (..., nh, dn, r)
    w_uv = w[..., dn:].movedim(-3, -2).contiguous()   # (..., nh, r, dv)
    return w_uk, w_uv


# ---- YaRN rope ---------------------------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: DeepseekConfig) -> float:
    """(nope + rope)^-1/2, x mscale^2 under YaRN with mscale_all_dim."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
        scale *= m * m
    return scale


def _correction_dim(rotations: float, dim: int, base: float,
                    max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


@lru_cache(maxsize=None)
def _inv_freq(dim: int, base: float, factor: float, orig: int,
              beta_fast: float, beta_slow: float,
              device: torch.device) -> torch.Tensor:
    """The rotary inverse frequencies, YaRN-blended when factor > 0
    (`DeepseekV3YarnRotaryEmbedding`): made once per device, on the first
    (eager) call, and read by every later one, captured ones included."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    if not factor:
        return extra
    low = max(math.floor(_correction_dim(beta_fast, dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(beta_slow, dim, base, orig)),
               dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp                  # 1: extrapolate, 0: interpolate
    return extra / factor * (1 - keep) + extra * keep


def rope_cos_sin(positions: torch.Tensor, cfg: DeepseekConfig):
    """f32 (cos, sin) of `positions` ((T,) or (B, T)) over the rope dims,
    shaped to broadcast over (B, heads, T, rope): computed once a forward
    and shared by its layers."""
    inv = _inv_freq(cfg.qk_rope_head_dim, float(cfg.rope_theta),
                    float(cfg.yarn_factor), cfg.yarn_original_max_position,
                    float(cfg.yarn_beta_fast), float(cfg.yarn_beta_slow),
                    positions.device)
    ang = positions.float()[..., None] * inv                   # (.., T, r/2)
    emb = torch.cat([ang, ang], dim=-1)
    m = 1.0
    if cfg.yarn_factor:
        m = (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
             / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    cos, sin = emb.cos() * m, emb.sin() * m
    lead = (slice(None), None) if positions.dim() == 2 else (None, None)
    return cos[lead], sin[lead]


def rope_deinterleaved(x: torch.Tensor, cos_sin) -> torch.Tensor:
    """x (B, h, T, r): the published de-interleave of the rope dims (pairs
    (2i, 2i+1) -> (i, i + r/2)), then rotate-half rope, in f32, cast back."""
    cos, sin = cos_sin
    b, h, t, r = x.shape
    xf = x.float().view(b, h, t, r // 2, 2).transpose(-1, -2).reshape(
        b, h, t, r)
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)


# ---- the blocks ----------------------------------------------------------

def mla_block(x, ap: DeepseekAttnParams, latent: torch.Tensor, bias,
              ws, cfg: DeepseekConfig, cos_sin) -> torch.Tensor:
    """One layer's attention over its (B, 1, S, C) latent cache: append the
    chunk's latent rows at `ws` (the forward's `KVWrite`), attend in the
    absorbed form -> (B, T, H)."""
    b, t, _ = x.shape
    nh, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                  cfg.qk_rope_head_dim)
    r, eps = cfg.kv_lora_rank, cfg.rms_norm_eps
    q = qmatmul(rms_norm(qmatmul(x, ap.wq_a), ap.q_a_ln, eps), ap.wq_b)
    q = q.view(b, t, nh, dn + dr)
    kv = qmatmul(x, ap.wkv_a)                                 # (B, T, r+dr)
    c_kv = rms_norm(kv[..., :r], ap.kv_a_ln, eps)
    k_pe = rope_deinterleaved(kv[..., r:].reshape(b, 1, t, dr), cos_sin)
    row = torch.cat([c_kv, k_pe[:, 0]], dim=-1).to(latent.dtype)
    latent.view(-1, r + dr).index_copy_(0, ws.flat, row.reshape(-1, r + dr))

    q_pe = rope_deinterleaved(q[..., dn:].transpose(1, 2), cos_sin)
    q_nope = q[..., :dn].permute(2, 0, 1, 3).reshape(nh, b * t, dn)
    q_lat = torch.matmul(q_nope, ap.w_uk).view(nh, b, t, r).transpose(0, 1)
    q_abs = torch.cat([q_lat, q_pe.to(q_lat.dtype)], dim=-1).contiguous()
    o_lat = mla_attention(q_abs, latent[:, 0], bias.float(),
                          n_valid=ws.n_valid, scale=softmax_scale(cfg),
                          v_dim=r)                            # (B, nh, T, r)
    o = torch.matmul(o_lat.transpose(0, 1).reshape(nh, b * t, r), ap.w_uv)
    o = o.view(nh, b, t, -1).permute(1, 2, 0, 3).reshape(b, t, -1)
    return qmatmul(o, ap.wo)


def route(scores: torch.Tensor, score_bias: torch.Tensor,
          cfg: DeepseekConfig) -> torch.Tensor:
    """f32 sigmoid scores (..., E) -> the (..., E) f32 mixture: zero off the
    group-limited top-k, the selected experts' unbiased scores normalised
    to sum 1 and x routed_scaling_factor (the module's note)."""
    e, g = scores.shape[-1], cfg.n_group
    choice = scores + score_bias
    group_score = choice.unflatten(-1, (g, e // g)).topk(
        2, dim=-1).values.sum(-1)                                # (..., g)
    _, keep = top_experts(group_score, cfg.topk_group)
    kept = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
        -1, keep, True)
    masked = choice.masked_fill(~kept.repeat_interleave(e // g, dim=-1),
                                float("-inf"))
    _, top_i = top_experts(masked, cfg.num_experts_per_tok)
    w = scores.gather(-1, top_i)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return torch.zeros_like(scores).scatter_(-1, top_i, w)


@lru_cache(maxsize=None)
def held_ids(cfg: DeepseekConfig, device: torch.device) -> torch.Tensor:
    """The ids of the routed experts the card holds (every one where the
    config names none) on `device`: made on the first (eager) call, read
    by every later one, captured ones included."""
    held = cfg.held_experts or range(cfg.n_routed_experts)
    return torch.tensor(list(held), dtype=torch.int64, device=device)


def load_values(counts: list) -> dict:
    """The `moe.load` span's values from the tally's counts."""
    *per_expert, reached, forwards, rows = counts
    return {"pairs": sum(per_expert), "reached": reached,
            "forwards": forwards, "rows": rows, "per_expert": per_expert}


def count_load(mix: torch.Tensor) -> None:
    """Add one MoE-layer forward's routing (`mix` over the held experts)
    to the recorder's `moe.load` tally, on the device: rows routed to each
    held expert, the held experts reached by a row, one forward and its
    rows."""
    held = mix.shape[-1]
    load = prof.tally("moe.load", held + 3, mix.device, load_values,
                      "moe_loads")
    hits = (mix > 0).reshape(-1, held).sum(0)
    load[:-3].add_(hits)
    load[-3].add_((hits > 0).sum())
    load[-2].add_(1)
    load[-1].add_(mix[..., 0].numel())


def moe_block(x: torch.Tensor, mp: DeepseekMoeParams,
              cfg: DeepseekConfig) -> torch.Tensor:
    """x (B, T, H) -> this card's routed experts' part of the mixture plus
    the shared experts, one layer's `mp`."""
    scores = torch.sigmoid(matmul_f32_out(x, mp.router))       # (B, T, E)
    mix = route(scores, mp.score_bias, cfg).index_select(
        -1, held_ids(cfg, x.device))
    if prof.enabled:
        count_load(mix)
    if cfg.n_shared_experts:
        mix = torch.cat([mix, mix.new_ones((*mix.shape[:-1],
                                            cfg.n_shared_experts))], dim=-1)
    return moe_experts(x, mp.w_gate, mp.w_up, mp.w_down, mix)


def decoder_layer(x, params: DeepseekParams, i: int, latent, bias, ws,
                  cfg: DeepseekConfig, cos_sin):
    ap = params.attn.layer(i)
    h = rms_norm(x, ap.input_ln, cfg.rms_norm_eps)
    x = x + mla_block(h, ap, latent, bias, ws, cfg, cos_sin)
    h = rms_norm(x, ap.post_ln, cfg.rms_norm_eps)
    k = cfg.first_k_dense_replace
    if i < k:
        dp = params.dense.layer(i)
        return x + qmatmul(F.silu(qmatmul(h, dp.w_gate))
                           * qmatmul(h, dp.w_up), dp.w_down)
    return x + moe_block(h, params.moe.layer(i - k), cfg)


def deepseek_forward(params: DeepseekParams, cache: KVCache,
                     hidden: torch.Tensor, positions: torch.Tensor,
                     bias: torch.Tensor, write_start, cfg: DeepseekConfig,
                     live: torch.Tensor | None = None):
    """`llama_forward` for DeepSeek over a latent cache ((L, B, 1, S, C),
    appended in place): (hidden not final-normed, cache). Lanes, `live`
    and write starts as there."""
    x = hidden
    ws = kv_write(write_start, hidden.shape[1], cache.k[0], live)
    cos_sin = rope_cos_sin(positions, cfg)
    for i in range(cache.k.shape[0]):
        x = decoder_layer(x, params, i, cache.k[i], bias, ws, cfg, cos_sin)
    return x, cache
