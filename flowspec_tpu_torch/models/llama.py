"""LLaMA-family transformer as plain functions over stacked-layer params.

Port of `flowspec_tpu/models/llama.py`. Decoder layers are stored stacked
along a leading layer axis (the JAX layout, so the bridge copies arrays
unchanged) and run by a Python loop in place of `lax.scan`. Attention is
mask-agnostic: one additive (T, S) bias carries the causal/tree structure.
Every attention goes through the tree-attention kernel's wrapper
(`ops/tree_attention.py`) and every quantized projection (int8, nf4, int4)
through its dequant-matmul's (`ops/quant_matmul.py`). bf16 rounding points
follow the JAX package: rms_norm and rope in f32 then cast, probs cast to
q's dtype. Write starts are host ints or 0-d device tensors: the K/V rows
and the attention's live-row count derive from them on the device
(`kv_write`), so a replayed CUDA graph follows each round's lengths.

Lanes: a (B, T, H) chunk runs B requests at once, each over its own rows of
the (L, B, nkv, S, D) cache, with (B, T) positions, a (B, T, S) bias and a
(B,) write start. Every projection sees the B*T rows as one matrix, the
K/V append is one scatter over all lanes, and one attention launch a layer
serves them all (`ops/tree_attention.py`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from typing import NamedTuple

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.models.kv_cache import (
    KVCache, device_scalar, flat_rows, lane_tensor, write_rows,
)
from flowspec_tpu_torch.ops.quant import (
    NF4_BLOCK, Int4Tensor, Int8Tensor, NF4Tensor, matmul_f32_out, qmatmul,
    quantize_int4, quantize_int8, quantize_nf4,
)
from flowspec_tpu_torch.ops.tree_attention import tree_attention


@dataclasses.dataclass
class LlamaLayerParams:
    """All tensors have a leading (num_layers,) axis; the weights may be
    stacked quantized containers (`ops/quant.py`). bq/bk/bv are None unless
    attention_bias."""
    wq: object           # (L, H, nq*D)
    wk: object           # (L, H, nkv*D)
    wv: object           # (L, H, nkv*D)
    wo: object           # (L, nq*D, H)
    w_gate: object       # (L, H, I)
    w_up: object         # (L, H, I)
    w_down: object       # (L, I, H)
    input_ln: torch.Tensor   # (L, H)
    post_ln: torch.Tensor    # (L, H)
    bq: torch.Tensor | None = None   # (L, nq*D)
    bk: torch.Tensor | None = None
    bv: torch.Tensor | None = None

    def layer(self, i: int) -> "LlamaLayerParams":
        return LlamaLayerParams(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name)[i])
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class LlamaParams:
    embed: torch.Tensor          # (V, H)
    layers: LlamaLayerParams
    final_norm: torch.Tensor     # (H,)
    lm_head: torch.Tensor        # (H, V)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """HF-style rotary: x (B, H, T, D), positions (T,) or (B, T) int."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    ang = positions.float()[..., None] * inv_freq             # (.., T, D/2)
    lead = (slice(None), None) if positions.dim() == 2 else (None, None)
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[lead]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[lead]
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def attention(q, k_all, v_all, bias, n_valid=None):
    """q (B, nq, T, D); k_all/v_all (B, nkv, S, D); bias (T, S) or (B, T,
    S) additive; `n_valid` live KV rows (rows at or past it carry a -1e9
    bias), a host int, a device scalar or one a lane. The tree-attention
    kernel on a CUDA tensor, its plain version on the CPU."""
    return tree_attention(q, k_all, v_all, bias.float(), n_valid)


class KVWrite(NamedTuple):
    """Where a T-token chunk goes in one layer's (B, nkv, S, D) cache: the
    rows of every lane and head in the cache viewed as (B*nkv*S, D) rows
    (clamped like `dynamic_update_slice`, a dead lane's at its last row),
    and the live rows after the write (0-d, or one a lane)."""
    flat: torch.Tensor       # (B*nkv*T,) int64
    n_valid: torch.Tensor    # () or (B,) int32


def kv_write(write_start, t: int, layer_cache: torch.Tensor,
             live: torch.Tensor | None = None) -> KVWrite:
    """The `KVWrite` of a chunk at `write_start` (host int, device scalar or
    (B,) per lane) into caches shaped like `layer_cache` (B, nkv, S, D),
    computed once per forward and shared by its layers."""
    b, h, s_max, _ = layer_cache.shape
    dev = layer_cache.device
    start = device_scalar(write_start, dev)
    rows = write_rows(lane_tensor(start, b, dev), t, s_max, live)
    return KVWrite(flat=flat_rows(rows, h, s_max), n_valid=start + t)


def attention_block(x, wq, wk, wv, wo, k_cache, v_cache, positions, bias,
                    write_start, cfg: ModelConfig, bq=None, bk=None,
                    bv=None, heads: tuple | None = None, attn=None):
    """qkv projections (+optional bias), rope, KV-cache append (in place,
    start clamped like `dynamic_update_slice`), masked attention, output
    projection. k_cache/v_cache are one layer's (B, nkv, S, D) buffers;
    `write_start` a host int, a device scalar, one a lane or the forward's
    `KVWrite`. `heads` = (lo, hi): the weights are one tensor-parallel
    rank's column / row shards, which own KV heads [lo, hi) of the cache
    (and their G query heads each); the result is then that rank's partial
    of the output projection (`parallel/tp.py`). `attn` replaces
    `attention` (training passes `ops/tree_attention.py
    tree_attention_plain`, which autograd can see through)."""
    b, t, _ = x.shape
    q = qmatmul(x, wq)
    k = qmatmul(x, wk)
    v = qmatmul(x, wv)
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    out = attend(q, k, v, k_cache, v_cache, positions, bias, write_start,
                 cfg, heads, attn)
    return qmatmul(out, wo)


def attend(q, k, v, k_cache, v_cache, positions, bias, write_start,
           cfg: ModelConfig, heads: tuple | None = None,
           attn=None) -> torch.Tensor:
    """The middle of `attention_block`: projected q (B, T, nq*D) and k / v
    (B, T, nkv*D) of the heads `heads` owns (all by default) -> rope, the
    KV append into those heads of the cache, tree attention -> (B, T,
    nq*D); `attn` as in `attention_block`."""
    b, t, _ = q.shape
    if not isinstance(write_start, KVWrite):
        write_start = kv_write(write_start, t, k_cache)
    d = cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    flat = write_start.flat
    k_own, v_own = k_cache, v_cache
    if heads is not None:
        lo, hi = heads
        nq, nkv = (hi - lo) * (nq // nkv), hi - lo
        flat = flat.view(b, -1, t)[:, lo:hi].reshape(-1)
        k_own, v_own = k_cache[:, lo:hi], v_cache[:, lo:hi]
    q = rope(q.reshape(b, t, nq, d).transpose(1, 2), positions,
             cfg.rope_theta)
    k = rope(k.reshape(b, t, nkv, d).transpose(1, 2), positions,
             cfg.rope_theta)
    v = v.reshape(b, t, nkv, d).transpose(1, 2)

    k_cache.view(-1, d).index_copy_(0, flat,
                                    k.to(k_cache.dtype).reshape(-1, d))
    v_cache.view(-1, d).index_copy_(0, flat,
                                    v.to(v_cache.dtype).reshape(-1, d))

    out = (attn or attention)(q.contiguous(), k_own, v_own, bias,
                              n_valid=write_start.n_valid)
    return out.transpose(1, 2).reshape(b, t, nq * d)


def decoder_layer(x, lp: LlamaLayerParams, k_cache, v_cache, positions, bias,
                  write_start, cfg: ModelConfig, attn=None):
    """One decoder layer over one layer's (B, nkv, S, D) cache buffers
    (`attn` as in `attention_block`)."""
    res = x
    x = rms_norm(x, lp.input_ln, cfg.rms_norm_eps)
    x = res + attention_block(
        x, lp.wq, lp.wk, lp.wv, lp.wo, k_cache, v_cache, positions, bias,
        write_start, cfg, bq=lp.bq, bk=lp.bk, bv=lp.bv, attn=attn)
    res = x
    x = rms_norm(x, lp.post_ln, cfg.rms_norm_eps)
    return res + qmatmul(F.silu(qmatmul(x, lp.w_gate)) * qmatmul(x, lp.w_up),
                         lp.w_down)


def llama_forward(params: LlamaParams, cache: KVCache, hidden: torch.Tensor,
                  positions: torch.Tensor, bias: torch.Tensor,
                  write_start, cfg: ModelConfig,
                  live: torch.Tensor | None = None):
    """Run the stacked decoder layers over a (B, T, H) chunk written at
    `write_start` (host int, device scalar, or (B,) per lane; `live` marks
    the lanes whose writes land, `models/kv_cache.py`), appending to
    `cache` in place. Returns (hidden, cache) — hidden not final-normed."""
    x = hidden
    write_start = kv_write(write_start, hidden.shape[1], cache.k[0], live)
    for i in range(cache.k.shape[0]):
        x = decoder_layer(x, params.layers.layer(i), cache.k[i], cache.v[i],
                          positions, bias, write_start, cfg)
    return x, cache


def final_hidden(params: LlamaParams, hidden: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)


def embed_tokens(params: LlamaParams, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.long().clamp(0, params.embed.shape[0] - 1)]


def lm_head_logits(params: LlamaParams, hidden: torch.Tensor) -> torch.Tensor:
    """(..., H) -> (..., V) f32: products of the working dtype summed in
    f32, as the JAX package's einsum with preferred_element_type=f32 (a
    bf16 product output would round every logit to bf16). On the card one
    GEMM of the working dtype with f32 output, no f32 copy of the (H, V)
    head; on the CPU the f32 product. Tensor-parallel params
    (`parallel/tp.py TPParams`) compute their vocab shards' logits and
    gather them."""
    sharded = getattr(params, "vocab_logits", None)
    if sharded is not None:
        return sharded(hidden)
    return matmul_f32_out(hidden, params.lm_head)


QUANT_FIELDS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
QUANT_KINDS = ("int8", "nf4", "int4", "mixed")
QUANTIZERS = {"int8": quantize_int8, "nf4": quantize_nf4,
              "int4": quantize_int4}


def field_kinds(kind: str) -> dict:
    """Container kind per decoder matmul. "mixed" = attention int4 + FFN
    int8: the attention stacks (a third of the bytes) take the 4-bit format,
    the FFN keeps int8."""
    if kind not in QUANT_KINDS:
        raise ValueError(f"quantization kind {kind!r} not in {QUANT_KINDS}")
    if kind == "mixed":
        return {f: ("int4" if f in ("wq", "wk", "wv", "wo") else "int8")
                for f in QUANT_FIELDS}
    return {f: kind for f in QUANT_FIELDS}


def quantize_llama_params(params: LlamaParams, kind: str) -> LlamaParams:
    """Weight-only quantize the decoder matmuls as "int8", "nf4", "int4" or
    "mixed" (stacked (L, In, Out) leaves quantize per layer). Embeddings,
    lm_head, norms and biases stay in the working dtype."""
    kinds = field_kinds(kind)
    lp = dataclasses.replace(params.layers, **{
        f: QUANTIZERS[kinds[f]](getattr(params.layers, f))
        for f in QUANT_FIELDS})
    return dataclasses.replace(params, layers=lp)


def random_llama_params(cfg: ModelConfig, generator: torch.Generator,
                        device, kind: str = "int8") -> LlamaParams:
    """Random quantized base of any kind built directly on `device` (no bf16
    copy), with the distributions of the JAX bench (`bench.py:138-218`):
    int8 codes uniform in [-127, 127] with scale In^-1/2 / 127; packed 4-bit
    bytes uniform in [0, 255] with block scale In^-1/2 (nf4) or In^-1/2 / 7
    (int4); embed N(0, 0.02), lm_head N(0, 1) * H^-1/2, unit norms; with
    `cfg.attention_bias` (Qwen2) zero qkv biases, as `init_llama_params`
    gives. `jax.random`'s bits cannot be reproduced here, so this is the
    same distribution, not the same weights."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n, d = cfg.num_hidden_layers, cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    dt = getattr(torch, cfg.dtype)
    kinds = field_kinds(kind)

    def fill(q, lo, hi):
        for layer in q:                 # per layer: a small int64 transient
            layer.copy_(torch.randint(lo, hi, tuple(layer.shape),
                                      generator=generator, device=device))
        return q

    def q_of(field, n_in, n_out):
        fk = kinds[field]
        if fk == "int8":
            q = torch.empty((n, n_in, n_out), dtype=torch.int8, device=device)
            s = torch.full((n, n_out), n_in ** -0.5 / 127.0,
                           dtype=torch.float32, device=device)
            return Int8Tensor(q=fill(q, -127, 128), scale=s)
        q = torch.empty((n, n_in // 2, n_out), dtype=torch.uint8,
                        device=device)
        s = torch.full((n, n_in // NF4_BLOCK, n_out),
                       n_in ** -0.5 / (7.0 if fk == "int4" else 1.0),
                       dtype=torch.float32, device=device)
        cls = Int4Tensor if fk == "int4" else NF4Tensor
        return cls(q=fill(q, 0, 256), scale=s)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * std).to(dt)

    layers = LlamaLayerParams(
        wq=q_of("wq", h, nq * d), wk=q_of("wk", h, nkv * d),
        wv=q_of("wv", h, nkv * d), wo=q_of("wo", nq * d, h),
        w_gate=q_of("w_gate", h, i), w_up=q_of("w_up", h, i),
        w_down=q_of("w_down", i, h),
        input_ln=torch.ones((n, h), dtype=dt, device=device),
        post_ln=torch.ones((n, h), dtype=dt, device=device))
    if cfg.attention_bias:
        layers = dataclasses.replace(layers, **{
            f: torch.zeros((n, width), dtype=dt, device=device)
            for f, width in (("bq", nq * d), ("bk", nkv * d),
                             ("bv", nkv * d))})
    return LlamaParams(embed=normal((v, h), 0.02), layers=layers,
                       final_norm=torch.ones((h,), dtype=dt, device=device),
                       lm_head=normal((h, v), h ** -0.5))


def random_int8_llama_params(cfg: ModelConfig, generator: torch.Generator,
                             device) -> LlamaParams:
    """`random_llama_params` of kind "int8"."""
    return random_llama_params(cfg, generator, device, "int8")


def init_llama_params(generator: torch.Generator, cfg: ModelConfig,
                      dtype=None, device=None) -> LlamaParams:
    """Random unquantized base (`flowspec_tpu/models/llama.py:317
    init_llama_params`), drawn from `generator` on `device` (`cuda` unless
    named) in `dtype` (cfg.dtype by default): weights N(0, 1) x In^-1/2,
    the embedding N(0, 0.02), unit norms and, as there, zero qkv biases
    whatever `cfg.attention_bias` says (a trained base updates them). The
    law of the JAX package's draw, not its bits."""
    from flowspec_tpu_torch.runtime.engine import resolve_device
    device = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n, d = cfg.num_hidden_layers, cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def init(shape, std=None):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, shape[-2] ** -0.5 if std is None else std,
            generator=generator)

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    layers = LlamaLayerParams(
        wq=init((n, h, nq * d)), wk=init((n, h, nkv * d)),
        wv=init((n, h, nkv * d)), wo=init((n, nq * d, h)),
        w_gate=init((n, h, i)), w_up=init((n, h, i)), w_down=init((n, i, h)),
        input_ln=const((n, h), 1.0), post_ln=const((n, h), 1.0),
        bq=const((n, nq * d), 0.0), bk=const((n, nkv * d), 0.0),
        bv=const((n, nkv * d), 0.0))
    return LlamaParams(embed=init((v, h), 0.02), layers=layers,
                       final_norm=const((h,), 1.0), lm_head=init((h, v)))
