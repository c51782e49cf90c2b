"""EAGLE draft network: hidden = decoder_layer(fc(concat(embed(tok), h))).

Port of `flowspec_tpu/draft/eagle.py`: frozen base embeddings, `fc: 2H ->
W` fusion, one LLaMA decoder layer whose input layernorm is skipped, and
(thin drafts, W < H) a `w_out: (W, H)` residual projection back to the base
hidden space. The draft geometry is derived from the parameter shapes
(`draft_view`), so no second config is threaded through; the head dim is
the base's, unless the draft states its own (`SizedEagleParams`: a base
whose attention has no head dim of the draft's kind, as DeepSeek-V3's
latent attention). Drafts come from
`init_eagle_params` (random, full width or thin), `load_eagle_params` (an
HF EAGLE head) or `load_thin_draft` (the repo's npz drafts).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.models.bias import prefill_bias
from flowspec_tpu_torch.models.kv_cache import KVCache, device_scalar
from flowspec_tpu_torch.models.llama import (
    QUANT_KINDS, QUANTIZERS, attention_block, kv_write, rms_norm,
)
from flowspec_tpu_torch.ops.quant import qmatmul


@dataclasses.dataclass
class EagleParams:
    embed: torch.Tensor   # (V, H) — the base model's (frozen)
    fc_w: object          # (2H, W)  (W == H for the reference layout)
    fc_b: torch.Tensor    # (W,)
    wq: object            # (W, nq*D)
    wk: object
    wv: object
    wo: object
    w_gate: object
    w_up: object
    w_down: object
    post_ln: torch.Tensor  # (W,) — input_ln intentionally absent
    w_out: object = None   # (W, H) thin-draft output projection


@dataclasses.dataclass
class SizedEagleParams(EagleParams):
    """An EAGLE draft that states its own head dim (the layer is the same
    plain LLaMA layer, with plain rope)."""
    head_dim: int | None = None


def _odim(x) -> int:
    """Output (last) dim of a possibly-quantized weight."""
    q = getattr(x, "q", None)
    return (x if q is None else q).shape[-1]


def draft_view(p: EagleParams, base_cfg: ModelConfig) -> ModelConfig:
    """ModelConfig of the draft layer's geometry, from the param shapes;
    head_dim is the draft's own where it states one, else the base's so
    rope matches across widths. A tensor-parallel draft (`parallel/tp.py
    TPDraft`) gives its unsharded geometry."""
    if not isinstance(p, EagleParams):
        return p.view(base_cfg)
    return geometry(base_cfg, _odim(p.fc_w), _odim(p.wq), _odim(p.wk),
                    _odim(p.w_gate), getattr(p, "head_dim", None))


def geometry(base_cfg: ModelConfig, width: int, q_out: int, k_out: int,
             inter: int, head_dim: int | None = None) -> ModelConfig:
    """The draft's ModelConfig from its width W, the Out widths of wq / wk,
    its intermediate size and head dim (None: the base's): `base_cfg`
    itself for the full-width layout. Only the LLaMA fields of the base's
    config carry over (a DeepSeek base's latent-attention and MoE fields
    describe no layer of the draft)."""
    if type(base_cfg) is not ModelConfig:
        base_cfg = ModelConfig(**{f.name: getattr(base_cfg, f.name)
                                  for f in dataclasses.fields(ModelConfig)})
    d = head_dim or base_cfg.head_dim_
    nq, nkv = q_out // d, k_out // d
    if (width == base_cfg.hidden_size
            and inter == base_cfg.intermediate_size
            and nq == base_cfg.num_attention_heads
            and nkv == base_cfg.num_key_value_heads
            and d == base_cfg.head_dim_):
        return base_cfg
    return dataclasses.replace(
        base_cfg, hidden_size=width, intermediate_size=inter,
        num_attention_heads=nq, num_key_value_heads=nkv, head_dim=d)


def project_out(p: EagleParams, x: torch.Tensor,
                hidden_in: torch.Tensor) -> torch.Tensor:
    """Draft output in base H space: x itself for a full-width draft, the
    residual hidden_in + x @ w_out for a thin one (replicated under tensor
    parallelism)."""
    p = p if isinstance(p, EagleParams) else p.shards[0]
    if p.w_out is None:
        return x
    return hidden_in.to(x.dtype) + qmatmul(x, p.w_out)


def eagle_layer(x: torch.Tensor, p: EagleParams, k_cache, v_cache,
                positions: torch.Tensor, bias: torch.Tensor, write_start,
                cfg: ModelConfig, live: torch.Tensor | None = None,
                attn=None) -> torch.Tensor:
    """x (B, T, W) already fc-fused; no input RMSNorm. k/v_cache are the
    draft layer's (B, nkv, S, D) buffers, appended in place at
    `write_start` (host int, device scalar or (B,) per lane; `live` as in
    `models/kv_cache.py`); `attn` as in `models/llama.py attention_block`.
    A tensor-parallel draft (`parallel/tp.py TPDraft`) runs its own layer
    over the ranks' shards."""
    if not isinstance(p, EagleParams):
        return p.layer(x, k_cache, v_cache, positions, bias, write_start,
                       cfg, live)
    if live is not None:
        write_start = kv_write(write_start, x.shape[1], k_cache, live)
    res = x
    x = res + attention_block(x, p.wq, p.wk, p.wv, p.wo, k_cache, v_cache,
                              positions, bias, write_start, cfg, attn=attn)
    res = x
    x = rms_norm(x, p.post_ln, cfg.rms_norm_eps)
    return res + qmatmul(F.silu(qmatmul(x, p.w_gate)) * qmatmul(x, p.w_up),
                         p.w_down)


def fuse(p: EagleParams, tokens: torch.Tensor,
         hidden: torch.Tensor) -> torch.Tensor:
    """fc(concat(embed(tokens), hidden)), concatenated in hidden's dtype
    (a tensor-parallel draft gathers its ranks' column shards of fc)."""
    if not isinstance(p, EagleParams):
        return p.fuse(tokens, hidden)
    emb = p.embed[tokens.long().clamp(0, p.embed.shape[0] - 1)]
    x = torch.cat([emb.to(hidden.dtype), hidden], dim=-1)
    return qmatmul(x, p.fc_w) + p.fc_b


EAGLE_QUANT_FIELDS = ("fc_w", "wq", "wk", "wv", "wo",
                      "w_gate", "w_up", "w_down", "w_out")


def quantize_eagle_params(p: EagleParams, kind: str) -> EagleParams:
    """Weight-only quantize the draft matmuls as "int8", "nf4" or "int4";
    "mixed" keeps the draft (~1/32 of the base) all int8."""
    if kind not in QUANT_KINDS:
        raise ValueError(f"quantization kind {kind!r} not in {QUANT_KINDS}")
    fn = QUANTIZERS["int8" if kind == "mixed" else kind]
    return dataclasses.replace(p, **{f: fn(getattr(p, f))
                                     for f in EAGLE_QUANT_FIELDS
                                     if getattr(p, f) is not None})


def draft_context_forward(p: EagleParams, cache: KVCache,
                          tokens: torch.Tensor, hidden: torch.Tensor,
                          start, n_valid, cfg: ModelConfig,
                          live: torch.Tensor | None = None):
    """Advance the draft KV over context pairs (token_{i+1}, base_hidden_i).

    tokens (T,), hidden (1, T, H) padded to a static T; pairs [0, n_valid)
    are real; `start` and `n_valid` are host ints or device scalars. Per
    lane: tokens (B, T), hidden (B, T, H), (B,) start and n_valid, each
    lane over its own draft KV (`live` as in `models/kv_cache.py`). Returns
    (out_hidden (B, T, H), cache with length start + n_valid — the
    reference's `stable_kv`).
    """
    dc = draft_view(p, cfg)
    t = tokens.shape[-1]
    dev = tokens.device
    start = device_scalar(start, dev)
    x = fuse(p, tokens.reshape(-1, t), hidden)
    steps = torch.arange(t, device=dev)
    positions = start[:, None] + steps if start.dim() else start + steps
    bias = prefill_bias(start, t, cache.max_len, device=dev)
    out = eagle_layer(x, p, cache.k[0], cache.v[0], positions, bias, start,
                      dc, live)
    return project_out(p, out, hidden), cache.with_length(start + n_valid)


def load_thin_draft(path: str, embed: torch.Tensor,
                    dtype=torch.bfloat16) -> EagleParams:
    """Load a distilled thin-draft checkpoint (npz of the trainable fields,
    fp16); embeddings come from the base model."""
    with np.load(path) as z:
        kw = {f: torch.from_numpy(z[f].astype(np.float32)).to(
            device=embed.device, dtype=dtype) for f in z.files}
    return EagleParams(embed=embed, **kw)


def init_eagle_params(generator: torch.Generator, cfg: ModelConfig,
                      embed: torch.Tensor | None = None, dtype=None,
                      width: int | None = None, n_heads: int | None = None,
                      n_kv_heads: int | None = None,
                      inter: int | None = None, device=None) -> EagleParams:
    """Random draft (`flowspec_tpu/draft/eagle.py:158-198`), drawn from
    `generator` on `device` (embed's device when an embed is given, else
    `cuda` unless named). By default the reference's full-width layout (W
    == H); `width` / `n_heads` / `n_kv_heads` / `inter` make a thin draft
    with a w_out: (W, H) projection, head_dim the base's. Weights are
    N(0, 1) x In^-1/2 drawn in place in `dtype` (the embedding N(0, 0.02)):
    the law of the JAX package's draw, not its bits."""
    from flowspec_tpu_torch.runtime.engine import resolve_device
    dt = dtype or getattr(torch, cfg.dtype)
    device = (embed.device if device is None and embed is not None
              else resolve_device(device))
    h, v = cfg.hidden_size, cfg.vocab_size
    d = cfg.head_dim_
    w = width or h
    i = inter or (cfg.intermediate_size if w == h else
                  int(2.75 * w) // 256 * 256 or w * 2)
    nq = n_heads or (cfg.num_attention_heads if w == h else max(w // d, 1))
    nkv = n_kv_heads or (cfg.num_key_value_heads if w == h
                         else max(w // d, 1))
    thin = (w != h or nq != cfg.num_attention_heads
            or nkv != cfg.num_key_value_heads or i != cfg.intermediate_size)

    def init(shape, std=None):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, shape[0] ** -0.5 if std is None else std,
            generator=generator)

    return EagleParams(
        embed=embed if embed is not None else init((v, h), 0.02),
        fc_w=init((2 * h, w)),
        fc_b=torch.zeros((w,), dtype=dt, device=device),
        wq=init((w, nq * d)), wk=init((w, nkv * d)), wv=init((w, nkv * d)),
        wo=init((nq * d, w)),
        w_gate=init((w, i)), w_up=init((w, i)), w_down=init((i, w)),
        post_ln=torch.ones((w,), dtype=dt, device=device),
        w_out=init((w, h)) if thin else None)


def load_eagle_params(draft_dir: str, embed: torch.Tensor,
                      dtype=torch.bfloat16) -> EagleParams:
    """An EAGLE head in the HF layout of the reference (`fc.*`,
    `layers.0.*`; `flowspec_tpu/draft/eagle.py:213-252`) from the
    `*.safetensors` files of `draft_dir` (the port's reader), else from its
    `*.bin` files (`torch.load(..., weights_only=True)`), on embed's device:
    (out, in) weights transposed there, one tensor at a time. The
    embeddings are the base model's."""
    from flowspec_tpu_torch.models.loader import SafetensorsFile, tensor_to

    files = sorted(os.listdir(draft_dir))
    source = {}                     # tensor name -> the file that holds it
    for f in files:
        if f.endswith(".safetensors"):
            h = SafetensorsFile(os.path.join(draft_dir, f))
            source.update({name: h for name in h.keys()})
    if not source:
        for f in files:
            if f.endswith(".bin"):
                sd = torch.load(os.path.join(draft_dir, f),
                                map_location="cpu", weights_only=True)
                source.update({name: sd for name in sd})
    get = lambda name: source[name][name]
    dev = embed.device

    def g(name):
        return tensor_to(get(name), dtype, dev, transpose=True)

    pre = "layers.0."
    fc_w = g("fc.weight")
    return EagleParams(
        embed=embed, fc_w=fc_w,
        fc_b=(tensor_to(get("fc.bias"), dtype, dev) if "fc.bias" in source
              else torch.zeros((fc_w.shape[1],), dtype=dtype, device=dev)),
        wq=g(pre + "self_attn.q_proj.weight"),
        wk=g(pre + "self_attn.k_proj.weight"),
        wv=g(pre + "self_attn.v_proj.weight"),
        wo=g(pre + "self_attn.o_proj.weight"),
        w_gate=g(pre + "mlp.gate_proj.weight"),
        w_up=g(pre + "mlp.up_proj.weight"),
        w_down=g(pre + "mlp.down_proj.weight"),
        post_ln=tensor_to(get(pre + "post_attention_layernorm.weight"),
                          dtype, dev))
