"""Mixtral (a LLaMA decoder whose MLP is a sparse mixture of SwiGLU
experts) served in bf16: the weights drawn from the seed, the port's
`MixtralParams` over the same tensors, the port's ModelConfig, and the
probe that names its expert GEMMs in a trace."""

from __future__ import annotations

from benchmark.families.common import EMBED_STD, Draw, eagle_draft


def model_config(cfg: dict):
    from flowspec_tpu_torch.config import ModelConfig
    return ModelConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        tie_word_embeddings=cfg["tie_word_embeddings"],
        num_local_experts=cfg["num_local_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        dtype=cfg["torch_dtype"])


def draw(cfg: dict, draw: Draw) -> dict:
    """The base's bf16 weights, stacked over the layers (experts (L, E,
    In, Out))."""
    n, h, i = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["intermediate_size"])
    d = h // cfg["num_attention_heads"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    e, v = cfg["num_local_experts"], cfg["vocab_size"]
    m = draw.matrix
    layers = {"wq": m(n, h, nq * d), "wk": m(n, h, nkv * d),
              "wv": m(n, h, nkv * d), "wo": m(n, nq * d, h),
              "router": m(n, h, e), "w_gate": m(n, e, h, i),
              "w_up": m(n, e, h, i), "w_down": m(n, e, i, h),
              "input_ln": draw.norm(n, h), "post_ln": draw.norm(n, h)}
    return {"embed": draw.normal(v, h, std=EMBED_STD), "layers": layers,
            "final_norm": draw.norm(h), "lm_head": m(h, v)}


def port_params(w: dict):
    from flowspec_tpu_torch.models.mixtral import (
        MixtralLayerParams, MixtralParams,
    )
    return MixtralParams(embed=w["embed"], final_norm=w["final_norm"],
                         lm_head=w["lm_head"],
                         layers=MixtralLayerParams(**w["layers"]))


def draft(cfg: dict, draw: Draw, w: dict):
    return eagle_draft(draw, cfg, w["embed"])


def expert_gemm_names(eng, cfg: dict, mix: dict, device) -> frozenset:
    """The GEMMs of `moe_block` on the served engine's first layer at the
    row counts of the cell's base forwards: a prefill chunk and a verify
    (`lib/trace.py moe_gemm_names`)."""
    from benchmark.lib.trace import moe_gemm_names
    return moe_gemm_names(
        eng.params, eng.params.layers.layer(0), eng.cfg.model,
        (mix["engine"]["prefill_chunk"], eng.cfg.tree.node_cap), device)
