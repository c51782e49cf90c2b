"""Qwen2 (a LLaMA decoder with q / k / v biases) served with weight-only
int8 decoder matmuls: the weights drawn from the seed, the port's
`LlamaParams` over the same tensors, and the port's ModelConfig."""

from __future__ import annotations

from benchmark.families.common import (
    BIAS_STD, EMBED_STD, Draw, eagle_draft, int8_tensor,
)


def model_config(cfg: dict):
    from flowspec_tpu_torch.config import ModelConfig
    return ModelConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        attention_bias=True, tie_word_embeddings=cfg["tie_word_embeddings"],
        dtype=cfg["torch_dtype"])


def draw(cfg: dict, draw: Draw) -> dict:
    """The base's weights, stacked over the layers: int8 q / k / v / o and
    MLP matmuls, bf16 biases, norms, embedding and lm_head."""
    n, h, i = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["intermediate_size"])
    d = h // cfg["num_attention_heads"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    v = cfg["vocab_size"]
    layers = {
        "wq": draw.int8(n, h, nq * d), "wk": draw.int8(n, h, nkv * d),
        "wv": draw.int8(n, h, nkv * d), "wo": draw.int8(n, nq * d, h),
        "w_gate": draw.int8(n, h, i), "w_up": draw.int8(n, h, i),
        "w_down": draw.int8(n, i, h),
        "bq": draw.normal(n, nq * d, std=BIAS_STD),
        "bk": draw.normal(n, nkv * d, std=BIAS_STD),
        "bv": draw.normal(n, nkv * d, std=BIAS_STD),
        "input_ln": draw.norm(n, h), "post_ln": draw.norm(n, h)}
    return {"embed": draw.normal(v, h, std=EMBED_STD), "layers": layers,
            "final_norm": draw.norm(h), "lm_head": draw.matrix(h, v)}


def port_params(w: dict):
    from flowspec_tpu_torch.models.llama import LlamaLayerParams, LlamaParams
    lw = w["layers"]
    return LlamaParams(
        embed=w["embed"], final_norm=w["final_norm"], lm_head=w["lm_head"],
        layers=LlamaLayerParams(**{
            k: int8_tensor(x) if isinstance(x, dict) else x
            for k, x in lw.items()}))


def draft(cfg: dict, draw: Draw, w: dict):
    return eagle_draft(draw, cfg, w["embed"])
