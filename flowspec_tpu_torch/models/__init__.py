"""Model layer: transformer families with tree-masked attention.

Port of `flowspec_tpu/models/__init__.py`: LLaMA / Vicuna / Qwen2 share
`LlamaParams` (Qwen2 differs by its qkv biases, a config flag), Mixtral has
`MixtralParams`; DeepSeek-V3 (`DeepseekParams`, latent attention over a
latent cache) is the port's own family, with no JAX counterpart.
`model_forward` picks the family from the type of the parameters,
`init_base_cache` the cache from the type of the config. The HF loaders
are in `models/loader.py` and `models/mixtral.py`, the checkpoints of
params and engine states in `models/checkpoint.py`.
"""

from flowspec_tpu_torch.config import DeepseekConfig, ModelConfig
from flowspec_tpu_torch.models.bias import prefill_bias, tree_bias
from flowspec_tpu_torch.models.deepseek import DeepseekParams, deepseek_forward
from flowspec_tpu_torch.models.kv_cache import (
    KVCache, init_kv_cache, init_latent_cache,
)
from flowspec_tpu_torch.models.llama import (
    LlamaParams, embed_tokens, final_hidden, llama_forward, lm_head_logits,
    random_llama_params,
)
from flowspec_tpu_torch.models.mixtral import (
    MixtralParams, mixtral_forward, random_mixtral_params,
)


def model_forward(params, cache, hidden, positions, bias, write_start, cfg,
                  live=None):
    """The base model's forward for the family of `params`
    (`flowspec_tpu/models/__init__.py:21-28`): (hidden, cache). Lanes and
    `live` as in `llama_forward`. Tensor-parallel params
    (`parallel/tp.py TPParams`) run their own forward over the ranks'
    shards."""
    if not isinstance(params, (LlamaParams, MixtralParams, DeepseekParams)):
        return params.forward(cache, hidden, positions, bias, write_start,
                              cfg, live)
    if isinstance(params, DeepseekParams):
        return deepseek_forward(params, cache, hidden, positions, bias,
                                write_start, cfg, live)
    if isinstance(params, MixtralParams):
        return mixtral_forward(params, cache, hidden, positions, bias,
                               write_start, cfg, live)
    return llama_forward(params, cache, hidden, positions, bias,
                         write_start, cfg, live)


def init_base_cache(cfg: ModelConfig, lanes: int, rows: int, dtype,
                    device) -> KVCache:
    """The base model's zero KV cache of `lanes` lanes and `rows` rows: a
    latent cache for DeepSeek, per-head K / V buffers otherwise."""
    if isinstance(cfg, DeepseekConfig):
        return init_latent_cache(cfg.num_hidden_layers, lanes, rows,
                                 cfg.latent_dim, dtype, device)
    return init_kv_cache(cfg.num_hidden_layers, lanes,
                         cfg.num_key_value_heads, rows, cfg.head_dim_,
                         dtype, device)


__all__ = [
    "KVCache", "init_kv_cache", "init_latent_cache", "init_base_cache",
    "DeepseekParams", "deepseek_forward",
    "LlamaParams", "random_llama_params", "llama_forward", "final_hidden",
    "MixtralParams", "random_mixtral_params", "mixtral_forward",
    "model_forward", "embed_tokens", "lm_head_logits",
    "prefill_bias", "tree_bias",
]
