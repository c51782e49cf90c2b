"""The structured base's and its draft's files (the struct fixtures).

The file half of `tools/train_struct_base.py` (`:48 SCALES`, `:99
DRAFT_FIELDS`, `:103 model_config`, `:152 save_base`, `:159 load_base`,
`:175 save_draft`, `:181 load_draft`); the port's training of the pair is
`train/struct_base.py`.

`save_base` there writes the base's leaves as `p0..pN` in the order
`jax.tree_util` flattens `init_llama_params`'s structure: the fields of
`LlamaParams` in declaration order, `layers` expanded into the fields of
`LlamaLayerParams` (which lists the qkv biases after wo). The port cannot
flatten a JAX tree, so `BASE_LEAVES` writes that order out. Both packages
write fp16 and read the files either one wrote.
"""

from __future__ import annotations

import numpy as np
import torch

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.draft.eagle import EagleParams
from flowspec_tpu_torch.models.llama import LlamaLayerParams, LlamaParams
from flowspec_tpu_torch.runtime.engine import resolve_device

SCALES = {
    # CPU/CI scale (`tools/train_struct_base.py:50-56`)
    "tiny": dict(vocab=512, hidden=128, inter=320, layers=4, heads=4, kv=4,
                 n_classes=16, copy_dist=8, seq_len=96, n_seqs=2048,
                 holdout=64, batch=16, steps=800, lr=3e-3,
                 distill_pool=128, distill_outer=25, gen_tokens=48,
                 prompt_len=24, draft_width=64, distill_batch=16),
    # 8 layers, stage-split 8 ways: the committed struct_tiny8 fixtures
    # (`:57-73`)
    "tiny8": dict(vocab=1024, hidden=256, inter=640, layers=8, heads=4,
                  kv=4, n_classes=8, copy_dist=8, seq_len=128, n_seqs=4096,
                  holdout=64, batch=16, steps=3000, lr=3e-3,
                  distill_pool=128, distill_outer=150, gen_tokens=48,
                  prompt_len=24, draft_width=256, distill_batch=16),
    # hardware scale, ~170M params (`:74-87`)
    "mid": dict(vocab=8192, hidden=1024, inter=2816, layers=12, heads=16,
                kv=16, n_classes=16, copy_dist=16, seq_len=512,
                n_seqs=16384, holdout=64, batch=16, steps=12000, lr=1e-3,
                distill_pool=256, distill_outer=300, gen_tokens=256,
                prompt_len=64, draft_width=1024, distill_batch=16),
    # bench scale, ~0.5B (`:88-97`)
    "big": dict(vocab=8192, hidden=1792, inter=4864, layers=12, heads=14,
                kv=14, n_classes=16, copy_dist=16, seq_len=512,
                n_seqs=16384, holdout=64, batch=16, steps=12000, lr=8e-4,
                distill_pool=256, distill_outer=300, gen_tokens=256,
                prompt_len=64, draft_width=1792, distill_batch=16),
}

DRAFT_FIELDS = ("fc_w", "fc_b", "wq", "wk", "wv", "wo",
                "w_gate", "w_up", "w_down", "post_ln", "w_out")

# `p{i}` of a saved base is BASE_LEAVES[i]; "layers." names a stacked
# (L, ...) field of LlamaLayerParams
BASE_LEAVES = ("embed", "layers.wq", "layers.wk", "layers.wv", "layers.wo",
               "layers.bq", "layers.bk", "layers.bv", "layers.w_gate",
               "layers.w_up", "layers.w_down", "layers.input_ln",
               "layers.post_ln", "final_norm", "lm_head")


def model_config(s) -> ModelConfig:
    return ModelConfig(vocab_size=s["vocab"], hidden_size=s["hidden"],
                       intermediate_size=s["inter"],
                       num_hidden_layers=s["layers"],
                       num_attention_heads=s["heads"],
                       num_key_value_heads=s["kv"],
                       max_position_embeddings=2560)


def _leaf(params: LlamaParams, name: str) -> torch.Tensor:
    """Leaf `name` of BASE_LEAVES."""
    if name.startswith("layers."):
        return getattr(params.layers, name[len("layers."):])
    return getattr(params, name)


def save_base(params: LlamaParams, path: str) -> None:
    """The base's leaves as fp16 `p0..pN` in BASE_LEAVES order, compressed
    (`tools/train_struct_base.py:152`): an unquantized base with qkv biases,
    as `init_llama_params` draws one."""
    np.savez_compressed(path, **{
        f"p{i}": _leaf(params, name).detach().float().cpu().numpy().astype(
            np.float16) for i, name in enumerate(BASE_LEAVES)})


def save_draft(draft: EagleParams, path: str) -> None:
    """The draft's DRAFT_FIELDS that it has, fp16, compressed
    (`tools/train_struct_base.py:175`)."""
    np.savez_compressed(path, **{
        f: getattr(draft, f).detach().float().cpu().numpy().astype(
            np.float16)
        for f in DRAFT_FIELDS if getattr(draft, f) is not None})


def load_base(path: str, mc: ModelConfig, device=None) -> LlamaParams:
    """LlamaParams in mc.dtype from the flat leaves `save_base` wrote (fp16
    there; any float dtype is read), on `device` (`cuda` unless named).
    Every leaf is kept, the qkv biases too: training updates them, so a
    trained base has nonzero ones whatever `mc.attention_bias` says, and
    both packages add a bias that is present."""
    dev = resolve_device(device)
    dt = getattr(torch, mc.dtype)
    with np.load(path) as z:
        if len(z.files) != len(BASE_LEAVES):
            raise ValueError(f"{path}: {len(z.files)} leaves, a base has "
                             f"{len(BASE_LEAVES)}")
        leaves = {name: torch.from_numpy(z[f"p{i}"]).to(device=dev,
                                                        dtype=dt)
                  for i, name in enumerate(BASE_LEAVES)}
    lay = {name[len("layers."):]: t for name, t in leaves.items()
           if name.startswith("layers.")}
    return LlamaParams(embed=leaves["embed"], layers=LlamaLayerParams(**lay),
                       final_norm=leaves["final_norm"],
                       lm_head=leaves["lm_head"])


def load_draft(path: str, embed: torch.Tensor, dtype) -> EagleParams:
    """EagleParams from save_draft leaves in `dtype`, on embed's device
    (fields absent in the file, e.g. w_out for a full-width draft, stay
    None)."""
    with np.load(path) as z:
        return EagleParams(embed=embed, **{
            f: (torch.from_numpy(z[f]).to(device=embed.device, dtype=dtype)
                if f in z.files else None)
            for f in DRAFT_FIELDS})
