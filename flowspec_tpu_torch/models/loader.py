"""HF checkpoint -> stacked params on the device.

Port of `flowspec_tpu/models/loader.py`, with a safetensors reader of its
own in place of the `safetensors` package: the format is an 8-byte
little-endian header length, a JSON header ({name: {dtype, shape,
data_offsets}}, plus an optional "__metadata__"), then the raw bytes. A
file is mapped copy-on-write (`np.memmap`), so a tensor is a view of the
page cache until it is copied; numpy has no bfloat16, so BF16 is read as
uint16 and viewed as `torch.bfloat16`.

The loaders never build a host copy of the model: each stacked (L, In,
Out) leaf is allocated on the target device and filled tensor by tensor,
each HF (out, in) weight copied to the device and transposed there.
`device` is `cuda` unless the caller names another.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from flowspec_tpu_torch.config import ModelConfig
from flowspec_tpu_torch.models.llama import LlamaLayerParams, LlamaParams
from flowspec_tpu_torch.runtime.engine import resolve_device

# safetensors dtype -> (numpy dtype of the raw bytes, torch dtype)
DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


class SafetensorsFile:
    """One .safetensors file: `keys()`, and `[name]` -> a CPU tensor that
    views the mapped file (a copy only where a tensor's offset is not a
    multiple of its element size)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.path = path
        self.header = header
        self._start = 8 + n
        self._mm = None

    def keys(self):
        return self.header.keys()

    def __contains__(self, name) -> bool:
        return name in self.header

    def __getitem__(self, name: str) -> torch.Tensor:
        info = self.header[name]
        np_dt, t_dt = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if self._mm is None:
            self._mm = np.memmap(self.path, dtype=np.uint8, mode="c")
        raw = self._mm[self._start + begin:self._start + end]
        if (self._start + begin) % np.dtype(np_dt).itemsize:
            raw = np.array(raw)
        arr = raw.view(np_dt).reshape(info["shape"])
        t = torch.from_numpy(arr)
        return t.view(t_dt) if t.dtype != t_dt else t


class Checkpoint:
    """The tensors of a checkpoint directory: the shards named by
    `model.safetensors.index.json`, else every `*.safetensors` file."""

    def __init__(self, model_dir: str):
        index = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            files = sorted(f for f in os.listdir(model_dir)
                           if f.endswith(".safetensors"))
            weight_map = None
        self.files = {f: SafetensorsFile(os.path.join(model_dir, f))
                      for f in files}
        self.name_to_file = weight_map or {
            name: f for f, h in self.files.items() for name in h.keys()}

    def keys(self):
        return self.name_to_file.keys()

    def __contains__(self, name) -> bool:
        return name in self.name_to_file

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.files[self.name_to_file[name]][name]


def tensor_to(src: torch.Tensor, dtype, device,
              transpose: bool = False) -> torch.Tensor:
    """`src` (a host tensor) as a new contiguous `dtype` tensor on
    `device`, transposed there if asked."""
    w = src.to(device)
    w = w.T if transpose else w
    return torch.empty(w.shape, dtype=dtype, device=device).copy_(w)


def stack_tensors(t, names: list, dtype, device,
                  transpose: bool) -> torch.Tensor:
    """The tensors `names` (a list, or a list of lists: layers x experts)
    stacked along new leading axes: allocated once on `device`, each filled
    from its own host tensor, transposed on the device if asked."""
    flat = [n for row in names for n in row] if isinstance(names[0], list) \
        else names
    first = t[flat[0]]
    shape = tuple(first.shape[::-1] if transpose else first.shape)
    lead = (len(names), len(names[0])) if len(flat) != len(names) \
        else (len(names),)
    out = torch.empty(lead + shape, dtype=dtype, device=device)
    for dst, name in zip(out.view(-1, *shape), flat):
        w = t[name].to(device)
        dst.copy_(w.T if transpose else w)
    return out


def load_model_config(model_dir: str) -> ModelConfig:
    """`config.json` -> ModelConfig (`flowspec_tpu/models/loader.py:52-72`):
    Qwen2 has qkv biases unless its config says otherwise."""
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    return ModelConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c.get("num_key_value_heads",
                                  c["num_attention_heads"]),
        head_dim=c.get("head_dim"),
        rms_norm_eps=c.get("rms_norm_eps", 1e-5),
        rope_theta=c.get("rope_theta", 10000.0),
        max_position_embeddings=c.get("max_position_embeddings", 2048),
        attention_bias=c.get("attention_bias",
                             c.get("model_type") == "qwen2"),
        tie_word_embeddings=c.get("tie_word_embeddings", False),
        num_local_experts=c.get("num_local_experts", 0),
        num_experts_per_tok=c.get("num_experts_per_tok", 2),
    )


def load_llama_params(model_dir: str, cfg: ModelConfig | None = None,
                      dtype=torch.bfloat16, device=None) -> LlamaParams:
    """A LLaMA / Vicuna / Qwen2 HF checkpoint as stacked params on `device`
    (`flowspec_tpu/models/loader.py:75-128`): (out, in) weights become (L,
    In, Out); qkv biases are read only when `cfg.attention_bias` (else
    None, the port's "no bias"); a tied config, or a checkpoint without
    `lm_head.weight`, takes the embedding's transpose as the head."""
    cfg = cfg or load_model_config(model_dir)
    t = Checkpoint(model_dir)
    device = resolve_device(device)
    pre = "model.layers.{}."
    n = cfg.num_hidden_layers

    def stack(name, transpose=False):
        return stack_tensors(t, [(pre + name).format(i) for i in range(n)],
                             dtype, device, transpose)

    def lin(name):
        return stack(name + ".weight", transpose=True)

    def bias(name):
        return stack(name + ".bias") if cfg.attention_bias else None

    layers = LlamaLayerParams(
        wq=lin("self_attn.q_proj"), wk=lin("self_attn.k_proj"),
        wv=lin("self_attn.v_proj"), wo=lin("self_attn.o_proj"),
        w_gate=lin("mlp.gate_proj"), w_up=lin("mlp.up_proj"),
        w_down=lin("mlp.down_proj"),
        input_ln=stack("input_layernorm.weight"),
        post_ln=stack("post_attention_layernorm.weight"),
        bq=bias("self_attn.q_proj"), bk=bias("self_attn.k_proj"),
        bv=bias("self_attn.v_proj"))
    tied = cfg.tie_word_embeddings or "lm_head.weight" not in t
    head = t["model.embed_tokens.weight" if tied else "lm_head.weight"]
    return LlamaParams(
        embed=tensor_to(t["model.embed_tokens.weight"], dtype, device),
        layers=layers,
        final_norm=tensor_to(t["model.norm.weight"], dtype, device),
        lm_head=tensor_to(head, dtype, device, transpose=True))
