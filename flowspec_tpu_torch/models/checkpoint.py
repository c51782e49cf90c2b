"""Parameter and engine-state checkpoints in the JAX package's format.

Port of `flowspec_tpu/models/checkpoint.py`, on the same disk layout, so a
checkpoint saved by either package loads in the other: a directory of
`.npy` leaves and a `manifest.json` that records the dataclass tree by
class and field names ({"__class__", "fields"}, {"__leaf__": name},
{"__none__": true}). bfloat16 leaves are stored as their uint16 bits in
`<name>.bf16.npy`. The class names map to the port's classes of the same
name (`LlamaParams`, `LlamaLayerParams`, `MixtralParams`,
`MixtralLayerParams`, `EagleParams`, `Int8Tensor`, `NF4Tensor`,
`Int4Tensor`, `KVCache`, `EngineState`); the JAX pipeline's `PipeState`
has no counterpart until the pipeline is ported, and is refused.

An engine state's 0-d lengths are saved as 0-d int32 leaves, and its
sampling generator as the bytes of `torch.Generator.get_state()` (field
`generator`); it loads on a device of the type it was saved from. A state
saved by the JAX package carries a PRNG key (field `key`, its raw uint32
key data) instead: it seeds a fresh generator, so a greedy state resumes
token for token, while `jax.random`'s draws of a stochastic one are not
reproduced.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from flowspec_tpu_torch.draft.eagle import EagleParams
from flowspec_tpu_torch.models.kv_cache import KVCache
from flowspec_tpu_torch.models.llama import LlamaLayerParams, LlamaParams
from flowspec_tpu_torch.models.mixtral import (
    MixtralLayerParams, MixtralParams,
)
from flowspec_tpu_torch.ops.quant import Int4Tensor, Int8Tensor, NF4Tensor


def _classes() -> dict:
    # imported here: the engine imports the models package
    from flowspec_tpu_torch.runtime.engine import EngineState
    return {c.__name__: c for c in (
        LlamaParams, LlamaLayerParams, MixtralParams, MixtralLayerParams,
        EagleParams, Int4Tensor, Int8Tensor, NF4Tensor, KVCache,
        EngineState)}


def _encode(obj, leaves: dict, prefix: str):
    if obj is None:
        return {"__none__": True}
    if type(obj).__name__ in _classes() and dataclasses.is_dataclass(obj):
        return {"__class__": type(obj).__name__,
                "fields": {f.name: _encode(getattr(obj, f.name), leaves,
                                           f"{prefix}.{f.name}")
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, torch.Generator):
        obj = obj.get_state()
    leaves[prefix] = obj.detach().cpu().contiguous()
    return {"__leaf__": prefix}


def _decode(node, load_leaf, device):
    if "__none__" in node:
        return None
    if "__leaf__" in node:
        return load_leaf(node["__leaf__"]).to(device)
    name = node["__class__"]
    classes = _classes()
    if name not in classes:
        raise ValueError(f"checkpoint: no counterpart of {name} in the port")
    fields = dict(node["fields"])
    gen = key = None
    if name == "EngineState":
        # the sampling generator: the port's saved state, or a JAX key
        gen, key = fields.pop("generator", None), fields.pop("key", None)
    out = {k: _decode(v, load_leaf, device) for k, v in fields.items()}
    if name == "EngineState":
        out["generator"] = _generator(gen, key, load_leaf, device)
    return classes[name](**out)


def _generator(gen, key, load_leaf, device) -> torch.Generator:
    g = torch.Generator(device=device)
    if gen is not None:
        g.set_state(load_leaf(gen["__leaf__"]))
    elif key is not None:
        words = load_leaf(key["__leaf__"]).reshape(-1).tolist()
        seed = 0
        for w in words:
            seed = (seed << 32 | (w & 0xFFFFFFFF)) & (2 ** 63 - 1)
        g.manual_seed(seed)
    return g


def save_params(params, out_dir: str) -> None:
    """Write `params` (any tree of the classes above) under `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    leaves: dict = {}
    manifest = _encode(params, leaves, "p")
    for name, t in leaves.items():
        if t.dtype == torch.bfloat16:
            np.save(os.path.join(out_dir, name + ".bf16.npy"),
                    t.view(torch.int16).numpy().view(np.uint16))
        else:
            np.save(os.path.join(out_dir, name + ".npy"), t.numpy())
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _load_leaf(out_dir: str):
    def load(name: str) -> torch.Tensor:
        bf16 = os.path.join(out_dir, name + ".bf16.npy")
        if os.path.exists(bf16):
            bits = np.load(bf16).view(np.int16)
            return torch.from_numpy(np.ascontiguousarray(bits)).view(
                torch.bfloat16)
        return torch.from_numpy(np.load(os.path.join(out_dir, name + ".npy")))
    return load


def load_params(out_dir: str, device=None):
    """Read a tree written by either package's `save_params`, its tensors
    on `device` (`cuda` unless named)."""
    from flowspec_tpu_torch.runtime.engine import resolve_device
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return _decode(manifest, _load_leaf(out_dir), resolve_device(device))


def save_state(state, out_dir: str) -> None:
    """Persist a mid-generation `EngineState` (KV caches, pending draft
    pairs, lengths, the sampling generator) for resume."""
    save_params(state, out_dir)


def load_state(out_dir: str, device=None):
    """An `EngineState` saved by the port's or the JAX package's
    `save_state` (see the module's note on the generator)."""
    return load_params(out_dir, device)
