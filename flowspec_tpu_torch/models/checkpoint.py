"""Parameter and engine-state checkpoints in the JAX package's format.

Port of `flowspec_tpu/models/checkpoint.py`, on the same disk layout, so a
checkpoint saved by either package loads in the other: a directory of
`.npy` leaves and a `manifest.json` that records the dataclass tree by
class and field names ({"__class__", "fields"}, {"__leaf__": name},
{"__none__": true}). bfloat16 leaves are stored as their uint16 bits in
`<name>.bf16.npy`. The class names map to the port's classes of the same
name (`LlamaParams`, `LlamaLayerParams`, `MixtralParams`,
`MixtralLayerParams`, `EagleParams`, `Int8Tensor`, `NF4Tensor`,
`Int4Tensor`, `KVCache`, `EngineState`, `PipeState`).

An engine state is saved with its lane axis ((B,) lengths) and its draw
streams (field `rng`, (B, 2) int64). A one-request state saved by the JAX
package has 0-d lengths and a PRNG key (field `key`, its raw uint32 key
data) instead, and a port state saved before the lane axis has 0-d lengths
and the bytes of a `torch.Generator` state (field `generator`): either
loads as one lane whose draw stream is seeded from those words, so a greedy
state resumes token for token, while the draws of a stochastic one are not
reproduced.

A pipeline state (`PipeState`) keeps the JAX package's padded slot layout
on disk: its KV stack has p * max(split) layer slots, stage s's layers at
slots [s * max(split), s * max(split) + split[s]) and zeros in the rest
(`flowspec_tpu/parallel/pipeline.py:128-157`), where the port holds the L
layers alone. So saving and loading one needs the engine's `layer_split`
(`PipelineEngine.layer_split`). A JAX-saved one has a PRNG key (field
`key`) that seeds the port's draw stream, as for an engine state.
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
from flowspec_tpu_torch.tree.sampling import lane_rng


def _classes() -> dict:
    # imported here: the engines import the models package
    from flowspec_tpu_torch.parallel.pipeline import PipeState
    from flowspec_tpu_torch.runtime.engine import EngineState
    return {c.__name__: c for c in (
        LlamaParams, LlamaLayerParams, MixtralParams, MixtralLayerParams,
        EagleParams, Int4Tensor, Int8Tensor, NF4Tensor, KVCache,
        EngineState, PipeState)}


def _encode(obj, leaves: dict, prefix: str):
    if obj is None:
        return {"__none__": True}
    if type(obj).__name__ in _classes() and dataclasses.is_dataclass(obj):
        return {"__class__": type(obj).__name__,
                "fields": {f.name: _encode(getattr(obj, f.name), leaves,
                                           f"{prefix}.{f.name}")
                           for f in dataclasses.fields(obj)}}
    leaves[prefix] = obj.detach().cpu().contiguous()
    return {"__leaf__": prefix}


def _decode(node, load_leaf, device, layer_split=None):
    if "__none__" in node:
        return None
    if "__leaf__" in node:
        return load_leaf(node["__leaf__"]).to(device)
    name = node["__class__"]
    classes = _classes()
    if name not in classes:
        raise ValueError(f"checkpoint: no counterpart of {name} in the port")
    if name == "PipeState" and layer_split is None:
        raise ValueError("checkpoint: a PipeState loads with the engine's "
                         "layer_split (its KV is in the padded slot layout)")
    fields = dict(node["fields"])
    seed_words = None
    if name in ("EngineState", "PipeState"):
        # a JAX key, or an earlier port state's generator bytes
        key, gen = fields.pop("key", None), fields.pop("generator", None)
        seed_words = key if key is not None else gen
    out = {k: _decode(v, load_leaf, device) for k, v in fields.items()}
    if name == "EngineState":
        out = _one_lane(out, seed_words, load_leaf, device)
    if name == "PipeState":
        from flowspec_tpu_torch.parallel.pipeline import from_slots
        kv = out["kv"]
        out["kv"] = KVCache(k=from_slots(kv.k, layer_split),
                            v=from_slots(kv.v, layer_split),
                            length=kv.length)
        if "rng" not in out:
            out["rng"] = _seeded_rng(seed_words, load_leaf, device)
    return classes[name](**out)


def _seeded_rng(seed_words, load_leaf, device) -> torch.Tensor:
    """A one-lane draw stream seeded from the words of `seed_words` (a
    leaf: a JAX key's data, or generator bytes); seed 0 without one."""
    seed = 0
    if seed_words is not None:
        for w in load_leaf(seed_words["__leaf__"]).reshape(-1).tolist():
            seed = (seed * 0x100000001B3 ^ (w & 0xFFFFFFFF)) & (2 ** 63 - 1)
    return lane_rng(torch.full((1,), seed, dtype=torch.int64, device=device))


def _one_lane(f: dict, seed_words, load_leaf, device) -> dict:
    """An engine state's fields with its lane axis: a one-request state
    (0-d lengths) becomes one lane, with a draw stream seeded from the
    words of `seed_words` (a leaf) when it has no `rng`."""
    if f["commit_len"].dim() == 0:
        one = lambda x: x.reshape(1)
        for c in ("base_cache", "draft_cache"):
            f[c] = f[c].with_length(one(f[c].length))
        for k in ("commit_len", "root_token", "n_pending"):
            f[k] = one(f[k])
        f["pending_tokens"] = f["pending_tokens"][None]
        f["root_hidden"] = f["root_hidden"][None]
    if "rng" not in f:
        f["rng"] = _seeded_rng(seed_words, load_leaf, device)
    return f


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


def load_params(out_dir: str, device=None, layer_split=None):
    """Read a tree written by either package's `save_params`, its tensors
    on `device` (`cuda` unless named); a `PipeState` needs `layer_split`."""
    from flowspec_tpu_torch.runtime.engine import resolve_device
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return _decode(manifest, _load_leaf(out_dir), resolve_device(device),
                   layer_split)


def save_state(state, out_dir: str, layer_split=None) -> None:
    """Persist a mid-generation `EngineState` or `PipeState` (KV caches,
    pending draft pairs, lengths, the draw streams) for resume; a
    `PipeState` is written in the padded slot layout of `layer_split`."""
    from flowspec_tpu_torch.parallel.pipeline import PipeState, to_slots
    if isinstance(state, PipeState):
        if layer_split is None:
            raise ValueError("checkpoint: a PipeState saves with the "
                             "engine's layer_split")
        kv = state.kv
        state = dataclasses.replace(state, kv=KVCache(
            k=to_slots(kv.k, layer_split), v=to_slots(kv.v, layer_split),
            length=kv.length))
    save_params(state, out_dir)


def load_state(out_dir: str, device=None, layer_split=None):
    """An `EngineState` or `PipeState` saved by the port's or the JAX
    package's `save_state` (see the module's notes on the draw streams and
    on the slot layout)."""
    return load_params(out_dir, device, layer_split)
