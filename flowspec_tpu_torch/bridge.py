"""Parameters and caches from the JAX package, given as numpy, to the port.

The JAX package's containers, turned into nested dicts of numpy arrays by
the caller (`dataclasses.asdict(jax.tree_util.tree_map(np.asarray, p))`),
become the port's dataclasses of torch tensors with the same layouts: (In,
Out) weights, stacked (L, ...) layers, (L, B, nkv, S, D) KV. A quantized
weight is a dict {"kind", "q", "scale"} with kind "int8", "nf4" or "int4":
the two packed 4-bit containers have the same fields, dtypes and shapes, so
the caller, who knows the JAX class, names the kind. This module imports no
JAX: the tests do the JAX -> numpy step.

Lane states: the JAX package stacks B lanes' states in front ((B, L, 1, H,
S, D) KV, (B,) lengths, (B, 1, CTX, H) pending hiddens); the port keeps the
lane inside the cache ((L, B, H, S, D) KV, (B,) lengths) and the pending
hiddens as (B, CTX, H). `lane_state` turns the one into the other and
`lane_state_numpy` back.

Pipeline states: the JAX `PipeState` holds its KV in the padded slot layout
of the engine's layer split (p * max(split) slots); `pipe_state` keeps the
L real layers, as the port's `PipeState` does.

Every function builds on the engine's device: `cuda` unless the caller
names another (`device="cpu"` for the plain PyTorch versions of the
kernels); without a card the default raises (`runtime/engine.py
resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from flowspec_tpu_torch.draft.eagle import EagleParams
from flowspec_tpu_torch.models.kv_cache import KVCache, device_scalar
from flowspec_tpu_torch.models.llama import LlamaLayerParams, LlamaParams
from flowspec_tpu_torch.models.mixtral import (
    MixtralLayerParams, MixtralParams,
)
from flowspec_tpu_torch.ops.quant import Int4Tensor, Int8Tensor, NF4Tensor
from flowspec_tpu_torch.runtime.engine import resolve_device

CONTAINERS = {"int8": Int8Tensor, "nf4": NF4Tensor, "int4": Int4Tensor}


def tensor(a, device=None) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch on `device`, always a copy:
    the port updates caches in place, and arrays from JAX are read-only."""
    device = resolve_device(device)
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def weight(w, device=None):
    """A plain array, or a {"kind", "q", "scale"} dict -> its container. A
    dict without "kind" is taken as int8 only if q is int8; a kind-less
    uint8 q could be nf4 or int4 and is refused (never guessed from values).
    """
    if not isinstance(w, dict):
        return None if w is None else tensor(w, device)
    if set(w) - {"kind"} != {"q", "scale"}:
        raise ValueError(f"bridge: weight container with keys {sorted(w)}")
    q = np.asarray(w["q"])
    kind = w.get("kind")
    if kind is None:
        if q.dtype != np.int8:
            raise ValueError(
                f"bridge: a {q.dtype} q without \"kind\" may be nf4 or int4; "
                "name the container kind")
        kind = "int8"
    if kind not in CONTAINERS:
        raise ValueError(f"bridge: container kind {kind!r} not in "
                         f"{sorted(CONTAINERS)}")
    if q.dtype != (np.int8 if kind == "int8" else np.uint8):
        raise TypeError(f"bridge: {kind} container with {q.dtype} q")
    device = resolve_device(device)
    return CONTAINERS[kind](q=tensor(q, device),
                            scale=tensor(w["scale"], device))


def llama_params(d: dict, device=None) -> LlamaParams:
    device = resolve_device(device)
    lp = d["layers"]
    layers = LlamaLayerParams(**{
        f: weight(lp.get(f), device)
        for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "input_ln", "post_ln", "bq", "bk", "bv")})
    return LlamaParams(embed=tensor(d["embed"], device), layers=layers,
                       final_norm=tensor(d["final_norm"], device),
                       lm_head=tensor(d["lm_head"], device))


def mixtral_params(d: dict, device=None) -> MixtralParams:
    device = resolve_device(device)
    layers = MixtralLayerParams(**{
        f: tensor(v, device) for f, v in d["layers"].items()})
    return MixtralParams(embed=tensor(d["embed"], device), layers=layers,
                         final_norm=tensor(d["final_norm"], device),
                         lm_head=tensor(d["lm_head"], device))


def eagle_params(d: dict, device=None) -> EagleParams:
    device = resolve_device(device)
    return EagleParams(**{k: weight(v, device) for k, v in d.items()})


def kv_cache(d: dict, device=None) -> KVCache:
    device = resolve_device(device)
    return KVCache(k=tensor(d["k"], device), v=tensor(d["v"], device),
                   length=device_scalar(int(d["length"]), device))


def lane_cache(d: dict, device=None) -> KVCache:
    """A JAX lane-stacked cache {"k", "v": (B, L, 1, H, S, D), "length":
    (B,)} as the port's (L, B, H, S, D) lane cache with (B,) lengths."""
    device = resolve_device(device)
    k = np.asarray(d["k"])
    move = lambda a: np.moveaxis(np.asarray(a)[:, :, 0], 0, 1)
    return KVCache(k=tensor(move(k), device), v=tensor(move(d["v"]), device),
                   length=tensor(np.asarray(d["length"], np.int32), device))


def lane_state(d: dict, seeds=None, device=None):
    """A JAX lane-stacked `EngineState` (numpy dict; its "key" is ignored)
    as the port's lane `EngineState`, each lane's draw stream seeded from
    `seeds` (default 0, 1, ...)."""
    from flowspec_tpu_torch.runtime.engine import EngineState
    from flowspec_tpu_torch.tree.sampling import lane_rng
    device = resolve_device(device)
    i32 = lambda a: tensor(np.asarray(a, np.int32), device)
    b = np.asarray(d["commit_len"]).shape[0]
    seeds = list(range(b)) if seeds is None else list(seeds)
    return EngineState(
        base_cache=lane_cache(d["base_cache"], device),
        draft_cache=lane_cache(d["draft_cache"], device),
        commit_len=i32(d["commit_len"]), root_token=i32(d["root_token"]),
        pending_tokens=i32(d["pending_tokens"]),
        pending_hidden=tensor(np.asarray(d["pending_hidden"])[:, 0], device),
        n_pending=i32(d["n_pending"]),
        root_hidden=tensor(d["root_hidden"], device),
        rng=lane_rng(torch.tensor(seeds).to(device)))


def lane_state_numpy(state) -> dict:
    """A port lane `EngineState` in the JAX package's lane-stacked layout,
    as numpy (no "key": the draw streams have no JAX counterpart)."""
    def arr(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def cache(c: KVCache) -> dict:
        stack = lambda x: np.moveaxis(arr(x), 1, 0)[:, :, None]
        return {"k": stack(c.k), "v": stack(c.v), "length": arr(c.length)}
    return {"base_cache": cache(state.base_cache),
            "draft_cache": cache(state.draft_cache),
            "commit_len": arr(state.commit_len),
            "root_token": arr(state.root_token),
            "pending_tokens": arr(state.pending_tokens),
            "pending_hidden": arr(state.pending_hidden)[:, None],
            "n_pending": arr(state.n_pending),
            "root_hidden": arr(state.root_hidden)}


def pipe_state(d: dict, layer_split, seed: int = 0, device=None):
    """A JAX `PipeState` (numpy dict; its "key" is ignored) as the port's,
    the KV taken out of the slot layout of `layer_split` and the draw
    stream seeded from `seed`."""
    from flowspec_tpu_torch.parallel.pipeline import PipeState, from_slots
    from flowspec_tpu_torch.tree.sampling import lane_rng
    device = resolve_device(device)
    i32 = lambda a: tensor(np.asarray(a, np.int32), device)
    kv = kv_cache(d["kv"], device)
    return PipeState(
        kv=KVCache(k=from_slots(kv.k, layer_split),
                   v=from_slots(kv.v, layer_split), length=kv.length),
        draft_cache=kv_cache(d["draft_cache"], device),
        commit_len=i32(d["commit_len"]), root_token=i32(d["root_token"]),
        pend_tok=i32(d["pend_tok"]), pend_hid=tensor(d["pend_hid"], device),
        pend_n=i32(d["pend_n"]),
        rng=lane_rng(torch.full((1,), seed, dtype=torch.int64,
                                device=device)))
