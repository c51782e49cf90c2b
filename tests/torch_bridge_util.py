"""Helpers shared by the PyTorch-port parity tests: JAX containers -> numpy
dicts -> the port's containers (flowspec_tpu_torch.bridge)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flowspec_tpu.ops import quant as jq
from flowspec_tpu_torch import bridge


KINDS = {jq.Int8Tensor: "int8", jq.NF4Tensor: "nf4", jq.Int4Tensor: "int4"}


def to_numpy_dict(x):
    """A JAX dataclass pytree as nested dicts of numpy arrays; a quantized
    container carries its class as "kind" (nf4 and int4 have the same
    fields, so the bridge cannot tell them apart otherwise)."""
    if type(x) in KINDS:
        return {"kind": KINDS[type(x)], "q": np.asarray(x.q),
                "scale": np.asarray(x.scale)}
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy_dict(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return None if x is None else np.asarray(x)


def port_llama(params):
    return bridge.llama_params(to_numpy_dict(params), device="cpu")


def port_eagle(draft):
    return bridge.eagle_params(to_numpy_dict(draft), device="cpu")


def port_cache(cache):
    return bridge.kv_cache(to_numpy_dict(cache), device="cpu")


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


def port_mixtral(params):
    return bridge.mixtral_params(to_numpy_dict(params), device="cpu")
