"""How a drawn weight leaf becomes layer i's float32 matrix.

`exact` gives the values the benchmark drew: int8 codes times their column
scales, any other weight as it is. The others are the control's: the same
matrices computed in the precision below the configuration's own
(`LOWER`), each from `exact`'s values: blockwise int4 (absmax over 64 rows
of a column, levels -7..7) below int8; fp8 (e4m3, absmax per output
column), the H100's own next step, below bfloat16 (int8 per column is read
beside it). Vectors (norms, biases) stay exact.
"""

from __future__ import annotations

import torch

INT4_BLOCK = 64


def exact(leaf, i: int) -> torch.Tensor:
    if isinstance(leaf, dict):
        return leaf["q"][i].float() * leaf["scale"][i].float()[..., None, :]
    return leaf[i].float()


def _int8_columns(w: torch.Tensor) -> torch.Tensor:
    scale = w.abs().amax(-2, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(w / scale).clamp(-127, 127) * scale


def _int4_blocks(w: torch.Tensor) -> torch.Tensor:
    *lead, n_in, n_out = w.shape
    b = w.reshape(*lead, n_in // INT4_BLOCK, INT4_BLOCK, n_out)
    scale = b.abs().amax(-2, keepdim=True).clamp_min(1e-12) / 7.0
    return (torch.round(b / scale).clamp(-7, 7) * scale).reshape(w.shape)


def int4(leaf, i: int) -> torch.Tensor:
    """int8 weights as blockwise int4."""
    w = exact(leaf, i)
    return _int4_blocks(w) if isinstance(leaf, dict) else w


def _fp8_columns(w: torch.Tensor) -> torch.Tensor:
    scale = w.abs().amax(-2, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def fp8(leaf, i: int) -> torch.Tensor:
    """bfloat16 weight matrices as fp8 (e4m3) per output column."""
    w = exact(leaf, i)
    return _fp8_columns(w) if w.dim() >= 2 else w


def int8(leaf, i: int) -> torch.Tensor:
    """bfloat16 weight matrices as int8 per output column."""
    w = exact(leaf, i)
    return _int8_columns(w) if w.dim() >= 2 else w


# the configuration's stated weight precision -> the control's
LOWER = {"int8": int4, "bfloat16": fp8}
