"""Weight-only quantization containers and the matmul entry point.

Port of `flowspec_tpu/ops/quant.py`: per-output-channel absmax int8, and the
two packed 4-bit block formats (NF4 with the bitsandbytes codebook, linear
int4 with levels -7..7), all with the JAX package's byte layout, so weights
quantized there load unchanged. `qmatmul` is the single entry point the
model layer calls; it dispatches on the container to the dequant-matmuls in
`ops/quant_matmul.py`, each of which launches its CUDA kernel for a CUDA
tensor (or raises) and runs its plain PyTorch version for a CPU tensor.
There is no dequantize-then-`matmul` path on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# bitsandbytes NF4 code values (functional.py `create_normal_map` output),
# the 16 quantiles of a standard normal scaled to [-1, 1].
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], dtype=np.float32)

NF4_BLOCK = 64


@dataclasses.dataclass(frozen=True)
class Int8Tensor:
    """w ~= q * scale[..., None, :] — per-output-channel absmax.

    q (..., In, Out) int8; scale (..., Out) float32.
    """
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def in_features(self):
        return self.q.shape[-2]

    @property
    def out_features(self):
        return self.q.shape[-1]

    def __getitem__(self, i) -> "Int8Tensor":
        """Index the leading (layer) axis of a stacked weight."""
        return Int8Tensor(q=self.q[i], scale=self.scale[i])


@dataclasses.dataclass(frozen=True)
class _Packed4Tensor:
    """Two 4-bit codes per byte along In (byte i of a column = code(row 2i)
    << 4 | code(row 2i+1)), one f32 scale per NF4_BLOCK rows per column.

    q (..., In // 2, Out) uint8; scale (..., In // 64, Out) float32.
    """
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def in_features(self):
        return self.q.shape[-2] * 2

    @property
    def out_features(self):
        return self.q.shape[-1]

    def __getitem__(self, i):
        """Index the leading (layer) axis of a stacked weight."""
        return type(self)(q=self.q[i], scale=self.scale[i])


class NF4Tensor(_Packed4Tensor):
    """w ~= NF4_CODE[code] * scale[block] — blockwise absmax."""


class Int4Tensor(_Packed4Tensor):
    """w ~= (code - 8) * scale[block] — blockwise linear 4-bit, levels
    -7..7 (absmax / 7); code 0 (= -8) is never produced by `quantize_int4`."""


def quantize_int8(w: torch.Tensor) -> Int8Tensor:
    """(..., In, Out) -> per-out-channel symmetric int8 (`jnp.round` and
    `torch.round` both round half to even, so the bytes match the JAX
    package's `quantize_int8`)."""
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=-2, keepdim=True)              # (..., 1, Out)
    scale = absmax.clamp_min(1e-12) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return Int8Tensor(q=q, scale=scale.squeeze(-2))


def _blocks(w: torch.Tensor, block: int):
    *lead, n_in, n_out = w.shape
    if n_in % block:
        raise ValueError(f"In = {n_in} is not a multiple of the {block}-row "
                         "quantization block")
    wf = w.to(torch.float32).reshape(*lead, n_in // block, block, n_out)
    return wf, wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)


def quantize_nf4(w: torch.Tensor, block: int = NF4_BLOCK) -> NF4Tensor:
    """(..., In, Out) -> blockwise NF4, packed 2 codes/byte along In. Nearest
    codebook entry by a search on the midpoints; an exact midpoint goes to
    the lower code (`side="left"` in the JAX package)."""
    wf, scale = _blocks(w, block)
    mids = torch.from_numpy((NF4_CODE[1:] + NF4_CODE[:-1]) * np.float32(0.5))
    idx = torch.searchsorted(mids.to(wf.device), (wf / scale).contiguous(),
                             right=False).to(torch.uint8)
    return NF4Tensor(q=pack_nf4(idx.reshape(w.shape)),
                     scale=scale.squeeze(-2))


def quantize_int4(w: torch.Tensor, block: int = NF4_BLOCK) -> Int4Tensor:
    """(..., In, Out) -> blockwise linear int4 (levels -7..7, absmax/7,
    round half to even), packed 2 codes/byte along In."""
    wf, absmax = _blocks(w, block)
    scale = absmax / 7.0
    idx = (torch.round(wf / scale).clamp(-7, 7).to(torch.int32) + 8).to(
        torch.uint8)
    return Int4Tensor(q=pack_nf4(idx.reshape(w.shape)),
                      scale=scale.squeeze(-2))


def pack_nf4(idx: torch.Tensor) -> torch.Tensor:
    """(..., In, Out) uint8 codes 0..15 -> (..., In//2, Out) packed bytes."""
    *lead, n_in, n_out = idx.shape
    pairs = idx.reshape(*lead, n_in // 2, 2, n_out)
    return ((pairs[..., 0, :] << 4) | pairs[..., 1, :]).to(torch.uint8)


def unpack_nf4(q: torch.Tensor) -> torch.Tensor:
    """(..., In//2, Out) packed bytes -> (..., In, Out) uint8 codes."""
    *lead, half, n_out = q.shape
    return torch.stack([q >> 4, q & 0xF], dim=-2).reshape(
        *lead, half * 2, n_out)


def dequantize(w) -> torch.Tensor:
    """Reference dequant (f32). The 4-bit kernels and their plain versions
    decode in bf16 instead (`ops/quant_matmul.py`), as the TPU kernels do."""
    if isinstance(w, Int8Tensor):
        return w.q.to(torch.float32) * w.scale[..., None, :]
    if isinstance(w, _Packed4Tensor):
        idx = unpack_nf4(w.q)
        *lead, n_in, n_out = idx.shape
        blocks = w.scale.shape[-2]
        if isinstance(w, NF4Tensor):
            vals = torch.from_numpy(NF4_CODE).to(idx.device)[idx.long()]
        else:
            vals = idx.to(torch.float32) - 8.0
        vals = vals.reshape(*lead, blocks, n_in // blocks, n_out)
        return (vals * w.scale[..., None, :]).reshape(*lead, n_in, n_out)
    if isinstance(w, torch.Tensor):
        return w.to(torch.float32)
    raise TypeError(f"dequantize: not a weight: {type(w).__name__}")


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., In) @ w (In, Out) for plain, int8, nf4 or int4 weights."""
    if isinstance(w, torch.Tensor):
        return x @ w
    from flowspec_tpu_torch.ops import quant_matmul as qm
    fn = {Int8Tensor: qm.int8_matmul, NF4Tensor: qm.nf4_matmul,
          Int4Tensor: qm.int4_matmul}.get(type(w))
    if fn is None:
        raise TypeError(f"qmatmul: not a weight: {type(w).__name__}")
    lead = x.shape[:-1]
    y = fn(x.reshape(1, -1, x.shape[-1]), w.q, w.scale)
    return y.reshape(*lead, w.out_features)


def matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., H) @ w (H, V) -> (..., V) float32 from products of w's
    dtype summed in f32. A CUDA tensor takes one GEMM that reads w as it
    is and writes f32 (`aten::mm.dtype`, a plain large product that the JAX
    package leaves to XLA too): casting w to f32 first would make an f32
    copy of the head on every call (0.52 GB at 7B), which a CUDA graph
    would hold in its pool for good. The CPU, which has no such
    GEMM, multiplies in f32 (the products of bf16 values are exact in
    f32), as does an f32 w."""
    if x.device.type == "cpu" or w.dtype == torch.float32:
        return torch.matmul(x.float(), w.float())
    lead = x.shape[:-1]
    y = torch.mm(x.reshape(-1, x.shape[-1]).to(w.dtype), w,
                 out_dtype=torch.float32)
    return y.reshape(*lead, w.shape[-1])
