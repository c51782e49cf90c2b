"""Tree-masked latent attention (MLA, absorbed form): the CUDA kernel's
wrapper and its plain PyTorch version.

DeepSeek-V3's attention (`models/deepseek.py`) caches one latent row a
token and layer: the normed c_kv (kv_lora_rank values) followed by the
roped k_pe. With q_nope absorbed through kv_b's key half, each of the
heads' queries is a row as wide as the latent row, every head's keys are
the latent rows and its values their first `v_dim` columns; kv_b's value
half is applied to the output by the caller. So all heads of a lane share
one (S, C) key matrix and one (T, S) bias, which the GQA kernel
(`ops/tree_attention.py`, one head dim shared by K and V, D in (64, 128))
does not compute.

On a CUDA tensor `mla_attention` launches `csrc/mla_attention.cu` (bf16,
C = 576, v_dim = 512); on the CPU it runs `mla_attention_plain`. As in
`tree_attention`: `n_valid` is a host int, a 0-d tensor or one a lane on
q's device, columns at or past it carry a -1e9 bias, and a tensor n_valid
is read by the kernel on the card, so a replayed CUDA graph follows each
round; the plain version reads whole 256-row blocks.
"""

from __future__ import annotations

import torch

from flowspec_tpu_torch.ops import _build
from flowspec_tpu_torch.ops.tree_attention import KV_BLOCK, live_keys

KEY_TILE = 64          # keys a tile of the kernel
KERNEL_C = 576         # the latent row the kernel is built for
KERNEL_DV = 512        # and its value columns


def mla_attention_plain(q, latent, bias, n_valid=None, scale=None,
                        v_dim: int = KERNEL_DV):
    """q (B, nh, T, C), latent (B, S, C), bias (T, S) or (B, T, S): f32
    scores over the live rows `live_keys` gives, softmax, probs cast to q's
    dtype before PV, f32 accumulation over the first `v_dim` columns of
    the latent rows, cast last. -> (B, nh, T, v_dim)."""
    n_keys = live_keys(latent.shape[1], n_valid)
    kv = latent[:, None, :n_keys].float()                  # (B, 1, S', C)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.matmul(q.float(), kv.transpose(-1, -2)) * scale
    lane_bias = bias[None] if bias.dim() == 2 else bias
    scores = scores + lane_bias[:, None, :, :n_keys].float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), kv[..., :v_dim]).to(q.dtype)


def _check(q, latent, bias, v_dim):
    if q.dim() != 4 or latent.dim() != 3 or latent.shape[0] != q.shape[0] \
            or latent.shape[-1] != q.shape[-1] or v_dim > q.shape[-1]:
        raise ValueError(f"mla_attention: bad shapes q{tuple(q.shape)} "
                         f"latent{tuple(latent.shape)} v_dim {v_dim}")
    b, _, t, _ = q.shape
    s_max = latent.shape[1]
    if tuple(bias.shape) not in ((t, s_max), (b, t, s_max)) \
            or bias.dtype != torch.float32:
        raise ValueError(f"mla_attention: bias must be ({t}, {s_max}) or "
                         f"({b}, {t}, {s_max}) f32, got {tuple(bias.shape)} "
                         f"{bias.dtype}")


def mla_attention(q: torch.Tensor, latent: torch.Tensor, bias: torch.Tensor,
                  n_valid=None, scale: float | None = None,
                  v_dim: int = KERNEL_DV) -> torch.Tensor:
    """q (B, nh, T, C) absorbed queries; latent (B, S, C) rows, B lanes;
    bias (T, S) or (B, T, S) f32; n_valid: live rows, a host int, a 0-d
    tensor or a (B,) int tensor on q's device (None = all S); `scale` the
    softmax scale (default C^-1/2). Returns (B, nh, T, v_dim)."""
    _check(q, latent, bias, v_dim)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return mla_attention_plain(q, latent, bias, n_valid, scale, v_dim)
    b, nh, t, c = q.shape
    s_max = latent.shape[1]
    name = "mla_attention"
    if not (latent.is_cuda and bias.is_cuda and latent.device == q.device
            and bias.device == q.device):
        raise ValueError(f"{name}: inputs must share one CUDA device")
    _build.refuse_grad(name, q, latent, bias)
    if q.dtype != torch.bfloat16 or latent.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 q and latent rows")
    if c != KERNEL_C or v_dim != KERNEL_DV or s_max % KV_BLOCK:
        raise ValueError(f"{name} kernel needs C {KERNEL_C}, v_dim "
                         f"{KERNEL_DV} and S % {KV_BLOCK} == 0, got C={c} "
                         f"v_dim={v_dim} S={s_max}")
    nv_ptr, n_keys = 0, s_max
    if isinstance(n_valid, torch.Tensor):
        if n_valid.numel() not in (1, b) or n_valid.dim() > 1 \
                or n_valid.device != q.device:
            raise ValueError(f"{name}: a tensor n_valid must be 0-d or "
                             f"({b},) on q's device, got "
                             f"{tuple(n_valid.shape)} on {n_valid.device}")
        n_valid = n_valid.reshape(-1).to(torch.int32).expand(b).contiguous()
        nv_ptr = n_valid.data_ptr()
    elif n_valid is not None:
        n_keys = min(s_max, max(1, -(-int(n_valid) // KEY_TILE)) * KEY_TILE)
    q, latent, bias = (_build.aligned16(x) for x in (q, latent, bias))
    out = torch.empty((b, nh, t, v_dim), dtype=q.dtype, device=q.device)
    fn = _build.bind(name, 5, 6, 1)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), latent.data_ptr(), bias.data_ptr(), nv_ptr,
                 out.data_ptr(), b, nh * t, t, s_max, n_keys,
                 int(bias.dim() == 2), scale, _build.stream_ptr(q.device))
    _build.check(err, name)
    mla_attention.launches += 1
    return out


mla_attention.launches = 0
