"""Fused draft-head scoring: top-k of log_softmax(x @ head) — the CUDA
kernel's wrapper, its plan and its plain PyTorch version.

Port of `flowspec_tpu/ops/head_topk.py:90 _kernel` / `:125
_head_topk_call` / `:242 head_topk`: values are top-k log-probs, indices the
token ids, ties broken by the lowest id (`jax.lax.top_k`'s order). For an
int8 head, a CUDA tensor launches `csrc/head_topk.cu` by `head_plan` (the
dequant-matmul skeleton's wgmma main loop, one block per 128-column strip,
per-strip softmax partials and top-k, a merge launched as a programmatic
dependent) or raises, and a CPU tensor runs `head_topk_plain`.
`head_topk_strip` is the earlier kernel of the same library, kept for
comparison only: nothing on the serving path calls it. A bf16 head has no
kernel in the JAX package (`head_topk.py:253`) and stays plain PyTorch here
too.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from flowspec_tpu_torch.ops import _build
from flowspec_tpu_torch.ops.quant import Int8Tensor, matmul_f32_out
from flowspec_tpu_torch.ops.quant_matmul import WGMMA_STAGES, smem_bytes

COLS_PER_BLOCK = 128
HEAD_WIDTHS = (16, 64)     # rows of x a block covers (instantiated)


class HeadPlan(NamedTuple):
    """How the head kernel cuts (T, H) x (H, V): `strips` blocks of 128
    columns per row tile, `row_tiles` tiles of `n` rows (the wgmma width),
    `ksplit` K splits of `chunk` 64-row blocks (one split: a strip's sum
    never crosses blocks), a ring of `stages` tiles in `smem` bytes of
    dynamic shared memory."""
    strips: int
    n: int
    row_tiles: int
    ksplit: int
    chunk: int
    stages: int
    smem: int


@lru_cache(maxsize=None)
def head_plan(t: int, h: int, v: int) -> HeadPlan:
    """The plan for T = t rows: width 16 up to 16 rows (the root's T 1, the
    beam's T 10), 64 above, row tiles of 64 past 64 rows; the ring of that
    width; one K split. At V 32000 the 250 strips already put about two
    blocks on every SM of the 132; joining the K splits of a strip would need
    a cluster, for shapes far from filling the card (V 2176: 17 strips)."""
    if t < 1 or h < 64 or h % 64 or v % COLS_PER_BLOCK:
        raise ValueError(f"head_plan needs T >= 1, H % 64 == 0 and "
                         f"V % {COLS_PER_BLOCK} == 0, got T={t} H={h} V={v}")
    n = next((w for w in HEAD_WIDTHS if w >= t), HEAD_WIDTHS[-1])
    stages = WGMMA_STAGES[n]
    return HeadPlan(strips=v // COLS_PER_BLOCK, n=n, row_tiles=-(-t // n),
                    ksplit=1, chunk=h // 64, stages=stages,
                    smem=smem_bytes(n, stages, "int8"))


def head_logits(x: torch.Tensor, head) -> torch.Tensor:
    """(..., H) @ head -> (..., V) float32 (`flowspec_tpu/draft/beam.py:30`):
    products of x's dtype summed in f32; an int8 head is cast to x's dtype
    (exact) and scaled after the sum. A plain head on the card takes one
    GEMM with f32 output and no f32 copy of the head
    (`ops/quant.py matmul_f32_out`)."""
    if isinstance(head, Int8Tensor):
        y = torch.matmul(x.float(), head.q.to(x.dtype).float())
        return y * head.scale
    return matmul_f32_out(x, head.to(x.dtype))


def topk_log_softmax(logits: torch.Tensor, k: int):
    """(T, V) f32 -> (logp (T, k), tok (T, k) int32), ties to the lowest
    index (a stable descending sort keeps equal values in index order)."""
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :k] - lse, idx[:, :k].to(torch.int32)


def head_topk_plain(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    k: int):
    return topk_log_softmax(head_logits(x2, Int8Tensor(q=q, scale=scale)), k)


def _check_head(name, x2, q, scale, k):
    t, h = x2.shape
    if q.dim() != 2 or q.shape[0] != h or tuple(scale.shape) != (q.shape[1],):
        raise ValueError(f"{name}: shape mismatch x{tuple(x2.shape)} "
                         f"q{tuple(q.shape)} scale{tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: q {q.dtype}, scale {scale.dtype}")
    if not 1 <= k <= min(COLS_PER_BLOCK, q.shape[1]):
        raise ValueError(f"{name}: k={k} out of range")


def head_topk_int8(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   k: int):
    """x2 (T, H) @ (q (H, V) int8 * scale (V,)) -> top-k of log_softmax:
    (logp (T, k) f32, tok (T, k) int32)."""
    _check_head("head_topk", x2, q, scale, k)
    if x2.device.type == "cpu":
        return head_topk_plain(x2, q, scale, k)
    return _launch(x2, q, scale, k)


def head_topk_strip(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    k: int):
    """The same scoring through the earlier kernel (the mma.sync main loop,
    a merge with a __syncthreads tree per round). For comparison only."""
    _check_head("head_topk_strip", x2, q, scale, k)
    if x2.device.type == "cpu":
        return head_topk_plain(x2, q, scale, k)
    return _launch(x2, q, scale, k, strip=True)


head_topk_strip.launches = 0


def _launch(x2, q, scale, k, strip=False):
    name = "head_topk_strip" if strip else "head_topk"
    t, h = x2.shape
    v = q.shape[1]
    if not (x2.is_cuda and q.device == x2.device
            and scale.device == x2.device):
        raise ValueError(f"{name}: x, q and scale must share one device")
    _build.refuse_grad(name, x2, q, scale)
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 x, got {x2.dtype}")
    if h % 64 or v % COLS_PER_BLOCK:
        raise ValueError(f"{name} kernel needs H % 64 == 0 and "
                         f"V % {COLS_PER_BLOCK} == 0, got H={h} V={v}")
    if not (q.is_contiguous() and scale.is_contiguous()
            and q.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0):
        raise ValueError(f"{name} kernel needs contiguous, 16-byte aligned "
                         "q and scale")
    x2 = _build.aligned16(x2)
    nblk = v // COLS_PER_BLOCK
    dev = x2.device
    part_m = torch.empty((t, nblk), dtype=torch.float32, device=dev)
    part_s = torch.empty((t, nblk), dtype=torch.float32, device=dev)
    logp = torch.empty((t, k), dtype=torch.float32, device=dev)
    tok = torch.empty((t, k), dtype=torch.int32, device=dev)
    stream = _build.stream_ptr(dev)
    if strip:
        part_val = torch.empty((t, nblk, k), dtype=torch.float32, device=dev)
        part_idx = torch.empty((t, nblk, k), dtype=torch.int32, device=dev)
        fn = _build.bind(name, 9, 4, lib="head_topk")
        args = (part_val.data_ptr(), part_idx.data_ptr(), part_m.data_ptr(),
                part_s.data_ptr(), logp.data_ptr(), tok.data_ptr(),
                t, h, v, k)
    else:
        plan = head_plan(t, h, v)
        # order keys: (T, k, strips) u64
        part_key = torch.empty((t, k, nblk), dtype=torch.int64, device=dev)
        fn = _build.bind(name, 8, 6)
        args = (part_key.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
                logp.data_ptr(), tok.data_ptr(), t, h, v, k, plan.n,
                plan.stages)
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), *args, stream)
    _build.check(err, name)
    (head_topk_strip if strip else head_topk).launches += 1
    return logp, tok


def head_topk(x: torch.Tensor, head, k: int):
    """x (..., H) -> (logp (..., k) f32, tokens (..., k) int32): the top-k
    of log_softmax(x @ head) per row — the beam's per-level scoring
    primitive (ref eagle/cnets.py:764-819)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if isinstance(head, Int8Tensor):
        lp, tok = head_topk_int8(x2, head.q, head.scale, k)
    else:
        lp, tok = topk_log_softmax(head_logits(x2, head), k)
    return lp.reshape(*shape[:-1], k), tok.reshape(*shape[:-1], k)


head_topk.launches = 0
