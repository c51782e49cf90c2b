"""Tree-masked attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of `flowspec_tpu/ops/tree_attention.py:31 _attn_kernel` / `:65
tree_attention`, which also takes over the XLA length-aware path
(`flowspec_tpu/models/llama.py:128 _attention_blocked`): given `n_valid`,
the live KV rows, the plain version reads the first ceil(n_valid / 256)
blocks of 256 rows and the kernel the first ceil(n_valid / 64) tiles of 64.
Columns at or past n_valid must carry a -1e9 bias (every caller's bias
does), so the rows skipped would have contributed exactly 0.

On a CUDA tensor `tree_attention` launches `csrc/tree_attention.cu` (bf16)
by `attention_plan`: key splits of 64-key tiles, the splits of one (lane,
KV head, row tile) a thread-block cluster that joins them in shared memory.

Lanes. The leading axis of q (B, nq, T, D) and of the KV (B, nkv, S, D) is
the lane: B requests served together, each with its own KV rows, its own
(T, S) bias (a (B, T, S) bias, or one (T, S) bias every lane shares) and
its own live-row count. One launch serves all lanes: the kernel folds the
lane into its grid's z axis, so lane b of a B-lane launch is computed by
the same blocks in the same order as a one-lane launch of lane b (equal
bits), and `attention_plan` counts the B lanes' blocks against the wave.

`n_valid` is a host int (every lane), a 0-d tensor on q's device (every
lane) or a (B,) int tensor there (one a lane). The serving path passes a
tensor: its positions live on the card, so a replayed CUDA graph reads each
round's values. The kernel's grid is then planned for the whole allocation
(`attention_plan` at n_keys = S) and every block reads its lane's n_valid
from device memory and works through the live 64-key tiles only; the
splits past them are empty. A host int plans the grid for the live tiles
alone (`kernel_keys`), grouped into splits as the allocation's grid groups
them. The two give equal bits.

`tree_attention_simt` is the earlier kernel of the same library (one block
per KV head and 32 query rows, CUDA cores, one lane), kept for comparison
only: nothing on the serving path calls it; it takes a host n_valid. On a
CPU tensor both run `tree_attention_plain`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from flowspec_tpu_torch.ops import _build

KV_BLOCK = 256
KEY_TILE = 64        # keys a tile of the kernel
MAX_SPLITS = 8       # blocks of one thread-block cluster (portable limit)
MAX_WARPS = 6        # warps a block, 16 query rows each
TILE_WARPS = 3       # warps a block while the grid stays one wave
WAVE_BLOCKS = 360    # blocks of TILE_WARPS that run as one wave on an H100


def live_keys(s_max: int, n_valid) -> int:
    """KV rows the plain version (and the earlier kernel) reads for
    `n_valid` live rows: whole 256-row blocks, at most the allocation. A
    tensor on the card reads all `s_max` rows (knowing its value would
    cost a device-to-host read); one on the CPU is read (its largest lane:
    the rows a shorter lane reads past its own carry a -1e9 bias)."""
    if isinstance(n_valid, torch.Tensor):
        n_valid = (None if n_valid.device.type != "cpu"
                   else int(n_valid.max()))
    if n_valid is None:
        return s_max
    return min(s_max, -(-int(n_valid) // KV_BLOCK) * KV_BLOCK)


def kernel_keys(s_max: int, n_valid: int | None) -> int:
    """KV rows the kernel reads for `n_valid` live rows: whole 64-key tiles
    (at least one), at most the allocation."""
    if n_valid is None:
        return s_max
    return min(s_max, max(1, -(-int(n_valid) // KEY_TILE)) * KEY_TILE)


class AttentionPlan(NamedTuple):
    """How the kernel cuts one call: `warps` warps a block (16 query rows
    each) over `row_tiles` tiles of a KV head's G*T rows; the `n_keys` keys
    in `splits` runs of `tiles_per_split` 64-key tiles (the last may be
    shorter, none is empty), the splits of one (lane, head, row tile) one
    cluster; `blocks` in all, over every lane."""
    warps: int
    row_tiles: int
    splits: int
    tiles_per_split: int
    n_keys: int
    blocks: int


@lru_cache(maxsize=None)
def attention_plan(nkv: int, g: int, t: int, n_keys: int,
                   lanes: int = 1,
                   alloc_keys: int | None = None) -> AttentionPlan:
    """One split per 64-key tile up to MAX_SPLITS (4 splits at 256 keys, 8 at
    512), past that the fewest tiles a split that keep to MAX_SPLITS (a
    split of one tile measured faster than two at every main-path shape).
    With `alloc_keys`, the rows allocated (the grid a device n_valid reads
    is planned for them), the tiles a split are the allocation's, so a grid
    for fewer live keys groups them as that grid does: the same f32 sums,
    equal bits (past 512 rows the allocation's splits take two or more
    tiles, the live keys' one).
    Row tiles of at most TILE_WARPS x 16 rows, as even as the 16-row steps
    allow (81 rows: two tiles of three warps, not 64 + 17); if that grid
    would pass WAVE_BLOCKS (three such blocks an SM, on the ~120 SMs that
    clusters of 4-5 blocks reach), tiles of up to MAX_WARPS instead, so the
    grid stays one wave (the 13B late verify: 200 blocks of six warps where
    400 of three would run as two waves; `tools/torch_attention_profile.py`
    times the variants). The `lanes` lanes' blocks count together against
    the wave; one lane plans as it always did."""
    if lanes < 1 or nkv < 1 or g < 1 or t < 1 or n_keys < KEY_TILE \
            or n_keys % KEY_TILE:
        raise ValueError(f"attention_plan needs lanes, nkv, G, T >= 1 and "
                         f"n_keys a positive multiple of {KEY_TILE}, got "
                         f"lanes={lanes} nkv={nkv} G={g} T={t} "
                         f"n_keys={n_keys}")
    tiles = n_keys // KEY_TILE
    per = -(-max(n_keys, alloc_keys or 0) // KEY_TILE // MAX_SPLITS)
    splits = -(-tiles // per)
    m16 = -(-(g * t) // 16)
    row_tiles = -(-m16 // TILE_WARPS)
    if lanes * nkv * row_tiles * splits > WAVE_BLOCKS:
        row_tiles = -(-m16 // MAX_WARPS)
    warps = -(-m16 // row_tiles)
    return AttentionPlan(warps=warps, row_tiles=row_tiles, splits=splits,
                         tiles_per_split=per, n_keys=n_keys,
                         blocks=lanes * nkv * row_tiles * splits)


def tree_attention_plain(q, k_cache, v_cache, bias, n_valid=None):
    """The dense path of the JAX package's `attention` (`models/llama.py:
    187-196`), for each lane, over the KV rows `live_keys` gives for
    `n_valid` (a host int, a tensor or None): f32 scores, softmax, probs
    cast to q's dtype before PV, f32 accumulation, cast last. Rows read past
    a lane's n_valid carry a -1e9 bias and add exactly nothing. `bias` is
    (T, S) for every lane or (B, T, S)."""
    n_keys = live_keys(k_cache.shape[2], n_valid)
    nq, nkv = q.shape[1], k_cache.shape[1]
    k = k_cache[:, :, :n_keys]
    v = v_cache[:, :, :n_keys]
    if nq != nkv:
        k = k.repeat_interleave(nq // nkv, dim=1)
        v = v.repeat_interleave(nq // nkv, dim=1)
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lane_bias = bias[None] if bias.dim() == 2 else bias
    scores = scores + lane_bias[:, None, :, :n_keys].float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def _check(name, q, k_cache, v_cache, bias):
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    b, nq, t, d = q.shape
    _, nkv, s_max, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or nq % nkv:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)}")
    if tuple(bias.shape) not in ((t, s_max), (b, t, s_max)) \
            or bias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be ({t}, {s_max}) or ({b}, {t}, "
                         f"{s_max}) f32, got {tuple(bias.shape)} "
                         f"{bias.dtype}")


def tree_attention(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, bias: torch.Tensor,
                   n_valid=None) -> torch.Tensor:
    """q (B, nq, T, D); k/v_cache (B, nkv, S, D), B lanes; bias (T, S) or
    (B, T, S) f32 additive; n_valid: live KV rows, a host int, a 0-d tensor
    or a (B,) int tensor on q's device (None = all S). Returns (B, nq, T,
    D)."""
    _check("tree_attention", q, k_cache, v_cache, bias)
    s_max = k_cache.shape[2]
    if q.device.type == "cpu":
        return tree_attention_plain(q, k_cache, v_cache, bias, n_valid)
    b, nq, t, _ = q.shape
    nkv = k_cache.shape[1]
    on_device = isinstance(n_valid, torch.Tensor)
    if on_device and (n_valid.numel() not in (1, b)
                      or n_valid.dim() > 1 or n_valid.device != q.device):
        raise ValueError("tree_attention: a tensor n_valid must be 0-d or "
                         f"({b},) on q's device, got {tuple(n_valid.shape)} "
                         f"on {n_valid.device}")
    if bias.dim() == 2 and b > 1:
        bias = bias.expand(b, t, s_max)
    plan = attention_plan(nkv, nq // nkv, t,
                          s_max if on_device else kernel_keys(s_max, n_valid),
                          lanes=b, alloc_keys=s_max)
    if on_device:
        n_valid = n_valid.reshape(-1).to(torch.int32).expand(b)
    return _launch(tree_attention, q, k_cache, v_cache, bias, plan.n_keys,
                   (plan.warps, plan.splits, plan.tiles_per_split),
                   n_valid=n_valid if on_device else None)


tree_attention.launches = 0


def tree_attention_simt(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, bias: torch.Tensor,
                        n_valid: int | None = None) -> torch.Tensor:
    """The same function through the earlier kernel (CUDA cores, one block
    per KV head and 32 query rows, whole 256-row blocks; a tensor n_valid
    reads all S rows), for one lane only. For comparison only."""
    _check("tree_attention_simt", q, k_cache, v_cache, bias)
    if q.shape[0] != 1:
        raise ValueError("tree_attention_simt takes one lane, got "
                         f"{q.shape[0]}")
    n_keys = live_keys(k_cache.shape[2], n_valid)
    if q.device.type == "cpu":
        return tree_attention_plain(q, k_cache, v_cache, bias, n_keys)
    return _launch(tree_attention_simt, q, k_cache, v_cache, bias, n_keys,
                   (), lib="tree_attention")


tree_attention_simt.launches = 0


def _launch(wrapper, q, k_cache, v_cache, bias, n_keys, plan_ints, lib=None,
            n_valid=None):
    """Launch the kernel named like `wrapper` and count it. The C entry
    point takes (q, k, v, bias, [n_valid,] out, [lanes,] nkv, G, T, S, D,
    n_keys, *plan_ints, scale, stream), the device n_valid pointer (0 for
    none) and the lane count for `tree_attention` only; anything the kernel
    does not take raises here."""
    name = wrapper.__name__
    lanes, nq, t, d = q.shape
    _, nkv, s_max, _ = k_cache.shape
    if not all(x.is_cuda and x.device == q.device
               for x in (k_cache, v_cache, bias)):
        raise ValueError(f"{name}: inputs must share one CUDA device")
    _build.refuse_grad(name, q, k_cache, v_cache, bias)
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16 \
            or v_cache.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 q/k/v")
    if d not in (64, 128) or s_max % KV_BLOCK:
        raise ValueError(f"{name} kernel needs D in (64, 128) and "
                         f"S % {KV_BLOCK} == 0, got D={d} S={s_max}")
    q, k_cache, v_cache, bias = (_build.aligned16(x)
                                 for x in (q, k_cache, v_cache, bias))
    out = torch.empty_like(q)
    nv, nl = (), ()
    if wrapper is tree_attention:
        if n_valid is not None:
            n_valid = n_valid.contiguous()
        nv = (0 if n_valid is None else n_valid.data_ptr(),)
        nl = (lanes,)
    fn = _build.bind(name, 5 + len(nv), 6 + len(nl) + len(plan_ints), 1,
                     lib=lib)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 bias.data_ptr(), *nv, out.data_ptr(), *nl, nkv, nq // nkv,
                 t, s_max, d, n_keys, *plan_ints, d ** -0.5,
                 _build.stream_ptr(q.device))
    _build.check(err, name)
    wrapper.launches += 1
    return out
