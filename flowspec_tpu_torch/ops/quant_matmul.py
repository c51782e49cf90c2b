"""Weight-only dequant-matmuls: the CUDA kernels' wrappers and their plain
PyTorch versions.

int8 — port of `flowspec_tpu/ops/quant_matmul.py:47 _int8_kernel` / `:54
int8_matmul`. y = (x @ q) * scale with x (B, T, In), q (In, Out) int8,
scale (Out,) f32, f32 accumulation, one cast to x's dtype at the end — the
rounding order of `flowspec_tpu/ops/quant.py:238-240`.

Packed 4-bit — port of `:118 _nf4_kernel`, `:144 _int4_kernel` and `:203
_int4_kfull_kernel`. q (In/2, Out) uint8 holds two codes per byte along In,
scale (In/64, Out) f32 one value per 64 rows per column. The operand is
decoded **in bf16**, as the TPU kernels do:
`w = bf16(bf16(value) * bf16(scale))` with value = nibble - 8 (int4) or
`NF4_CODE[nibble]` (nf4), then `y = cast(sum_f32 x * w)`. This differs from
the f32 `ops/quant.dequantize` by one bf16 rounding per weight. The
kernels compute this one function and differ only in the order of the f32
sum.

`int8_matmul`, `nf4_matmul` and `int4_matmul` run the `wgmma` kernels
(`csrc/qmm_wgmma.cuh`) by the plan `matmul_plan` gives for the shape and
format: the product's (row tile, column strip, 64-row block) iterations
shared by at most two blocks an SM, stream-K over the whole product where it
has at least as many tiles as SMs, else each tile split into segments that
one thread-block cluster adds; either way a split tile's f32 segments are
added in ascending order inside the same kernel, so the bits are the same on
every launch. `int4_matmul` sends calls of at most 32 rows (`SMALL_M`, the
JAX package's cut) to `int4_matmul_smallm`, the same `wgmma` kernel built in
the small-M library and counted apart. `int8_matmul_strip`,
`nf4_matmul_strip` and `int4_matmul_strip` (the earlier one-strip-per-block
kernels) and `int4_matmul_splitk` (the earlier small-M `mma.sync` kernel) are
kept for comparison only: nothing on the serving path calls them.

On a CUDA tensor every wrapper launches its kernel (bf16 activations) or
raises; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from flowspec_tpu_torch.ops import _build
from flowspec_tpu_torch.ops.quant import NF4_BLOCK, NF4_CODE, unpack_nf4

SMALL_M = 32            # int4 calls of at most this many rows: small-M entry
SPLITK_BLOCKS = 4 * 132  # blocks the earlier small-M grid aims for (4 per SM)

# ---- the plan of the wgmma kernels (csrc/qmm_wgmma.cuh) -------------------
N_SMS = 132                   # H100 SXM
SMEM_PER_SM = 227 * 1024      # shared memory the blocks of one SM may hold
BLOCKS_PER_SM = 2             # blocks of a grid an SM holds at most
WGMMA_WIDTHS = (16, 64, 96, 128)   # rows of x a block covers (instantiated)
# ring slots per width, the deepest of which two blocks fit an SM for both
# formats (a ring of 4 measured like one of 6); stages - 2 tiles are in flight
WGMMA_STAGES = {16: 6, 64: 6, 96: 5, 128: 4}
NF4_LUT_BYTES = 8192          # the nf4 kernel's table of decoded byte pairs
FORMATS = ("int8", "nf4", "int4")
FLAG_SLOTS = 1024             # the per-device flags (`QMM_MAX_GRID` in C)
MAX_SPLIT = 8                 # blocks a cluster (`QMM_MAX_SPLIT` in C)
# clusters of s blocks (s = 1..8) the H100 holds at once at two blocks an SM
# (cudaOccupancyMaxActiveClusters at widths 64-128; width 16 holds more):
# a split cut keeps all its clusters resident, since a second wave of
# clusters ran up to 35 % slower (32 clusters of 8 against 32 of 7)
RESIDENT_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30)


class MatmulPlan(NamedTuple):
    """How the wgmma kernels (int8, nf4, int4) cut one product (M, In) x
    (In, Out): `bn` columns a tile, `n` rows of x a tile (the wgmma width;
    M > 128 runs ceil(M/128) row tiles), `tiles` (row tile, strip) tiles of
    `nkb` 64-row blocks each, shared by `grid` blocks as ranges of the tiles
    x nkb iterations (the 64-row block fastest; `ranges`) that differ by at
    most one 64-row block. `split` 0 is the stream-K cut: contiguous ranges
    over the whole product, a split tile finished by the block holding its
    last 64-row block from the others' partials in global scratch. `split`
    s >= 1 is the split cut: every tile in s segments, one a block, the
    tile's blocks one cluster that adds them in shared memory (s = 1: whole
    tiles). `fixups` tiles span more than one block; a ring of `stages`
    tiles in `smem` bytes of dynamic shared memory."""
    bn: int
    n: int
    grid: int
    split: int
    tiles: int
    nkb: int
    fixups: int
    stages: int
    smem: int

    @property
    def iters(self) -> int:
        return self.tiles * self.nkb

    def ranges(self) -> list:
        """[start, end) of each block's iterations, in block order."""
        i, g, s, k = self.iters, self.grid, self.split, self.nkb
        if s:
            return [((b // s) * k + (b % s) * k // s,
                     (b // s) * k + (b % s + 1) * k // s) for b in range(g)]
        return [(b * i // g, (b + 1) * i // g) for b in range(g)]

    def segments(self, tile: int) -> list:
        """(block, k0, k1) of each block's part of `tile`, in ascending k
        (and block) order; the last one finishes the tile."""
        t0, k = tile * self.nkb, self.nkb
        if self.split:
            blocks = range(tile * self.split, (tile + 1) * self.split)
        else:       # the blocks holding the tile's first and last iteration
            owner = lambda it: ((it + 1) * self.grid - 1) // self.iters
            blocks = range(owner(t0), owner(t0 + k - 1) + 1)
        r = self.ranges()
        return [(b, max(r[b][0], t0) - t0, min(r[b][1], t0 + k) - t0)
                for b in blocks]

    def scratch_shape(self, m: int) -> tuple | None:
        """Shape of the f32 partials the wrapper allocates for the stream-K
        cut (one slot a block of min(M, n) rows x bn); None when no tile is
        split, and for the split cut."""
        return ((self.grid, min(m, self.n), self.bn)
                if self.fixups and not self.split else None)


def smem_bytes(n: int, stages: int, fmt: str) -> int:
    """Dynamic shared memory of one block for format `fmt`: `stages` x (the
    x tile of n rows of 64 bf16 + the weight tile of 64 contraction rows x
    128 columns: int8 8 KB, packed 4-bit 4 KB and one 512-byte scale row),
    the nf4 table (int4 decodes without one), and 1 KB to align the first
    tile (`QmmTile<FMT>::smem_bytes` in csrc/qmm_wgmma.cuh)."""
    if fmt not in FORMATS:
        raise ValueError(f"format {fmt!r} not in {FORMATS}")
    per_stage = n * 128 + (8192 if fmt == "int8" else 4096 + 512)
    return stages * per_stage + (NF4_LUT_BYTES if fmt == "nf4" else 0) + 1024


def stream_fixups(iters: int, nkb: int, grid: int) -> int:
    """Tiles of a stream-K cut whose k range spans more than one block: the
    distinct tiles a range boundary falls strictly inside (`qmm_fixups` in
    C)."""
    inside = {s // nkb for s in (b * iters // grid for b in range(1, grid))
              if s % nkb}
    return len(inside)


@lru_cache(maxsize=None)
def matmul_plan(m: int, n_in: int, n_out: int, fmt: str) -> MatmulPlan:
    """The plan for M = m rows of format `fmt`. Strips of 128 columns (64 / 32 where Out is
    ragged); the narrowest instantiated width >= M with its ring of
    `WGMMA_STAGES`. A product of at least N_SMS tiles takes the stream-K cut
    over min(BLOCKS_PER_SM x N_SMS, iterations) blocks: every SM streams an
    equal share, and a split tile's partials come from two or three blocks.
    A product of fewer tiles takes the split cut, the most segments a tile,
    at most MAX_SPLIT and one a 64-row block, whose clusters all fit on the
    card at once (RESIDENT_CLUSTERS) within BLOCKS_PER_SM x N_SMS blocks:
    there a stream-K tile would spread over many blocks, and one block
    adding their partials took longer on the card than the product itself.
    A function of the shape alone."""
    if m < 1 or n_in % NF4_BLOCK or n_out % 32:
        raise ValueError(f"matmul_plan needs M >= 1, In % {NF4_BLOCK} == 0 "
                         f"and Out % 32 == 0, got M={m} In={n_in} "
                         f"Out={n_out}")
    bn = 128 if n_out % 128 == 0 else 64 if n_out % 64 == 0 else 32
    n = next((w for w in WGMMA_WIDTHS if w >= m), WGMMA_WIDTHS[-1])
    stages = WGMMA_STAGES[n]
    nkb = n_in // NF4_BLOCK
    tiles = (n_out // bn) * -(-m // n)
    blocks = BLOCKS_PER_SM * N_SMS
    if tiles >= N_SMS:
        grid, split = min(blocks, tiles * nkb), 0
        fixups = stream_fixups(tiles * nkb, nkb, grid)
    else:
        split = max(k for k in range(1, min(MAX_SPLIT, nkb) + 1)
                    if tiles <= RESIDENT_CLUSTERS[k - 1]
                    and tiles * k <= blocks)
        grid, fixups = tiles * split, tiles if split > 1 else 0
    return MatmulPlan(bn=bn, n=n, grid=grid, split=split, tiles=tiles,
                      nkb=nkb, fixups=fixups, stages=stages,
                      smem=smem_bytes(n, stages, fmt))


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version: q cast to x's dtype (exact for |q| <= 127), products
    summed in f32, times scale, cast last. bf16 x bf16 products are exact in
    f32, so `x.float() @ q.float()` is the f32-accumulated product."""
    y = torch.matmul(x.to(torch.float32), q.to(x.dtype).to(torch.float32))
    return (y * scale.to(torch.float32)).to(x.dtype)


def _check_int8(name, x, q, scale):
    if x.dim() != 3 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{name}: bad ranks x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} scale{tuple(scale.shape)}")
    if q.shape[0] != x.shape[2] or scale.shape[0] != q.shape[1]:
        raise ValueError(f"{name}: shape mismatch x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} scale{tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: q {q.dtype}, scale {scale.dtype}")


def _check_launch(name, x, q, scale):
    """What every dequant-matmul kernel needs of its operands on the card;
    anything else raises (there is no fallback)."""
    if not (x.is_cuda and q.device == x.device and scale.device == x.device):
        raise ValueError(f"{name}: x, q and scale must share one device")
    _build.refuse_grad(name, x, q, scale)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 x, got {x.dtype}")
    if x.shape[2] % 64 or q.shape[1] % 32:
        raise ValueError(f"{name} kernel needs In % 64 == 0 and "
                         f"Out % 32 == 0, got In={x.shape[2]} "
                         f"Out={q.shape[1]}")
    if not (q.is_contiguous() and scale.is_contiguous()
            and q.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0):
        raise ValueError(f"{name} kernel needs contiguous, 16-byte aligned "
                         "q and scale")


_flags: dict = {}


def _flags_on(device) -> torch.Tensor:
    """The stream-K flags of `device`: FLAG_SLOTS int32, zeroed once. Every
    launch leaves them zero (the block finishing a tile clears what it
    took), so they are never zeroed again; launches on one device do not
    overlap in this package (one stream at a time)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _flags:
        _flags[device] = torch.zeros((FLAG_SLOTS,), dtype=torch.int32,
                                     device=device)
    return _flags[device]


def _launch_planned(wrapper, x, q, scale, fmt: str, ptrs=()):
    """Launch the wgmma kernel named like `wrapper` by `matmul_plan` for
    format `fmt` and count it, and the split tiles it finishes in
    `wrapper.fixup_tiles`. The C entry point takes (x, q, scale, *ptrs,
    partial, flags, y, M, In, Out, bn, n, grid, split, stages, stream)."""
    name = wrapper.__name__
    _check_launch(name, x, q, scale)
    x = _build.aligned16(x)
    b, t, n_in = x.shape
    n_out = q.shape[1]
    plan = matmul_plan(b * t, n_in, n_out, fmt)
    shape = plan.scratch_shape(b * t)
    partial = (torch.empty(shape, dtype=torch.float32, device=x.device)
               if shape else None)
    y = torch.empty((b, t, n_out), dtype=x.dtype, device=x.device)
    fn = _build.bind(name, 6 + len(ptrs), 8)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 *(p.data_ptr() for p in ptrs),
                 partial.data_ptr() if partial is not None else None,
                 _flags_on(x.device).data_ptr(), y.data_ptr(), b * t, n_in,
                 n_out, plan.bn, plan.n, plan.grid, plan.split, plan.stages,
                 _build.stream_ptr(x.device))
    _build.check(err, name)
    wrapper.launches += 1
    wrapper.fixup_tiles += plan.fixups
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (B, T, In) @ (q (In, Out) int8 * scale (Out,)) -> (B, T, Out)."""
    _check_int8("int8_matmul", x, q, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    return _launch_planned(int8_matmul, x, q, scale, "int8")


int8_matmul.launches = 0
int8_matmul.fixup_tiles = 0


def int8_matmul_strip(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The same product through the earlier strip kernel (one block per 32
    or 64 columns, no split-K). For comparison only."""
    _check_int8("int8_matmul_strip", x, q, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    _check_launch("int8_matmul_strip", x, q, scale)
    x = _build.aligned16(x)
    b, t, n_in = x.shape
    n_out = q.shape[1]
    y = torch.empty((b, t, n_out), dtype=x.dtype, device=x.device)
    fn = _build.bind("int8_matmul_strip", 4, 3, lib="int8_matmul")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 b * t, n_in, n_out, _build.stream_ptr(x.device))
    _build.check(err, "int8_matmul_strip")
    int8_matmul_strip.launches += 1
    return y


int8_matmul_strip.launches = 0


# ---- packed 4-bit ----------------------------------------------------------

def _operands4_bf16(q: torch.Tensor, scale: torch.Tensor, nf4: bool):
    """(In/2, Out) packed bytes -> the (In, Out) bf16 values and the bf16
    block scales repeated over their 64 rows."""
    idx = unpack_nf4(q)
    if nf4:
        val = torch.from_numpy(NF4_CODE).to(q.device).to(
            torch.bfloat16)[idx.long()]
    else:
        val = (idx.to(torch.int16) - 8).to(torch.bfloat16)
    return val, scale.to(torch.bfloat16).repeat_interleave(NF4_BLOCK, dim=-2)


def _decode4_bf16(q: torch.Tensor, scale: torch.Tensor,
                  nf4: bool) -> torch.Tensor:
    """The (In, Out) bf16 operand the kernels build: one bf16 multiply of
    the bf16 value and the bf16 block scale."""
    val, s = _operands4_bf16(q, scale, nf4)
    return val * s


def _packed4_plain(x, q, scale, nf4: bool):
    w = _decode4_bf16(q, scale, nf4)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def nf4_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the nf4 kernel: bf16 decode, f32 sum, cast last."""
    return _packed4_plain(x, q, scale, nf4=True)


def int4_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version of both int4 kernels (they differ in summation order
    only): bf16 decode, f32 sum, cast last."""
    return _packed4_plain(x, q, scale, nf4=False)


def _check_packed4(name, x, q, scale):
    if x.dim() != 3 or q.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"{name}: bad ranks x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} scale{tuple(scale.shape)}")
    n_in, n_out = x.shape[2], q.shape[1]
    if n_in % NF4_BLOCK:
        raise ValueError(f"{name}: In = {n_in} is not a multiple of "
                         f"{NF4_BLOCK}")
    if (q.shape[0] * 2 != n_in
            or tuple(scale.shape) != (n_in // NF4_BLOCK, n_out)):
        raise ValueError(f"{name}: shape mismatch x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} scale{tuple(scale.shape)}")
    if q.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: q {q.dtype}, scale {scale.dtype}")


def _launch4(wrapper, x, q, scale, ptrs=(), ints=(), lib=None):
    """Launch the packed 4-bit kernel named like `wrapper` (an entry point
    of library `lib`, default the same name) and count it. The C entry point
    takes (x, q, scale, *ptrs, y, M, In, Out, *ints, stream); anything the
    kernel does not take raises here."""
    name = wrapper.__name__
    _check_launch(name, x, q, scale)
    x = _build.aligned16(x)
    b, t, n_in = x.shape
    n_out = q.shape[1]
    y = torch.empty((b, t, n_out), dtype=x.dtype, device=x.device)
    fn = _build.bind(name, 4 + len(ptrs), 3 + len(ints), lib=lib)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 *(p.data_ptr() for p in ptrs), y.data_ptr(), b * t, n_in,
                 n_out, *ints, _build.stream_ptr(x.device))
    _build.check(err, name)
    wrapper.launches += 1
    return y


_nf4_code: dict = {}


def _nf4_code_on(device) -> torch.Tensor:
    """NF4_CODE rounded to bf16 once, on `device` (the kernel's table)."""
    if device not in _nf4_code:
        _nf4_code[device] = torch.from_numpy(NF4_CODE).to(device).to(
            torch.bfloat16)
    return _nf4_code[device]


def nf4_matmul(x: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """x (B, T, In) @ NF4(q (In/2, Out) packed u8, scale (In/64, Out))
    -> (B, T, Out)."""
    _check_packed4("nf4_matmul", x, q, scale)
    if x.device.type == "cpu":
        return nf4_matmul_plain(x, q, scale)
    return _launch_planned(nf4_matmul, x, q, scale, "nf4",
                           ptrs=(_nf4_code_on(x.device),))


nf4_matmul.launches = 0
nf4_matmul.fixup_tiles = 0


def nf4_matmul_strip(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The same product through the earlier strip kernel (one block per 32
    or 64 columns, no split-K). For comparison only."""
    _check_packed4("nf4_matmul_strip", x, q, scale)
    if x.device.type == "cpu":
        return nf4_matmul_plain(x, q, scale)
    return _launch4(nf4_matmul_strip, x, q, scale,
                    ptrs=(_nf4_code_on(x.device),), lib="nf4_matmul")


nf4_matmul_strip.launches = 0


def int4_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (B, T, In) @ Int4(q (In/2, Out) packed u8, scale (In/64, Out))
    -> (B, T, Out). Calls of at most SMALL_M rows go to
    `int4_matmul_smallm`, wider ones to `int4_matmul_wide`: the same wgmma
    kernel in two libraries; `launches` counts the wide calls only."""
    _check_packed4("int4_matmul", x, q, scale)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q, scale)
    if x.shape[0] * x.shape[1] <= SMALL_M:
        return int4_matmul_smallm(x, q, scale)
    return int4_matmul_wide(x, q, scale)


int4_matmul.launches = 0
int4_matmul.fixup_tiles = 0


def int4_matmul_wide(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The wgmma kernel `int4_matmul` takes above SMALL_M rows, at any M
    (the card checks hold it to its plain version at small M too); its
    launches count as `int4_matmul`'s."""
    _check_packed4("int4_matmul", x, q, scale)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q, scale)
    return _launch_planned(int4_matmul, x, q, scale, "int4")


def int4_matmul_strip(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The same product through the earlier strip kernel (one block per 32
    or 64 columns, no split-K). For comparison only."""
    _check_packed4("int4_matmul_strip", x, q, scale)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q, scale)
    return _launch4(int4_matmul_strip, x, q, scale, lib="int4_matmul")


int4_matmul_strip.launches = 0


def _check_small_m(name, x):
    rows = x.shape[0] * x.shape[1]
    if rows > SMALL_M:
        raise ValueError(f"{name} takes at most {SMALL_M} rows, got {rows}")


def int4_matmul_smallm(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The same product for B*T <= SMALL_M rows: the wgmma kernel by
    `matmul_plan` (width 16 up to 16 rows, 64 for 17-32), built in the
    small-M library and counted here."""
    _check_packed4("int4_matmul_smallm", x, q, scale)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q, scale)
    _check_small_m("int4_matmul_smallm", x)
    return _launch_planned(int4_matmul_smallm, x, q, scale, "int4")


int4_matmul_smallm.launches = 0
int4_matmul_smallm.fixup_tiles = 0


def split_k(n_in: int, n_out: int) -> int:
    """How many K splits the earlier small-M kernel runs: enough that column
    strips (128 columns where Out allows) x splits reach SPLITK_BLOCKS, every
    split a whole number of 64-row blocks and none empty."""
    if n_in % NF4_BLOCK or n_out % 32:
        raise ValueError(f"split_k needs In % {NF4_BLOCK} == 0 and "
                         f"Out % 32 == 0, got In={n_in} Out={n_out}")
    nkb = n_in // NF4_BLOCK
    bn = 128 if n_out % 128 == 0 else 64 if n_out % 64 == 0 else 32
    want = max(1, -(-SPLITK_BLOCKS // (n_out // bn)))
    chunk = -(-nkb // min(want, nkb))
    return -(-nkb // chunk)


def int4_matmul_splitk(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The same product for B*T <= SMALL_M rows through the earlier split-K
    kernel (mma.sync; f32 partials per split added in ascending order by a
    second pass: equal bits on every launch). For comparison only."""
    _check_packed4("int4_matmul_splitk", x, q, scale)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q, scale)
    _check_small_m("int4_matmul_splitk", x)
    rows, n_out = x.shape[0] * x.shape[1], q.shape[1]
    ksplit = split_k(x.shape[2], n_out)
    partial = torch.empty((ksplit, rows, n_out), dtype=torch.float32,
                          device=x.device)
    return _launch4(int4_matmul_splitk, x, q, scale, ptrs=(partial,),
                    ints=(ksplit,), lib="int4_matmul_smallm")


int4_matmul_splitk.launches = 0
