"""The PyTorch port's packed 4-bit formats against the JAX package on the CPU.

(a) quantize_nf4 / quantize_int4 / pack / unpack / dequantize give JAX's
    bytes and scales, exact-midpoint (nf4) and half-way (int4) inputs
    included;
(b) the plain versions of the nf4 / int4 dequant-matmuls (what the CUDA
    kernels are held to on the card) against the Pallas kernels in interpret
    mode, `_int4_matmul_kfull` with two K steps included. bf16 x (what the
    card runs): within one bf16 ulp (rtol 1e-2). f32 x: XLA on the CPU keeps
    excess precision and drops the bf16 rounding of value * scale when its
    consumer is f32, so there the bf16 value times the bf16 scale,
    unrounded, must match within 1e-4 relative (same operand bits, f32 sums
    in another order), and the plain version, which rounds the product as
    the chip does, within that rounding's own bound 2^-8 * (|x| @ |w|). And
    loosely against JAX's f32 `dequantize` path, which rounds nothing to
    bf16: within the three roundings' bound 2^-7 * (|x| @ |w|), and within
    rtol 5e-2 / atol 2e-1 (tests/test_quant.py:150-155 holds 8 rows to
    atol 1e-1; these cases have up to 40 rows and longer tails);
(c) `qmatmul` dispatch, the wrappers' refusals and the bridge's refusal to
    guess the kind of a uint8 container;
(d) the plan of the wgmma kernels (`matmul_plan`, shared by int8, nf4 and
    int4: stream-K at >= 132 tiles, else each tile's segments in one
    cluster, all resident) over every (M, In, Out) the wrappers accept, with
    hypothesis: every (row tile, strip, 64-row block) in exactly one block's
    range, the ranges within one block of each other, at most two blocks an
    SM, each tile's segments in ascending k with the last one in the highest
    block, `fixups` the tiles spanning more than one block, the strip width
    divides Out, the width covers M (or M runs in 128-row tiles), the ring
    fits an SM, the scratch has the shape the wrapper allocates; at Qwen2-7B's
    w_gate / w_up the busiest SM streams within 5 % of the mean; and
    `_split_sum`, a torch emulation of "one f32 sum a tile segment, the
    earlier segments' added in ascending order before the last one's, scale,
    one cast" driven by that plan, against `int8_matmul_plain` /
    `nf4_matmul_plain` / `int4_matmul_plain` at the card's tolerance (|err|
    <= 1e-2*|plain| + 1e-2: one bf16 ulp of an f32 sum taken in another
    order); and the int4 kernel's table-free
    decode (`i4_pair_bf16`: the bf16 value 128 + n, minus 136, times the
    scale) against `decode_pair`'s operand, bit for bit.
Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from flowspec_tpu.ops import quant as jq
from flowspec_tpu.ops import quant_matmul as jqm
from flowspec_tpu_torch import bridge
from flowspec_tpu_torch.ops import quant as tq
from flowspec_tpu_torch.ops import quant_matmul as tqm
from tests.torch_bridge_util import np_of, to_numpy_dict

QUANTIZERS = {"nf4": (jq.quantize_nf4, tq.quantize_nf4),
              "int4": (jq.quantize_int4, tq.quantize_int4)}
PLAIN = {"nf4": tqm.nf4_matmul_plain, "int4": tqm.int4_matmul_plain}
JKERNEL = {"nf4": jqm.nf4_matmul, "int4": jqm.int4_matmul}


def _weights(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(jt):
    return bridge.weight(to_numpy_dict(jt), device="cpu")


def _x(seed, m, n_in, dtype):
    x = np.random.default_rng(seed).standard_normal((1, m, n_in)).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    return jx, tx


def _check_against_kernel(kind, dtype, tx, tt, got, want):
    scale = np.abs(want).max()
    if dtype == "bfloat16":    # one bf16 rounding of f32 sums that differ
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * scale)
        return
    val, s = tqm._operands4_bf16(tt.q, tt.scale, nf4=kind == "nf4")
    w = val.float() * s.float()                # the product left unrounded
    np.testing.assert_allclose((tx @ w).numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)
    bound = 2.0 ** -8 * (tx.abs() @ w.abs()).numpy() + 1e-4 * scale
    assert (np.abs(got - want) <= bound).all()


def test_nf4_code_is_the_jax_table():
    np.testing.assert_array_equal(tq.NF4_CODE, jq.NF4_CODE)
    assert tq.NF4_BLOCK == jq.NF4_BLOCK == 64


@pytest.mark.parametrize("kind", ["nf4", "int4"])
@pytest.mark.parametrize("shape", [(256, 128), (3, 128, 64), (1024, 256)])
def test_quantize_bytes_and_scales_equal_jax(kind, shape):
    w = _weights(0, shape)
    jfn, tfn = QUANTIZERS[kind]
    want, got = jfn(jnp.asarray(w)), tfn(torch.from_numpy(w))
    assert got.q.dtype == torch.uint8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))
    assert (got.in_features, got.out_features) == shape[-2:]
    if len(shape) == 3:                      # the layer axis indexes away
        np.testing.assert_array_equal(got[1].q.numpy(), np.asarray(want.q)[1])
        assert type(got[1]) is type(got)


def test_nf4_exact_midpoints_go_down_as_in_jax():
    # column c holds the midpoint between codes c and c+1 (and its two f32
    # neighbours); row 0 pins the block's absmax at 1 so norm == value
    code = tq.NF4_CODE
    mids = (code[1:] + code[:-1]) * np.float32(0.5)
    w = np.zeros((64, 15), np.float32)
    w[0] = 1.0
    w[1], w[2] = mids, np.nextafter(mids, np.float32(2))
    w[3] = np.nextafter(mids, np.float32(-2))
    want = jq.quantize_nf4(jnp.asarray(w))
    got = tq.quantize_nf4(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    codes = tq.unpack_nf4(got.q).numpy()
    np.testing.assert_array_equal(codes[1], np.arange(15))       # down
    np.testing.assert_array_equal(codes[2], np.arange(15) + 1)
    np.testing.assert_array_equal(codes[3], np.arange(15))


def test_int4_half_way_values_round_to_even_as_in_jax():
    # absmax 7 -> scale 1: the values k + 0.5 are exactly half-way
    w = np.zeros((64, 4), np.float32)
    w[0] = 7.0
    w[1:15, 0] = np.arange(-7, 7) + 0.5
    w[1:15, 1] = -(np.arange(-7, 7) + 0.5)
    w[1:4, 2] = [7.5, -7.5, 100.0]           # clipped to the -7..7 grid
    w[0, 2] = 100.0
    want = jq.quantize_int4(jnp.asarray(w))
    got = tq.quantize_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    codes = tq.unpack_nf4(got.q).numpy().astype(np.int32) - 8
    np.testing.assert_array_equal(codes[1:15, 0],
                                  np.round(np.arange(-7, 7) + 0.5))
    assert codes.min() >= -7 and codes.max() <= 7


def test_pack_unpack_equal_jax_and_round_trip():
    idx = np.random.default_rng(1).integers(0, 16, (2, 128, 32)).astype(
        np.uint8)
    packed = tq.pack_nf4(torch.from_numpy(idx))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_nf4(jnp.asarray(idx))))
    np.testing.assert_array_equal(tq.unpack_nf4(packed).numpy(), idx)
    np.testing.assert_array_equal(
        tq.unpack_nf4(packed).numpy(),
        np.asarray(jq.unpack_nf4(jnp.asarray(packed.numpy()))))
    assert int(packed[0, 0, 0]) == (int(idx[0, 0, 0]) << 4 | int(idx[0, 1, 0]))


@pytest.mark.parametrize("kind", ["nf4", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n_in,n_out", [(1, 256, 128), (8, 1024, 256),
                                          (40, 256, 256)])
def test_plain_matches_pallas_kernel_in_interpret_mode(kind, dtype, m, n_in,
                                                       n_out):
    jt = QUANTIZERS[kind][0](jnp.asarray(_weights(2, (n_in, n_out))))
    tt = _port(jt)
    jx, tx = _x(3, m, n_in, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JKERNEL[kind](jx, jt.q, jt.scale), np.float32)
    got = np_of(PLAIN[kind](tx, tt.q, tt.scale))
    assert got.shape == (1, m, n_out)
    _check_against_kernel(kind, dtype, tx, tt, got, want)
    # loosely against the f32 dequant path (no bf16 rounding of the operand)
    # (value, scale and product each round to bf16: 3 * 2^-9 per weight,
    # plus the output's own rounding when x is bf16)
    wd = jq.dequantize(jt)
    ref = np.asarray(jx.astype(jnp.float32) @ wd)
    bound = 2.0 ** -7 * np.asarray(jnp.abs(jx.astype(jnp.float32))
                                   @ jnp.abs(wd)) + 2.0 ** -8 * np.abs(ref)
    assert (np.abs(got - ref) <= bound + 1e-4).all()
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=2e-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kb", [None, 256])
def test_int4_plain_matches_pallas_kfull_kernel(dtype, kb):
    """The small-M TPU kernel, one K step (kb None) and two (kb 256)."""
    jt = jq.quantize_int4(jnp.asarray(_weights(4, (1024, 256))))
    tt = _port(jt)
    jx, tx = _x(5, 8, 1024, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jqm._int4_matmul_kfull(jx, jt.q, jt.scale, kb_override=kb)
    want = np.asarray(want, np.float32)
    got = np_of(tqm.int4_matmul_plain(tx, tt.q, tt.scale))
    _check_against_kernel("int4", dtype, tx, tt, got, want)
    # the small-M wrapper is the same function on the CPU
    np.testing.assert_array_equal(
        np_of(tqm.int4_matmul_smallm(tx, tt.q, tt.scale)), got)


@pytest.mark.parametrize("kind", ["int8", "nf4", "int4"])
def test_qmatmul_dispatches_on_the_container(kind, monkeypatch):
    w = torch.from_numpy(_weights(6, (128, 64)))
    t = {"int8": tq.quantize_int8, "nf4": tq.quantize_nf4,
         "int4": tq.quantize_int4}[kind](w)
    calls = []
    for name in ("int8_matmul", "nf4_matmul", "int4_matmul"):
        fn = getattr(tqm, name)
        monkeypatch.setattr(
            tqm, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    x = torch.from_numpy(_weights(7, (2, 3, 128)))
    y = tq.qmatmul(x, t)
    assert calls == [f"{kind}_matmul"] and y.shape == (2, 3, 64)
    want = {"int8": tqm.int8_matmul_plain, "nf4": tqm.nf4_matmul_plain,
            "int4": tqm.int4_matmul_plain}[kind](x.reshape(1, 6, 128), t.q,
                                                 t.scale)
    np.testing.assert_array_equal(y.numpy(), want.reshape(2, 3, 64).numpy())
    np.testing.assert_array_equal(tq.qmatmul(x, w).numpy(), (x @ w).numpy())


def test_qmatmul_and_wrappers_refuse_bad_inputs():
    x = torch.zeros((1, 2, 96))
    q = torch.zeros((48, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 64"):     # In = 96
        tqm.nf4_matmul(x, q, torch.zeros((1, 32)))
    with pytest.raises(ValueError, match="multiple of the 64"):
        tq.quantize_int4(torch.zeros((96, 32)))
    x = torch.zeros((1, 2, 128))
    q = torch.zeros((64, 32), dtype=torch.uint8)
    s = torch.zeros((2, 32))
    with pytest.raises(TypeError):                               # int8 q
        tqm.int4_matmul(x, q.to(torch.int8), s)
    with pytest.raises(TypeError):                               # f16 scale
        tqm.nf4_matmul(x, q, s.half())
    with pytest.raises(ValueError, match="shape mismatch"):
        tqm.int4_matmul(x, q, torch.zeros((1, 32)))
    with pytest.raises(ValueError, match="bad ranks"):
        tqm.int4_matmul_smallm(x[0], q, s)
    with pytest.raises(TypeError, match="not a weight"):
        tq.qmatmul(x, {"q": q, "scale": s})
    assert tqm.int4_matmul(x, q, s).shape == (1, 2, 32)


def test_split_k_covers_every_block_with_no_empty_split():
    for n_in, n_out in [(64, 32), (256, 128), (4096, 4096), (5120, 5120),
                        (11008, 4096), (13824, 5120), (4096, 11008),
                        (1024, 2816), (10240, 1280)]:
        nkb, ks = n_in // 64, tqm.split_k(n_in, n_out)
        chunk = -(-nkb // ks)                 # the kernel's own rule
        assert 1 <= ks <= nkb and (ks - 1) * chunk < nkb <= ks * chunk
    assert tqm.split_k(5120, 5120) * (5120 // 128) >= 4 * 132
    for n_in, n_out in [(64, 24), (96, 32)]:      # what the kernel refuses
        with pytest.raises(ValueError, match="split_k needs"):
            tqm.split_k(n_in, n_out)


def _check_stream_k(p, m, nkb):
    """The invariants of plan `p` for M = m and In = 64 nkb: the stream-K
    cut for at least N_SMS tiles, else the split cut (grid = tiles x split,
    at most MAX_SPLIT segments a tile and one a 64-row block); the block
    ranges tile the iterations in order and differ by at most one 64-row
    block; each tile's segments cover [0, nkb) in ascending k, each inside
    its block's range, the last in the highest block; `fixups` counts the
    tiles spanning more than one block; a block has at most one unfinished
    head (its one partial slot)."""
    assert p.nkb == nkb and p.iters == p.tiles * nkb
    assert 1 <= p.grid <= min(tqm.BLOCKS_PER_SM * tqm.N_SMS, p.iters)
    if p.tiles >= tqm.N_SMS:
        assert p.split == 0
        assert p.fixups == tqm.stream_fixups(p.iters, nkb, p.grid)
    else:
        assert 1 <= p.split <= min(tqm.MAX_SPLIT, nkb)
        assert p.grid == p.tiles * p.split
        # every cluster resident at once, and no more segments would fit
        assert p.tiles <= tqm.RESIDENT_CLUSTERS[p.split - 1]
        assert p.split == min(tqm.MAX_SPLIT, nkb) or (
            p.tiles > tqm.RESIDENT_CLUSTERS[p.split]
            or p.tiles * (p.split + 1) > tqm.BLOCKS_PER_SM * tqm.N_SMS)
    r = p.ranges()
    assert len(r) == p.grid and r[0][0] == 0 and r[-1][1] == p.iters
    assert all(r[b][1] == r[b + 1][0] for b in range(p.grid - 1))
    lens = [e - s for s, e in r]
    assert min(lens) >= 1 and max(lens) - min(lens) <= 1
    split, heads, covered = 0, [], 0
    for t in range(p.tiles):
        seg = p.segments(t)
        assert seg[0][1] == 0 and seg[-1][2] == nkb
        assert all(k0 < k1 for _, k0, k1 in seg)
        assert all(seg[i][2] == seg[i + 1][1] for i in range(len(seg) - 1))
        blocks = [b for b, _, _ in seg]
        assert blocks == sorted(set(blocks)) and seg[-1][0] == max(blocks)
        for b, k0, k1 in seg:
            assert r[b][0] <= t * nkb + k0 and t * nkb + k1 <= r[b][1]
        covered += sum(k1 - k0 for _, k0, k1 in seg)
        split += len(seg) > 1
        heads += blocks[:-1]
    assert covered == p.iters and split == p.fixups
    assert len(heads) == len(set(heads))
    assert p.scratch_shape(m) == (
        (p.grid, min(m, p.n), p.bn) if p.fixups and not p.split else None)


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 700), nkb=st.integers(1, 256),
       out32=st.integers(1, 448), fmt=st.sampled_from(tqm.FORMATS))
def test_matmul_plan_tiles_k_exactly_for_every_accepted_shape(m, nkb, out32,
                                                              fmt):
    n_in, n_out = nkb * 64, out32 * 32
    p = tqm.matmul_plan(m, n_in, n_out, fmt)
    # strips: the widest of 128 / 64 / 32 that divides Out
    assert p.bn in (128, 64, 32) and n_out % p.bn == 0
    assert p.bn == 128 or n_out % (2 * p.bn) != 0
    # width: the narrowest instantiated one >= M; beyond 128, row tiles
    assert p.n in tqm.WGMMA_WIDTHS and (p.n >= m or p.n == 128)
    assert all(w < m for w in tqm.WGMMA_WIDTHS if w < p.n)
    assert p.tiles == (n_out // p.bn) * -(-m // p.n)
    # every (row tile, strip, 64-row block) in exactly one block, one wave
    _check_stream_k(p, m, nkb)
    # the ring is the one the width is built with and two blocks fit an SM
    assert p.stages == tqm.WGMMA_STAGES[p.n]
    assert p.smem == tqm.smem_bytes(p.n, p.stages, fmt)
    assert tqm.BLOCKS_PER_SM * (p.smem + 1024) <= tqm.SMEM_PER_SM


def _busiest_share(p) -> float:
    """What the busiest SM streams over the mean of the N_SMS SMs, at most
    BLOCKS_PER_SM blocks an SM, the longest ranges together."""
    longest = -(-p.iters // p.grid)
    return -(-p.grid // tqm.N_SMS) * longest / (p.iters / tqm.N_SMS)


def test_matmul_plan_main_path_shapes_and_refusals():
    # Qwen2-7B's w_gate / w_up at the verify, prefill, draft and AR widths:
    # 148 strips of 56 blocks, which a grid of whole strips left at 1.78x
    # the mean on 16 SMs, within 5 % of the mean on every SM
    for m, n in ((81, 96), (64, 64), (10, 16), (1, 16)):
        p = tqm.matmul_plan(m, 3584, 18944, "int8")
        assert (p.bn, p.n, p.tiles, p.nkb) == (128, n, 148, 56)
        assert _busiest_share(p) <= 1.05, (m, p)
        assert p.grid > tqm.N_SMS and p.fixups > 0
    # whole tiles that divide evenly: the data-parallel grid, no fix-up
    p = tqm.matmul_plan(81, 1024, 264 * 128, "int8")
    assert (p.grid, p.split, p.tiles, p.fixups) == (264, 0, 264, 0)
    assert p.scratch_shape(81) is None
    # fewer tiles than SMs: the split cut, eight segments a tile in one
    # cluster (Qwen2-7B's wq / wo / w_down and its draft's fc: 28 tiles;
    # wk / wv: 4), no global scratch; 32 tiles take seven (30 clusters of
    # eight fit the card at once, 32 of seven)
    for n_in, n_out, tiles in ((3584, 3584, 28), (18944, 3584, 28),
                               (7168, 3584, 28), (3584, 512, 4)):
        for m in (81, 10, 1):
            p = tqm.matmul_plan(m, n_in, n_out, "int8")
            assert (p.split, p.tiles, p.grid) == (8, tiles, 8 * tiles)
            assert p.fixups == tiles and p.scratch_shape(m) is None
    for m in (10, 1):                       # Mixtral-8x7B's draft fc / wq
        assert tqm.matmul_plan(m, 8192, 4096, "int8")[2:5] == (224, 7, 32)
    # one 64-row block a tile is never split; M > 128 runs in row tiles
    p = tqm.matmul_plan(8, 64, 1056, "int8")
    assert (p.bn, p.nkb, p.tiles, p.fixups) == (32, 1, 33, 0)
    assert tqm.matmul_plan(130, 4096, 4096, "nf4").n == 128
    assert tqm.matmul_plan(130, 4096, 4096, "nf4").tiles == 64
    # one ring per width, for every format
    assert [tqm.matmul_plan(m, 4096, 4096, f).stages
            for m in (1, 64, 81, 128) for f in tqm.FORMATS] == [
        6, 6, 6, 6, 6, 6, 5, 5, 5, 4, 4, 4]
    for m, n_in, n_out in [(0, 64, 32), (1, 96, 32), (1, 64, 24)]:
        with pytest.raises(ValueError, match="matmul_plan needs"):
            tqm.matmul_plan(m, n_in, n_out, "int8")
    with pytest.raises(ValueError, match="format"):
        tqm.matmul_plan(1, 64, 32, "fp4")


def _split_sum(x: torch.Tensor, w: torch.Tensor, plan,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """What the wgmma kernels compute, in plain torch: for each tile of
    `plan` (row tile, strip) one f32 sum a block's segment (x (..., In)
    times the bf16 operand w (In, Out)), the earlier segments' sums added in
    ascending order before the last one's, the int8 per-column scale if any,
    one cast to x's dtype."""
    rows = x.reshape(-1, x.shape[-1]).to(torch.float32)
    wf = w.to(torch.float32)
    out = torch.empty((rows.shape[0], w.shape[1]), dtype=torch.float32)
    strips = w.shape[1] // plan.bn
    for t in range(plan.tiles):
        m0, n0 = (t // strips) * plan.n, (t % strips) * plan.bn
        xs = rows[m0:m0 + plan.n]
        parts = [xs[:, k0 * 64:k1 * 64] @ wf[k0 * 64:k1 * 64, n0:n0 + plan.bn]
                 for _, k0, k1 in plan.segments(t)]
        total = parts[0]
        for part in parts[1:-1]:
            total = total + part
        if len(parts) > 1:
            total = total + parts[-1]
        out[m0:m0 + plan.n, n0:n0 + plan.bn] = total
    if scale is not None:
        out = out * scale.to(torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[1]).to(x.dtype)


# (M, In, Out): every width, ragged strips, one block, a prime block count
SPLIT_CASES = [(1, 4096, 1024), (10, 8192, 1024), (17, 832, 1056),
               (81, 2368, 1088), (96, 64, 1056), (130, 2368, 256)]


@pytest.mark.parametrize("kind", ["int8", "nf4", "int4"])
@pytest.mark.parametrize("m,n_in,n_out", SPLIT_CASES)
def test_split_sum_by_the_plan_matches_plain(kind, m, n_in, n_out):
    rng = np.random.default_rng(m + n_in)
    x = torch.from_numpy(rng.standard_normal((1, m, n_in)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((n_in, n_out)).astype(
        np.float32) * n_in ** -0.5)
    plan = tqm.matmul_plan(m, n_in, n_out, kind)
    nf4 = kind == "nf4"
    if kind == "int8":
        t = tq.quantize_int8(w)
        got = _split_sum(x, t.q.to(torch.bfloat16), plan, t.scale)
        want = tqm.int8_matmul_plain(x, t.q, t.scale)
    else:
        t = (tq.quantize_nf4 if nf4 else tq.quantize_int4)(w)
        got = _split_sum(x, tqm._decode4_bf16(t.q, t.scale, nf4), plan)
        want = PLAIN[kind](x, t.q, t.scale)
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-2 * want.float().abs() + 1e-2).all()), err.max()
    if plan.grid <= plan.tiles and not plan.fixups:   # whole tiles: plain
        assert torch.equal(got, want)
    # the order is fixed: the same bits again
    again = _split_sum(x, (t.q.to(torch.bfloat16) if kind == "int8" else
                              tqm._decode4_bf16(t.q, t.scale, nf4)), plan,
                          t.scale if kind == "int8" else None)
    assert torch.equal(got, again)


@pytest.mark.parametrize("name", ["int8_matmul", "int8_matmul_strip",
                                  "nf4_matmul", "nf4_matmul_strip",
                                  "int4_matmul_wide", "int4_matmul_strip"])
def test_wgmma_and_strip_wrappers_refuse_and_run_plain_on_cpu(name):
    fn = getattr(tqm, name)
    int8 = name.startswith("int8")
    x = torch.zeros((1, 2, 128))
    if int8:
        q, s = torch.zeros((128, 32), dtype=torch.int8), torch.zeros((32,))
        bad_q, bad_s = q.to(torch.uint8), torch.zeros((1, 32))
    else:
        q, s = torch.zeros((64, 32), dtype=torch.uint8), torch.zeros((2, 32))
        bad_q, bad_s = q.to(torch.int8), torch.zeros((32,))
    with pytest.raises(TypeError):                       # container dtype
        fn(x, bad_q, s)
    with pytest.raises(TypeError):                       # f16 scale
        fn(x, q, s.half())
    with pytest.raises(ValueError, match="bad ranks"):
        fn(x, q, bad_s)
    with pytest.raises(ValueError, match="bad ranks"):
        fn(x[0], q, s)
    with pytest.raises(ValueError):                      # In mismatch
        fn(torch.zeros((1, 2, 64)), q, s)
    # on the CPU every wrapper is its plain version and launches nothing
    counter = tqm.int4_matmul if name == "int4_matmul_wide" else fn
    before = counter.launches
    plain = {"int8": tqm.int8_matmul_plain, **PLAIN}[name.split("_")[0]]
    xr = torch.from_numpy(_weights(9, (1, 2, 128)))
    assert torch.equal(fn(xr, q, s), plain(xr, q, s))
    assert counter.launches == before
    # what the kernels need of a CUDA tensor is checked before any launch:
    # a device mix and a dtype the kernel does not take raise
    with pytest.raises(ValueError, match="share one device"):
        tqm._check_launch(name, x, q, s)
    with pytest.raises(ValueError, match="share one device"):
        tqm._check_launch(name, x.to("meta"), q, s)


def test_bridge_tells_nf4_from_int4_and_refuses_to_guess():
    w = jnp.asarray(_weights(8, (128, 32)))
    for jfn, cls in ((jq.quantize_nf4, tq.NF4Tensor),
                     (jq.quantize_int4, tq.Int4Tensor),
                     (jq.quantize_int8, tq.Int8Tensor)):
        d = to_numpy_dict(jfn(w))
        got = bridge.weight(d, device="cpu")
        assert type(got) is cls
        np.testing.assert_array_equal(got.q.numpy(), d["q"])
    d = to_numpy_dict(jq.quantize_nf4(w))
    with pytest.raises(ValueError, match="nf4 or int4"):
        bridge.weight({"q": d["q"], "scale": d["scale"]})
    with pytest.raises(ValueError, match="not in"):
        bridge.weight({**d, "kind": "fp4"})
    with pytest.raises(TypeError):
        bridge.weight({**d, "kind": "int8"})
    i8 = to_numpy_dict(jq.quantize_int8(w))
    assert type(bridge.weight({"q": i8["q"], "scale": i8["scale"]},
                              device="cpu")) \
        is tq.Int8Tensor


def test_matmul_plan_int4_tiles_k_like_nf4_without_the_table():
    # the 13B attention projections at verify and prefill width, ragged
    # strips and a prime block count: the same cut as nf4, 8 KB less
    for m, n_in, n_out in [(81, 5120, 5120), (64, 5120, 5120),
                           (33, 2368, 1088), (96, 832, 1056),
                           (130, 4096, 4096), (1, 64, 32)]:
        p4, pn = (tqm.matmul_plan(m, n_in, n_out, f) for f in ("int4", "nf4"))
        assert p4._replace(smem=0) == pn._replace(smem=0)
        assert p4.smem == pn.smem - tqm.NF4_LUT_BYTES == pn.smem - 8192
        _check_stream_k(p4, m, n_in // 64)
    with pytest.raises(ValueError, match="format"):
        tqm.smem_bytes(96, 5, "fp4")


@pytest.mark.parametrize("n_in,n_out", [(5120, 5120), (11008, 4096)])
def test_matmul_plan_small_m_int4_widths_cover_every_block(n_in, n_out):
    # the small-M route: every M the JAX package sends to its kfull kernel
    for m in range(1, tqm.SMALL_M + 1):
        p = tqm.matmul_plan(m, n_in, n_out, "int4")
        assert p.n == (16 if m <= 16 else 64) and p.bn == 128
        assert p.stages == tqm.WGMMA_STAGES[p.n] == 6
        _check_stream_k(p, m, n_in // 64)


@pytest.mark.parametrize("m", [1, 9, 16, 17, 32])
def test_int4_small_m_on_cpu_is_plain_and_launches_nothing(m):
    x = torch.from_numpy(_weights(10 + m, (1, m, 128))).to(torch.bfloat16)
    t = tq.quantize_int4(torch.from_numpy(_weights(3, (128, 64))))
    counters = (tqm.int4_matmul, tqm.int4_matmul_smallm,
                tqm.int4_matmul_splitk, tqm.int4_matmul_strip)
    before = [c.launches for c in counters]
    want = tqm.int4_matmul_plain(x, t.q, t.scale)
    for fn in (tqm.int4_matmul, tqm.int4_matmul_smallm,
               tqm.int4_matmul_splitk):
        assert torch.equal(fn(x, t.q, t.scale), want)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="bad ranks"):
        tqm.int4_matmul_splitk(x[0], t.q, t.scale)


def test_int4_decode_without_a_table_is_decode_pairs_operand():
    # every byte at scales that round differently in bf16: (128 + n) - 136
    # is n - 8 exactly, and one bf16 multiply rounds as decode_pair's does
    b = torch.arange(256, dtype=torch.int32)
    hi, lo = b >> 4, b & 15
    as_bf16 = lambda n: (n | 0x4300).to(torch.int16).view(torch.bfloat16)
    c136 = torch.tensor(0x4308, dtype=torch.int16).view(torch.bfloat16)
    assert float(c136) == 136.0
    for sc in (1.0, 0.0123, 3.3e-3, 7.77, 1e-30):
        s = torch.tensor(sc).to(torch.bfloat16)
        for nib in (hi, lo):
            got = (as_bf16(nib) - c136) * s
            want = (nib - 8).to(torch.bfloat16) * s
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # and the operand is the plain version's decode
    q = b.to(torch.uint8).reshape(128, 2).repeat(1, 16)        # (128, 32)
    scale = torch.full((4, 32), 0.0123)
    w = tqm._decode4_bf16(q, scale, nf4=False)
    s = torch.tensor(0.0123).to(torch.bfloat16)
    np.testing.assert_array_equal(
        w[0::2, :2].float().numpy(),
        ((as_bf16(hi) - c136) * s).reshape(128, 2).float().numpy())


def test_bridge_builds_on_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.tensor(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.weight(to_numpy_dict(jq.quantize_int8(jnp.ones((64, 32)))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.kv_cache({"k": a, "v": a, "length": 1})
    t = bridge.tensor(a, device="cpu")
    assert t.device.type == "cpu" and torch.equal(t, torch.from_numpy(a))
    w = bridge.weight(to_numpy_dict(jq.quantize_int8(jnp.ones((64, 32)))),
                      device="cpu")
    assert type(w) is tq.Int8Tensor and w.q.device.type == "cpu"
