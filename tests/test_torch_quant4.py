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
(d) the split plan of the split-K wgmma kernels (`matmul_plan`, shared by
    int8, nf4 and int4) over every (M, In, Out) the wrappers accept, with
    hypothesis: the splits tile [0, In/64) exactly and none is empty, the
    strip width divides Out, the width covers M (or M runs in 128-row
    tiles), the ring fits an SM, the scratch has the shape the wrapper
    allocates; and `_split_sum`, a torch emulation of "one f32 partial per
    split, added in ascending order, scale, one cast" driven by that plan,
    against `int8_matmul_plain` / `nf4_matmul_plain` / `int4_matmul_plain`
    at the card's tolerance (|err| <= 1e-2*|plain| + 1e-2: one bf16 ulp of
    an f32 sum taken in another order); and the int4 kernel's table-free
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
    # splits tile [0, In/64) exactly, in order, none empty
    edges = [(s * p.chunk, min((s + 1) * p.chunk, nkb))
             for s in range(p.ksplit)]
    assert edges[0][0] == 0 and edges[-1][1] == nkb
    assert all(a < b for a, b in edges)
    assert all(edges[i][1] == edges[i + 1][0] for i in range(p.ksplit - 1))
    # one wave: never more blocks than the plan's two per SM, unless the
    # strips x row tiles alone exceed it (then one split)
    tiles = (n_out // p.bn) * -(-m // p.n)
    assert (tiles * p.ksplit <= tqm.N_SMS * tqm.BLOCKS_PER_SM
            or p.ksplit == 1)
    # the ring is the one the width is built with and two blocks fit an SM
    assert p.stages == tqm.WGMMA_STAGES[p.n]
    assert p.smem == tqm.smem_bytes(p.n, p.stages, fmt)
    assert tqm.BLOCKS_PER_SM * (p.smem + 1024) <= tqm.SMEM_PER_SM
    # scratch as the wrapper allocates it
    assert p.scratch_shape(m, n_out) == (
        (p.ksplit, m, n_out) if p.ksplit > 1 else None)


def test_matmul_plan_main_path_shapes_and_refusals():
    # 7B verify width: two blocks per SM at every projection
    for n_in, n_out in [(4096, 4096), (4096, 11008), (11008, 4096)]:
        p = tqm.matmul_plan(81, n_in, n_out, "int8")
        assert (p.bn, p.n) == (128, 96)
        assert 132 < (n_out // 128) * p.ksplit <= 264
    # M 1 (every AR step) and the draft's M 10 are the narrow width with
    # more splits: the thin draft's fc gets 32 x 8 blocks where a grid over
    # strips alone had 32
    p = tqm.matmul_plan(10, 8192, 1024, "nf4")
    assert (p.n, p.ksplit, p.chunk) == (16, 32, 4)
    assert tqm.matmul_plan(1, 4096, 4096, "nf4").ksplit == 8
    # one 64-row block cannot split; M > 128 runs in row tiles of 128
    assert tqm.matmul_plan(8, 64, 1056, "int8").ksplit == 1
    assert tqm.matmul_plan(130, 4096, 4096, "nf4").n == 128
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
    """What the wgmma kernels compute, in plain torch: one f32 partial per K
    split of `plan` (x (..., In) times the bf16 operand w (In, Out)), the
    partials added in ascending order, the int8 per-column scale if any, one
    cast to x's dtype."""
    step = plan.chunk * tq.NF4_BLOCK
    total = None
    for s in range(plan.ksplit):
        k0, k1 = s * step, min((s + 1) * step, x.shape[-1])
        part = torch.matmul(x[..., k0:k1].to(torch.float32),
                            w[k0:k1].to(torch.float32))
        total = part if total is None else total + part
    if scale is not None:
        total = total * scale.to(torch.float32)
    return total.to(x.dtype)


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
    if plan.ksplit == 1:                  # one split: the plain sum itself
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
        nkb = n_in // 64
        edges = [(i * p4.chunk, min((i + 1) * p4.chunk, nkb))
                 for i in range(p4.ksplit)]
        assert edges[0][0] == 0 and edges[-1][1] == nkb
        assert all(a < b for a, b in edges)
        assert all(edges[i][1] == edges[i + 1][0]
                   for i in range(p4.ksplit - 1))
    with pytest.raises(ValueError, match="format"):
        tqm.smem_bytes(96, 5, "fp4")


@pytest.mark.parametrize("n_in,n_out", [(5120, 5120), (11008, 4096)])
def test_matmul_plan_small_m_int4_widths_cover_every_block(n_in, n_out):
    # the small-M route: every M the JAX package sends to its kfull kernel
    nkb = n_in // 64
    for m in range(1, tqm.SMALL_M + 1):
        p = tqm.matmul_plan(m, n_in, n_out, "int4")
        assert p.n == (16 if m <= 16 else 64) and p.bn == 128
        assert p.stages == tqm.WGMMA_STAGES[p.n] == 6
        edges = [(i * p.chunk, min((i + 1) * p.chunk, nkb))
                 for i in range(p.ksplit)]
        assert edges[0][0] == 0 and edges[-1][1] == nkb
        assert all(a < b for a, b in edges)
        assert all(edges[i][1] == edges[i + 1][0]
                   for i in range(p.ksplit - 1))
        assert (n_out // p.bn) * p.ksplit <= tqm.N_SMS * tqm.BLOCKS_PER_SM


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
