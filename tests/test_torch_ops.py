"""The PyTorch port's kernel modules (plain versions, CPU) against the JAX
package's kernels run the way its own tests run them: Pallas in TPU
interpret mode, the head kernel with FLOWSPEC_HEAD_KERNEL=interpret, and
the XLA paths.

Tolerances: f32 algorithm checks at 1e-5 (only the summation order
differs); bf16 checks at 2e-2 absolute on O(1) outputs (bf16 keeps 8 bits,
and the online-softmax kernel rounds unnormalized probabilities where the
dense path rounds normalized ones). Attention rows compared all have at
least one live column: a fully masked row is garbage on every path.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flowspec_tpu.models.llama import _attention_blocked
from flowspec_tpu.ops import head_topk as jhead
from flowspec_tpu.ops import quant as jquant
from flowspec_tpu.ops import quant_matmul as jqm
from flowspec_tpu.ops.tree_attention import tree_attention as j_tree_attention
from flowspec_tpu_torch.ops import _build
from flowspec_tpu_torch.ops import head_topk as thead
from flowspec_tpu_torch.ops.head_topk import head_topk, head_topk_plain
from flowspec_tpu_torch.ops.quant import (
    Int8Tensor, dequantize, qmatmul, quantize_int8)
from flowspec_tpu_torch.ops.quant_matmul import WGMMA_STAGES, int8_matmul
from flowspec_tpu_torch.ops.tree_attention import (
    KEY_TILE, MAX_SPLITS, MAX_WARPS, TILE_WARPS, WAVE_BLOCKS, attention_plan,
    kernel_keys, live_keys, tree_attention, tree_attention_plain,
    tree_attention_simt)
from tests.torch_bridge_util import np_of

ROOT = Path(__file__).resolve().parent.parent


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# ---- int8 dequant-matmul ---------------------------------------------------

@pytest.mark.parametrize("m", [1, 10, 33])
def test_quantize_int8_byte_identical(m):
    w = np.random.default_rng(m).standard_normal((64, 96)).astype(np.float32)
    w[:, 5] = 0.0                                 # the absmax floor
    want = jquant.quantize_int8(jnp.asarray(w))
    got = quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(dequantize(got).numpy(),
                                  np.asarray(jquant.dequantize(want)))


@pytest.mark.parametrize("t", [1, 10, 96])
def test_int8_matmul_f32_matches_pallas_and_xla(t):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((1, t, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    jw = jquant.quantize_int8(jnp.asarray(w))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = np.asarray(jqm.int8_matmul(jnp.asarray(x), jw.q,
                                                 jw.scale))
    want_xla = np.asarray(jquant.qmatmul(jnp.asarray(x), jw))
    w8 = Int8Tensor(q=torch.from_numpy(np.asarray(jw.q)),
                    scale=torch.from_numpy(np.asarray(jw.scale)))
    got = int8_matmul(torch.from_numpy(x), w8.q, w8.scale).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)
    # qmatmul flattens any leading shape onto the same function
    got2 = qmatmul(torch.from_numpy(x[0]), w8).numpy()
    np.testing.assert_allclose(got2, got[0], rtol=0, atol=0)
    assert int8_matmul.launches == 0          # the CPU never launches


def test_int8_matmul_bf16_matches_pallas():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 10, 256)).astype(np.float32)
    jw = jquant.quantize_int8(jnp.asarray(
        rng.standard_normal((256, 128)).astype(np.float32)))
    xb = jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm.int8_matmul(xb, jw.q, jw.scale), np.float32)
    got = int8_matmul(_bf16(np.asarray(xb, np.float32)),
                      torch.from_numpy(np.asarray(jw.q)),
                      torch.from_numpy(np.asarray(jw.scale)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np_of(got), want, rtol=2e-2, atol=2e-2)


def test_qmatmul_rejects_unported_containers():
    # every container of the JAX package is ported; anything else is no weight
    with pytest.raises(TypeError, match="not a weight"):
        qmatmul(torch.zeros(1, 1, 64), object())


# ---- tree attention --------------------------------------------------------

def _attn_case(seed, nq, nkv, t, s, d, ctx_end):
    """Tree-style bias: context [0, ctx_end) visible, a random ancestor mask
    over the tree rows [ctx_end, ctx_end+t), -1e9 beyond (so every row has
    live columns and n_valid = ctx_end + t)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, nq, t, d)).astype(np.float32)
    k = rng.standard_normal((1, nkv, s, d)).astype(np.float32)
    v = rng.standard_normal((1, nkv, s, d)).astype(np.float32)
    tree = np.tril(rng.random((t, t)) < 0.4) | np.eye(t, dtype=bool)
    bias = np.full((t, s), -1e9, np.float32)
    bias[:, :ctx_end] = 0.0
    bias[:, ctx_end:ctx_end + t] = np.where(tree, 0.0, -1e9)
    return q, k, v, bias


CASES = [(g, t) for g in (1, 4) for t in (1, 10, 96)]


@pytest.mark.parametrize("g,t", CASES)
def test_tree_attention_matches_pallas_interpret(g, t):
    nkv, s, d, ctx_end = 2, 512, 64, 37
    q, k, v, bias = _attn_case(g * 100 + t, nkv * g, nkv, t, s, d, ctx_end)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_tree_attention(qb, kb, vb, jnp.asarray(bias),
                                           block_s=256), np.float32)
    got = tree_attention(*(_bf16(np.asarray(a, np.float32))
                           for a in (qb, kb, vb)),
                         torch.from_numpy(bias), n_valid=ctx_end + t)
    assert live_keys(s, ctx_end + t) == 256      # half the KV is never read
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("g,t", CASES)
def test_tree_attention_matches_blocked_path(g, t):
    nkv, s, d, ctx_end = 2, 512, 64, 300             # 3 live blocks of 256
    q, k, v, bias = _attn_case(g * 10 + t, nkv * g, nkv, t, s, d, ctx_end)
    n_valid = ctx_end + t
    want = np.asarray(_attention_blocked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), g,
        jnp.asarray(n_valid, jnp.int32)))
    got = tree_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         torch.from_numpy(bias), n_valid=n_valid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tree_attention_rejects_bad_bias():
    q = torch.zeros(1, 2, 3, 64)
    kv = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError):
        tree_attention(q, kv, kv, torch.zeros(3, 128))


# (nkv, G, T, n_valid, S): the serve paths' shapes (7B / 13B verify, prefill
# chunk, AR step, thin draft context and beam level, late verify rounds past
# 256 live rows), GQA groups, ragged n_valid around tile and split edges,
# and caches longer than 8 tiles a split
PLAN_CASES = ([(32, 1, 81, 209, 512), (32, 1, 96, 224, 512),
               (32, 1, 64, 64, 512), (32, 1, 1, 200, 512),
               (8, 1, 9, 150, 512), (8, 1, 10, 230, 512),
               (40, 1, 81, 273, 512), (32, 1, 81, 273, 512),
               (40, 1, 1, 200, 512)]
              + [(4, g, t, nv, 512) for g in (1, 4) for t in (1, 10, 33)
                 for nv in (1, 63, 64, 65, 256, 257, 511, 512)]
              + [(2, 2, 17, nv, 2560) for nv in (513, 600, 1100, 2560)])


@pytest.mark.parametrize("nkv,g,t,n_valid,s_max", PLAN_CASES)
def test_attention_plan_covers_every_key_once(nkv, g, t, n_valid, s_max):
    n_keys = kernel_keys(s_max, n_valid)
    assert n_keys % KEY_TILE == 0 and n_valid <= n_keys <= s_max
    assert n_keys - n_valid < KEY_TILE          # only the last tile ragged
    p = attention_plan(nkv, g, t, n_keys)
    assert p.n_keys == n_keys and 1 <= p.splits <= MAX_SPLITS
    tiles = n_keys // KEY_TILE
    edges = [(i * p.tiles_per_split, min((i + 1) * p.tiles_per_split, tiles))
             for i in range(p.splits)]
    keys = [k for a, b in edges for k in range(a * KEY_TILE, b * KEY_TILE)]
    assert keys == list(range(n_keys))          # each key once, in order
    assert all(a < b for a, b in edges)         # no empty split
    # rows: every one of the KV head's G*T rows in exactly one row tile,
    # at most MAX_WARPS warps of 16 rows a block and no all-empty row tile;
    # blocks of more than TILE_WARPS only where the grid would pass a wave
    rows = g * t
    assert 1 <= p.warps <= MAX_WARPS
    assert (p.row_tiles - 1) * 16 * p.warps < rows <= p.row_tiles * 16 * p.warps
    assert p.blocks == nkv * p.row_tiles * p.splits
    assert p.warps <= TILE_WARPS or (
        nkv * -(-rows // (16 * TILE_WARPS)) * p.splits > WAVE_BLOCKS)
    if tiles <= MAX_SPLITS:
        assert p.splits == tiles and p.tiles_per_split == 1


@pytest.mark.parametrize("s_max", [256, 512, 768, 1024, 2560])
def test_attention_plan_host_grid_groups_tiles_as_the_allocation(s_max):
    """A host n_valid's grid (the live tiles) takes the allocation's tiles
    a split, so its splits sum the keys the device n_valid's grid (planned
    for the allocation) sums: equal bits. Up to 512 rows that is one tile a
    split, the plan without the allocation."""
    for nkv, g, t in ((32, 1, 18), (32, 1, 192), (8, 1, 25), (4, 4, 9)):
        dev = attention_plan(nkv, g, t, s_max)
        for n_valid in (1, 64, 65, 194, 320, 511, 700, s_max):
            if n_valid > s_max:
                continue
            n_keys = kernel_keys(s_max, n_valid)
            p = attention_plan(nkv, g, t, n_keys, alloc_keys=s_max)
            assert p.tiles_per_split == dev.tiles_per_split
            tiles = n_keys // KEY_TILE
            assert p.splits == -(-tiles // p.tiles_per_split)
            assert 1 <= p.splits <= MAX_SPLITS and p.n_keys == n_keys
            if s_max <= 512:
                assert p == attention_plan(nkv, g, t, n_keys)


def test_attention_plan_main_path_grids_and_refusals():
    # 7B verify: 2 row tiles x 4 splits x 32 heads; the thin draft's 8 heads
    # at 150-230 live rows: 3-4 splits (the earlier kernel ran 96 / 8 blocks)
    p = attention_plan(32, 1, 81, kernel_keys(512, 209))
    assert (p.warps, p.row_tiles, p.splits, p.blocks) == (3, 2, 4, 256)
    assert attention_plan(32, 1, 1, 256).blocks == 128
    assert attention_plan(8, 1, 10, kernel_keys(512, 230)).blocks == 32
    # 13B late verify: 400 blocks of 3 warps would run in two waves
    assert attention_plan(40, 1, 81, kernel_keys(512, 273))[:3] == (6, 1, 5)
    assert attention_plan(32, 1, 81, kernel_keys(512, 273)).blocks == 320
    assert attention_plan(32, 1, 64, 64)[:3] == (2, 2, 1)
    assert attention_plan(32, 1, 96, 512).splits == 8
    assert kernel_keys(512, None) == 512 and kernel_keys(512, 0) == 64
    for bad in [(0, 1, 1, 64), (1, 1, 1, 0), (1, 1, 1, 96), (1, 0, 1, 64)]:
        with pytest.raises(ValueError, match="attention_plan needs"):
            attention_plan(*bad)


def _split_combine(q, k, v, bias, n_valid):
    """What csrc/tree_attention.cu computes, in plain torch on the CPU: per
    split of `attention_plan`, an online softmax over its 64-key tiles (f32
    scores, P rounded to q's dtype before PV, l from the f32 P, f32 acc);
    then the splits joined in ascending order, acc / max(l, 1e-30), one
    cast."""
    nq, t, d = q.shape[1:]
    nkv, s_max = k.shape[1:3]
    g = nq // nkv
    plan = attention_plan(nkv, g, t, kernel_keys(s_max, n_valid))
    qg = q[0].float().reshape(nkv, g * t, d)
    bias_g = bias.float().repeat(g, 1)            # row r -> bias[r % T]
    tiles = plan.n_keys // KEY_TILE
    parts = []
    for sp in range(plan.splits):
        m = torch.full((nkv, g * t), float("-inf"))
        l = torch.zeros((nkv, g * t))
        acc = torch.zeros((nkv, g * t, d))
        for tile in range(sp * plan.tiles_per_split,
                          min((sp + 1) * plan.tiles_per_split, tiles)):
            ks = slice(tile * KEY_TILE, (tile + 1) * KEY_TILE)
            sc = (qg @ k[0, :, ks].float().transpose(-1, -2) * d ** -0.5
                  + bias_g[:, ks])
            m_new = torch.maximum(m, sc.max(-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(q.dtype).float() @ \
                v[0, :, ks].float()
            m = m_new
        parts.append((m, l, acc))
    mmax = torch.stack([m for m, _, _ in parts]).max(0).values
    den = torch.zeros_like(mmax)
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - mmax)
        den = den + l * w
        num = num + acc * w[..., None]
    out = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.reshape(1, nq, t, d)


@pytest.mark.parametrize("g,t,d,ctx_end,s", [
    (1, 81, 128, 128, 512), (4, 10, 64, 300, 512), (1, 1, 128, 199, 512),
    (2, 17, 64, 900, 1024)])
def test_split_combine_matches_plain_and_pallas(g, t, d, ctx_end, s):
    nkv = 2
    q, k, v, bias = _attn_case(g + t + d, nkv * g, nkv, t, s, d, ctx_end)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_tree_attention(qb, kb, vb, jnp.asarray(bias),
                                           block_s=256), np.float32)
    tq_, tk, tv = (_bf16(np.asarray(a, np.float32)) for a in (qb, kb, vb))
    tb = torch.from_numpy(bias)
    n_valid = ctx_end + t
    got = _split_combine(tq_, tk, tv, tb, n_valid)
    plain = tree_attention_plain(tq_, tk, tv, tb, live_keys(s, n_valid))
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=2e-2)
    np.testing.assert_allclose(np_of(got), np_of(plain), rtol=0, atol=2e-2)
    # the kernel reads fewer rows than the plain version where n_valid
    # stops short of a 256-row block
    assert kernel_keys(s, n_valid) <= live_keys(s, n_valid)


def test_tree_attention_simt_runs_plain_on_cpu_and_refuses():
    q, k, v, bias = _attn_case(5, 4, 2, 10, 512, 64, 100)
    tq_, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    before = tree_attention_simt.launches, tree_attention.launches
    got = tree_attention_simt(tq_, tk, tv, tb, n_valid=110)
    assert torch.equal(got, tree_attention_plain(tq_, tk, tv, tb, 256))
    assert torch.equal(got, tree_attention(tq_, tk, tv, tb, n_valid=110))
    assert (tree_attention_simt.launches, tree_attention.launches) == before
    with pytest.raises(ValueError, match="bias must be"):
        tree_attention_simt(tq_, tk, tv, tb[:, :256])
    with pytest.raises(ValueError, match="bad shapes"):
        tree_attention_simt(tq_[0], tk, tv, tb)
    with pytest.raises(ValueError, match="bad shapes"):   # nq % nkv
        tree_attention_simt(tq_[:, :3], tk, tv, tb)


# ---- fused head top-k ------------------------------------------------------

def _head_case(t, h, v, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, h)).astype(np.float32)
    q = rng.integers(-127, 128, (h, v)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, (v,)) * 1e-2).astype(np.float32)
    return x, q, s


def _jax_head(monkeypatch, x, q, s, k):
    monkeypatch.setenv("FLOWSPEC_HEAD_KERNEL", "interpret")
    lp, tok = jhead.head_topk(jnp.asarray(x), jquant.Int8Tensor(
        q=jnp.asarray(q), scale=jnp.asarray(s)), k)
    return np.asarray(lp), np.asarray(tok)


@pytest.mark.parametrize("t,v,k", [(1, 2048, 10), (10, 4096, 10),
                                   (40, 32000, 10)])
def test_head_topk_matches_interpret_kernel(monkeypatch, t, v, k):
    # (40, 32000): the JAX kernel splits V into several column groups and
    # merges their partials (head_topk.py:173-180)
    x, q, s = _head_case(t, 128, v, seed=t)
    want_lp, want_tok = _jax_head(monkeypatch, x, q, s, k)
    got_lp, got_tok = head_topk(torch.from_numpy(x), Int8Tensor(
        q=torch.from_numpy(q), scale=torch.from_numpy(s)), k)
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-5, atol=1e-5)


def test_head_topk_tie_goes_to_lowest_index(monkeypatch):
    x, q, s = _head_case(3, 128, 2048, seed=5)
    # make column 1900 an exact copy of column 77 and column 1200 of 700:
    # equal logits, so the lower id must come first in both packages
    q[:, 1900], s[1900] = q[:, 77], s[77]
    q[:, 1200], s[1200] = q[:, 700], s[700]
    lse_cols = (x @ (q.astype(np.float32) * s))
    best = int(np.argmax(lse_cols[0]))
    q[:, 1500], s[1500] = q[:, best], s[best]      # a tie at the top
    want_lp, want_tok = _jax_head(monkeypatch, x, q, s, 8)
    got_lp, got_tok = head_topk_plain(torch.from_numpy(x), torch.from_numpy(q),
                                      torch.from_numpy(s), 8)
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=1e-5, atol=1e-5)
    row = list(got_tok[0].numpy())
    assert row.index(min(best, 1500)) + 1 == row.index(max(best, 1500))


def test_head_topk_dense_head_matches_xla():
    x, q, s = _head_case(4, 64, 512, seed=9)
    w = (q.astype(np.float32) * s).astype(np.float32)
    want_lp, want_tok = jhead._head_topk_xla(jnp.asarray(x), jnp.asarray(w), 6)
    got_lp, got_tok = head_topk(torch.from_numpy(x), torch.from_numpy(w), 6)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=1e-5, atol=1e-5)


def _order_keys(v: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The head kernel's 64-bit order keys (csrc/head_topk.cu order_key):
    float bits mapped to an unsigned order, high word; ~index, low word."""
    u = (v.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    hi = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    return (hi << np.uint64(32)) | (~idx.astype(np.uint32)).astype(np.uint64)


def _head_by_strips(logits: np.ndarray, k: int):
    """What csrc/head_topk.cu computes from the f32 logits, step by step:
    per 128-column strip the max, the sum of exp and the top-k keys in
    order; then per row the logsumexp over strips and k rounds, each taking
    the largest key below the last round's among the strips' entries at
    positions <= j."""
    t, v = logits.shape
    strips = logits.reshape(t, v // 128, 128)
    idx = np.arange(v).reshape(v // 128, 128)
    mx = strips.max(-1)
    se = np.exp(strips - mx[..., None]).sum(-1)
    keys = np.sort(_order_keys(strips, np.broadcast_to(idx, strips.shape)),
                   axis=-1)[..., ::-1][..., :k]           # (T, strips, k)
    m = mx.max(-1, keepdims=True)
    lse = (m + np.log((se * np.exp(mx - m)).sum(-1, keepdims=True)))[:, 0]
    lp = np.zeros((t, k), np.float32)
    tok = np.zeros((t, k), np.int32)
    for r in range(t):
        prev = np.uint64(2 ** 64 - 1)
        for j in range(k):
            cand = keys[r, :, :j + 1].ravel()
            best = cand[cand < prev].max()
            prev = best
            hi = np.uint32(best >> np.uint64(32))
            bits = hi & 0x7FFFFFFF if hi & 0x80000000 else ~hi
            lp[r, j] = np.array([bits], np.uint32).view(np.float32)[0] - lse[r]
            tok[r, j] = int(~np.uint32(best & np.uint64(0xFFFFFFFF)))
    return lp, tok


@pytest.mark.parametrize("t,v,k", [(3, 1024, 10), (2, 256, 128), (4, 2176, 1)])
def test_head_kernel_strips_and_key_merge_match_plain(t, v, k):
    x, q, s = _head_case(t, 64, v, seed=v + k)
    # ties inside one strip (130 <- 129), across strips (700 <- 3) and at
    # the top of row 0
    q[:, 130], s[130] = q[:, 129], s[129]
    q[:, 700 % v], s[700 % v] = q[:, 3], s[3]
    lg = x @ (q.astype(np.float32) * s)
    best = int(np.argmax(lg[0]))
    dup = (best + 128) % v if best + 128 < v else best - 128
    q[:, dup], s[dup] = q[:, best], s[best]
    tx, tq_, ts = (torch.from_numpy(a) for a in (x, q, s))
    logits = thead.head_logits(tx, Int8Tensor(q=tq_, scale=ts)).numpy()
    got_lp, got_tok = _head_by_strips(logits, k)
    want_lp, want_tok = head_topk_plain(tx, tq_, ts, k)
    np.testing.assert_array_equal(got_tok, want_tok.numpy())
    np.testing.assert_allclose(got_lp, want_lp.numpy(), rtol=1e-5, atol=1e-5)
    if k > 1:
        assert list(got_tok[0, :2]) == sorted([best, dup])


@pytest.mark.parametrize("t,h", [(1, 4096), (10, 4096), (1, 5120), (10, 5120),
                                 (16, 4096), (17, 4096), (65, 256)])
@pytest.mark.parametrize("v", [32000, 2176])
def test_head_plan_covers_every_strip_and_k_block(t, h, v):
    p = thead.head_plan(t, h, v)
    # strips x row tiles: every (row, 128-column strip) in exactly one block
    assert p.strips * 128 == v and p.row_tiles * p.n >= t
    assert (p.row_tiles - 1) * p.n < t
    assert p.n == (16 if t <= 16 else 64)
    # one split of every 64-row K block, none empty
    nkb = h // 64
    edges = [(i * p.chunk, min((i + 1) * p.chunk, nkb))
             for i in range(p.ksplit)]
    assert edges[0][0] == 0 and edges[-1][1] == nkb
    assert all(a < b for a, b in edges)
    # the ring of the width, two blocks to an SM, and the parked logits fit
    assert p.stages == WGMMA_STAGES[p.n]
    assert 2 * (p.smem + 1024) <= 227 * 1024
    assert p.n * (128 + 4) * 4 <= p.smem - 1024
    # at V 32000 the strips alone fill the card: about two blocks an SM
    if v == 32000:
        assert 132 < p.strips * p.row_tiles <= 2 * 132 or t > 16


def test_head_plan_refuses_what_the_kernel_does_not_take():
    for t, h, v in [(1, 4096, 32000 + 64), (1, 4096, 100), (0, 4096, 32000),
                    (1, 4000, 32000), (1, 0, 32000)]:
        with pytest.raises(ValueError, match="head_plan needs"):
            thead.head_plan(t, h, v)


def test_head_topk_strip_runs_plain_on_cpu_and_counts_nothing():
    x, q, s = _head_case(3, 128, 2048, seed=11)
    tx, tq_, ts = (torch.from_numpy(a) for a in (x, q, s))
    before = head_topk.launches, thead.head_topk_strip.launches
    for fn in (thead.head_topk_int8, thead.head_topk_strip):
        lp, tok = fn(tx, tq_, ts, 7)
        want_lp, want_tok = head_topk_plain(tx, tq_, ts, 7)
        assert torch.equal(tok, want_tok) and torch.equal(lp, want_lp)
        with pytest.raises(ValueError, match="k=0 out of range"):
            fn(tx, tq_, ts, 0)
        with pytest.raises(TypeError):
            fn(tx, tq_.to(torch.int16), ts, 4)
    assert (head_topk.launches, thead.head_topk_strip.launches) == before


# ---- the package's boundaries ----------------------------------------------

def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flowspec_tpu)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "flowspec_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        assert not bad.search(f.read_text()), f


def test_kernel_build_keys_on_source_hash():
    names = {_build.lib_path(n).name for n in _build.KERNELS}
    assert len(names) == 7
    for n in _build.KERNELS:
        assert (_build.CSRC / f"{n}.cu").exists()
        assert _build.lib_path(n).parent == _build.BUILD_DIR


def test_smoke_run_splits_launches_into_prefills_and_rounds():
    # the card script's accounting: a serve run's count less one prefill a
    # request, over its rounds, must be the expected launches per round
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    expected = {"int8_matmul": 305, "tree_attention": 41, "head_topk": 9}
    prefill = {"int8_matmul": 242, "tree_attention": 34, "head_topk": 0,
               "nf4_matmul": 0}
    counted = {"int8_matmul": 64 * 305 + 3 * 242,
               "tree_attention": 64 * 41 + 3 * 34, "head_topk": 64 * 9,
               "nf4_matmul": 0}
    assert chip_smoke.launches_per_round(
        "7b_int8", counted, prefill, 3, 64, expected) == {
            "int8_matmul": 305, "tree_attention": 41, "head_topk": 9,
            "nf4_matmul": 0}
    for kernel, off in (("int8_matmul", 1), ("int8_matmul", 64),
                        ("nf4_matmul", 64)):
        with pytest.raises(AssertionError, match=kernel):
            chip_smoke.launches_per_round(
                "7b_int8", {**counted, kernel: counted[kernel] + off},
                prefill, 3, 64, expected)
