"""The PyTorch port's model layer against the JAX package on the CPU:
rms_norm, rope, attention_block, llama_forward, KVCache.compact, the bias
builders and tree_attention_bias, with inputs made by numpy from a seed.

f32 checks at 1e-5 (summation order only); bf16 checks at 2e-2 absolute on
O(1) values (bf16 keeps 8 bits; both sides round at the same points).
Packed 4-bit weights (nf4, int4, mixed) are quantized by JAX and carried
over the bridge; the port decodes them in bf16 as the TPU kernels do, so
against JAX's f32 dequant path the hidden states and logits are held to
1e-2 of their largest value, and against the Pallas kernels in interpret
mode (which at f32 keep the bf16 value and scale but not the product's
rounding) to 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import ModelConfig as JModelConfig
from flowspec_tpu.models import bias as jbias
from flowspec_tpu.models import llama as jl
from flowspec_tpu.models.kv_cache import KVCache as JKVCache, init_kv_cache
from flowspec_tpu.ops import quant as jquant
from flowspec_tpu.tree import types as jtypes
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.models import bias as tbias
from flowspec_tpu_torch.models import llama as tl
from flowspec_tpu_torch.ops import quant as tquant
from flowspec_tpu_torch.tree import types as ttypes
from tests.torch_bridge_util import np_of, port_cache, port_llama

F32 = dict(rtol=1e-5, atol=1e-5)


def _cfgs(n_layers=2, dtype="float32"):
    jc = dataclasses.replace(JModelConfig.tiny(n_layers=n_layers),
                             dtype=dtype)
    return jc, tcfg.ModelConfig(**dataclasses.asdict(jc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4, 7, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    pos = np.array([0, 1, 5, 9, 9, 30, 100], np.int32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    tol = F32 if dtype == "float32" else dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(
        np_of(tl.rms_norm(tx, torch.from_numpy(w), 1e-5)),
        np.asarray(jl.rms_norm(jx, jnp.asarray(w), 1e-5), np.float32), **tol)
    np.testing.assert_allclose(
        np_of(tl.rope(tx, torch.from_numpy(pos), 10000.0)),
        np.asarray(jl.rope(jx, jnp.asarray(pos), 10000.0), np.float32), **tol)


def _params(jc, quant):
    p = jl.init_llama_params(jax.random.key(0), jc, dtype=jnp.float32)
    return jl.quantize_llama_params(p, "int8") if quant else p


@pytest.mark.parametrize("quant", [False, True])
def test_attention_block_writes_kv_and_matches(quant):
    jc, tc = _cfgs()
    jp = _params(jc, quant)
    tp = port_llama(jp)
    rng = np.random.default_rng(1)
    t, s, start = 5, 256, 40
    x = rng.standard_normal((1, t, jc.hidden_size)).astype(np.float32)
    kc = rng.standard_normal((1, jc.num_key_value_heads, s,
                              jc.head_dim_)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    pos = np.arange(start, start + t, dtype=np.int32)
    bias = np.asarray(jbias.prefill_bias(jnp.asarray(start), t, s))
    lp0 = jax.tree_util.tree_map(lambda a: a[0], jp.layers)
    want, wk, wv = jl.attention_block(
        jnp.asarray(x), lp0.wq, lp0.wk, lp0.wv, lp0.wo, jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos), jnp.asarray(bias),
        jnp.asarray(start), jc, bq=lp0.bq, bk=lp0.bk, bv=lp0.bv)
    tl0 = tp.layers.layer(0)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tl.attention_block(
        torch.from_numpy(x), tl0.wq, tl0.wk, tl0.wv, tl0.wo, tk, tv,
        torch.from_numpy(pos), torch.from_numpy(bias), start, tc,
        bq=tl0.bq, bk=tl0.bk, bv=tl0.bv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), **F32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), **F32)


def test_attention_block_clamps_the_kv_write():
    # a write starting past S - T lands at S - T, as dynamic_update_slice
    jc, tc = _cfgs()
    jp = _params(jc, False)
    tp = port_llama(jp)
    t, s, start = 4, 256, 254
    x = np.random.default_rng(2).standard_normal(
        (1, t, jc.hidden_size)).astype(np.float32)
    kc = np.zeros((1, jc.num_key_value_heads, s, jc.head_dim_), np.float32)
    pos = np.arange(t, dtype=np.int32)
    bias = np.zeros((t, s), np.float32)
    lp0 = jax.tree_util.tree_map(lambda a: a[0], jp.layers)
    _, wk, _ = jl.attention_block(
        jnp.asarray(x), lp0.wq, lp0.wk, lp0.wv, lp0.wo, jnp.asarray(kc),
        jnp.asarray(kc), jnp.asarray(pos), jnp.asarray(bias),
        jnp.asarray(start), jc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(kc.copy())
    tl0 = tp.layers.layer(0)
    tl.attention_block(torch.from_numpy(x), tl0.wq, tl0.wk, tl0.wv, tl0.wo,
                       tk, tv, torch.from_numpy(pos), torch.from_numpy(bias),
                       start, tc)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), **F32)
    assert np.abs(tk.numpy()[:, :, s - t:]).sum() > 0


@pytest.mark.parametrize("quant", [False, True])
def test_llama_forward_matches(quant):
    jc, tc = _cfgs(n_layers=3)
    jp = _params(jc, quant)
    tp = port_llama(jp)
    t, s, start = 6, 256, 17
    rng = np.random.default_rng(3)
    cache = init_kv_cache(3, 1, jc.num_key_value_heads, s, jc.head_dim_,
                          jnp.float32)
    cache = JKVCache(k=jnp.asarray(rng.standard_normal(cache.k.shape),
                                   jnp.float32),
                     v=jnp.asarray(rng.standard_normal(cache.v.shape),
                                   jnp.float32),
                     length=jnp.asarray(start, jnp.int32))
    tcache = port_cache(cache)
    hidden = rng.standard_normal((1, t, jc.hidden_size)).astype(np.float32)
    pos = np.arange(start, start + t, dtype=np.int32)
    bias = np.asarray(jbias.prefill_bias(jnp.asarray(start), t, s))
    want, wcache = jl.llama_forward(jp, cache, jnp.asarray(hidden),
                                    jnp.asarray(pos), jnp.asarray(bias),
                                    jnp.asarray(start), jc)
    got, gcache = tl.llama_forward(tp, tcache, torch.from_numpy(hidden),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(bias), start, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gcache.k.numpy(), np.asarray(wcache.k), **F32)
    np.testing.assert_allclose(
        tl.lm_head_logits(tp, tl.final_hidden(tp, got, tc)).numpy(),
        np.asarray(jl.lm_head_logits(jp, jl.final_hidden(jp, want, jc))),
        **F32)


@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["nf4", "int4", "mixed"])
def test_llama_forward_matches_with_4bit_weights(kind, path, monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    jc, tc = _cfgs(n_layers=3)
    jp = jl.quantize_llama_params(
        jl.init_llama_params(jax.random.key(0), jc, dtype=jnp.float32), kind)
    tp = port_llama(jp)
    want_cls = {"nf4": (tquant.NF4Tensor, tquant.NF4Tensor),
                "int4": (tquant.Int4Tensor, tquant.Int4Tensor),
                "mixed": (tquant.Int4Tensor, tquant.Int8Tensor)}[kind]
    assert (type(tp.layers.wq), type(tp.layers.w_down)) == want_cls
    # the port's own quantizer gives the same containers, bytes and scales
    mine = tl.quantize_llama_params(port_llama(
        jl.init_llama_params(jax.random.key(0), jc, dtype=jnp.float32)), kind)
    for f in tl.QUANT_FIELDS:
        a, b = getattr(mine.layers, f), getattr(tp.layers, f)
        assert type(a) is type(b)
        np.testing.assert_array_equal(a.q.numpy(), b.q.numpy())
        np.testing.assert_array_equal(a.scale.numpy(), b.scale.numpy())

    t, s, start = 6, 256, 17
    rng = np.random.default_rng(3)
    cache = init_kv_cache(3, 1, jc.num_key_value_heads, s, jc.head_dim_,
                          jnp.float32)
    hidden = rng.standard_normal((1, t, jc.hidden_size)).astype(np.float32)
    pos = np.arange(start, start + t, dtype=np.int32)
    bias = np.asarray(jbias.prefill_bias(jnp.asarray(start), t, s))
    # JAX on the CPU takes its f32 dequant path; "pallas" sends the 4-bit
    # products through the TPU kernels in interpret mode instead
    monkeypatch.setattr(jquant, "_USE_PALLAS", {
        "int8": False, "nf4": path == "pallas", "int4": path == "pallas"})
    with pltpu.force_tpu_interpret_mode():
        want, _ = jl.llama_forward(jp, cache, jnp.asarray(hidden),
                                   jnp.asarray(pos), jnp.asarray(bias),
                                   jnp.asarray(start), jc)
        want_logits = jl.lm_head_logits(jp, jl.final_hidden(jp, want, jc))
    got, _ = tl.llama_forward(tp, port_cache(cache), torch.from_numpy(hidden),
                              torch.from_numpy(pos), torch.from_numpy(bias),
                              start, tc)
    got_logits = tl.lm_head_logits(tp, tl.final_hidden(tp, got, tc))
    tol = 1e-2 if path == "xla" else 5e-3
    for g, w in ((got, want), (got_logits, want_logits)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= tol * np.abs(w).max()


@pytest.mark.parametrize("kind", ["int8", "nf4", "int4", "mixed"])
def test_random_llama_params_layout(kind):
    """The random base of each kind has the containers, shapes and dtypes of
    a quantized one, and the old int8 entry point is the int8 kind."""
    _, tc = _cfgs(n_layers=2, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = tl.random_llama_params(tc, gen, "cpu", kind)
    ref = tl.quantize_llama_params(tl.LlamaParams(
        embed=p.embed, final_norm=p.final_norm, lm_head=p.lm_head,
        layers=dataclasses.replace(p.layers, **{
            f: torch.zeros((2, getattr(p.layers, f).in_features,
                            getattr(p.layers, f).out_features))
            for f in tl.QUANT_FIELDS})), kind)
    for f in tl.QUANT_FIELDS:
        a, b = getattr(p.layers, f), getattr(ref.layers, f)
        assert type(a) is type(b)
        assert (a.q.shape, a.q.dtype) == (b.q.shape, b.q.dtype)
        assert (a.scale.shape, a.scale.dtype) == (b.scale.shape,
                                                  b.scale.dtype)
    if kind == "int8":
        q = tl.random_int8_llama_params(tc, torch.Generator().manual_seed(0),
                                        "cpu")
        assert torch.equal(q.layers.w_up.q, p.layers.w_up.q)
        assert torch.equal(q.lm_head, p.lm_head)
    h = torch.zeros((1, 3, tc.hidden_size), dtype=torch.bfloat16)
    from flowspec_tpu_torch.models.kv_cache import init_kv_cache as tinit
    cache = tinit(2, 1, tc.num_key_value_heads, 256, tc.head_dim_,
                  torch.bfloat16, "cpu")
    out, _ = tl.llama_forward(p, cache, h + 1, torch.arange(3),
                              tbias.prefill_bias(0, 3, 256), 0, tc)
    assert out.shape == h.shape and bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("src,n_src,dst", [
    ([5, 6, 9, 12, 0, 0], 4, 5),    # overlapping source and destination
    ([3, 30, 31, 2, 0, 0], 3, 29),  # the write clamps to the allocation end
    ([40, 1, 33, 7, 0, 0], 4, 0),   # out-of-range source clips to S-1
])
def test_compact_matches(src, n_src, dst):
    s = 32
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 1, 2, s, 4)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    jc = JKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                  length=jnp.asarray(20, jnp.int32))
    want = jc.compact(jnp.asarray(src, jnp.int32), jnp.asarray(n_src),
                      jnp.asarray(dst))
    got = port_cache(jc).compact(torch.tensor(src), n_src, dst)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    assert got.length == int(want.length)


def test_bias_builders_match():
    rng = np.random.default_rng(5)
    for start, t, s in [(0, 8, 64), (37, 5, 128)]:
        np.testing.assert_array_equal(
            tbias.prefill_bias(start, t, s).numpy(),
            np.asarray(jbias.prefill_bias(jnp.asarray(start), t, s)))
    n = 12
    parents = np.array([-1, 0, 0, 1, 1, 2, 3, 6, 5, -1, -1, -1], np.int32)
    valid = np.arange(n) < 9
    want_anc = jtypes.tree_attention_bias(jnp.asarray(parents), 6,
                                          jnp.asarray(valid))
    got_anc = ttypes.tree_attention_bias(torch.from_numpy(parents), 6,
                                         torch.from_numpy(valid))
    np.testing.assert_array_equal(got_anc.numpy(), np.asarray(want_anc))
    np.testing.assert_array_equal(
        ttypes.depths_from_parents(torch.from_numpy(parents), 6).numpy(),
        np.asarray(jtypes.depths_from_parents(jnp.asarray(parents), 6)))
    rows = np.asarray(want_anc)[rng.permutation(n)[:5]]
    for base, s in [(10, 64), (50, 64)]:          # 50 + 12 > 64 - 2: edge
        np.testing.assert_array_equal(
            tbias.tree_bias(torch.from_numpy(rows), base, s).numpy(),
            np.asarray(jbias.tree_bias(jnp.asarray(rows), jnp.asarray(base),
                                       jnp.asarray(0), s)))
