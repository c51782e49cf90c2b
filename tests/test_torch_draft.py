"""The PyTorch port's draft (EAGLE layer + beam tree) against the JAX
package, on a tiny random thin draft in f32: draft_context_forward must
agree at 1e-5 (summation order only) and topk_generate must give an
identical TokenTree (tokens, parents, depth, retrieve, counts; scores at
1e-5) and the same draft KV.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import (
    ModelConfig as JModelConfig, TreeConfig as JTreeConfig,
)
from flowspec_tpu.draft import beam as jbeam
from flowspec_tpu.draft import eagle as jeagle
from flowspec_tpu.models.kv_cache import init_kv_cache
from flowspec_tpu.models.llama import init_llama_params
from flowspec_tpu.ops.quant import quantize_int8 as jquantize_int8
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.draft import beam as tbeam
from flowspec_tpu_torch.draft import eagle as teagle
from flowspec_tpu_torch.ops.quant import Int8Tensor
from tests.torch_bridge_util import port_cache, port_eagle

F32 = dict(rtol=1e-5, atol=1e-5)
TREE = dict(top_k=4, depth=4, total_tokens=16, node_cap=17, leaf_cap=17,
            depth_cap=5, expand_depth=2, score_temperature=0.5)


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "int8"])
def setup(request):
    jc = dataclasses.replace(JModelConfig.tiny(vocab_size=256), dtype="float32")
    base = init_llama_params(jax.random.key(0), jc, dtype=jnp.float32)
    draft = jeagle.init_eagle_params(jax.random.key(1), jc, embed=base.embed,
                                     dtype=jnp.float32, width=32)
    # a residual-scaled w_out keeps the thin draft's hiddens O(1)
    draft = dataclasses.replace(draft, w_out=draft.w_out * 0.1)
    head = base.lm_head
    if request.param:
        draft = jeagle.quantize_eagle_params(draft, "int8")
        head = jquantize_int8(base.lm_head)
    tc = tcfg.ModelConfig(**dataclasses.asdict(jc))
    return jc, tc, base, draft, head


def _port_head(head):
    if hasattr(head, "q"):
        return Int8Tensor(q=torch.from_numpy(np.asarray(head.q)),
                          scale=torch.from_numpy(np.asarray(head.scale)))
    return torch.from_numpy(np.asarray(head))


def _context(jc, draft, seed=0, t=9, n_valid=7, start=11):
    rng = np.random.default_rng(seed)
    dcfg = jeagle.draft_view(draft, jc)
    cache = init_kv_cache(1, 1, dcfg.num_key_value_heads, 256, jc.head_dim_,
                          jnp.float32)
    cache = dataclasses.replace(
        cache, k=jnp.asarray(rng.standard_normal(cache.k.shape), jnp.float32),
        v=jnp.asarray(rng.standard_normal(cache.v.shape), jnp.float32),
        length=jnp.asarray(start, jnp.int32))
    toks = rng.integers(0, jc.vocab_size, t).astype(np.int32)
    hid = rng.standard_normal((1, t, jc.hidden_size)).astype(np.float32)
    return cache, toks, hid, n_valid, start


def test_draft_context_forward_matches(setup):
    jc, tc, _, draft, _ = setup
    cache, toks, hid, n_valid, start = _context(jc, draft)
    want, wcache = jeagle.draft_context_forward(
        draft, cache, jnp.asarray(toks), jnp.asarray(hid), jnp.asarray(start),
        jnp.asarray(n_valid), jc)
    got, gcache = teagle.draft_context_forward(
        port_eagle(draft), port_cache(cache), torch.from_numpy(toks),
        torch.from_numpy(hid), start, n_valid, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gcache.k.numpy(), np.asarray(wcache.k), **F32)
    assert gcache.length == int(wcache.length)


def test_topk_generate_gives_identical_tree(setup):
    jc, tc, _, draft, head = setup
    cache, _, _, _, start = _context(jc, draft, seed=1)
    rng = np.random.default_rng(2)
    root_hidden = rng.standard_normal((jc.hidden_size,)).astype(np.float32)
    root = 17
    jtree_cfg = JTreeConfig(**TREE)
    want, _, wcache = jbeam.topk_generate(
        draft, head, cache, jnp.asarray(root, jnp.int32),
        jnp.asarray(root_hidden), jtree_cfg, jc)
    got, _, gcache = tbeam.topk_generate(
        port_eagle(draft), _port_head(head), port_cache(cache),
        torch.tensor(root, dtype=torch.int32), torch.from_numpy(root_hidden),
        tcfg.TreeConfig(**TREE), tc)
    for f in ("tokens", "parents", "depth", "retrieve", "n_nodes",
              "n_leaves"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **F32)
    assert int(got.n_nodes) == TREE["total_tokens"] + 1
    assert int(np.asarray(want.depth).max()) >= 2       # a real multi-level tree
    np.testing.assert_allclose(gcache.k.numpy(), np.asarray(wcache.k), **F32)
    assert gcache.length == int(wcache.length)


@pytest.mark.parametrize("kind", ["int8", "nf4", "int4", "mixed"])
def test_quantize_eagle_params_matches_jax(kind):
    """The port's draft quantizer gives JAX's containers, bytes and scales
    for every kind ("mixed" keeps the draft int8), and the quantized draft
    runs: its context forward agrees with the JAX f32 dequant path within
    the bf16 decode's 1e-2 of the largest value (exactly 1e-5 for int8)."""
    jc = dataclasses.replace(JModelConfig.tiny(vocab_size=256),
                             dtype="float32")
    base = init_llama_params(jax.random.key(0), jc, dtype=jnp.float32)
    draft = jeagle.init_eagle_params(jax.random.key(1), jc, embed=base.embed,
                                     dtype=jnp.float32)
    want = jeagle.quantize_eagle_params(draft, kind)
    got = teagle.quantize_eagle_params(port_eagle(draft), kind)
    bridged = port_eagle(want)
    for f in teagle.EAGLE_QUANT_FIELDS:
        w, g, b = getattr(want, f), getattr(got, f), getattr(bridged, f)
        if w is None:
            assert g is None
            continue
        assert type(g) is type(b)
        assert type(g).__name__ == type(w).__name__
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    with pytest.raises(ValueError, match="not in"):
        teagle.quantize_eagle_params(port_eagle(draft), "fp4")

    tc = tcfg.ModelConfig(**dataclasses.asdict(jc))
    jcache, tokens, hidden, n_valid, start = _context(jc, want)
    w_out, _ = jeagle.draft_context_forward(
        want, jcache, jnp.asarray(tokens), jnp.asarray(hidden),
        jnp.asarray(start), jnp.asarray(n_valid), jc)
    g_out, _ = teagle.draft_context_forward(
        got, port_cache(jcache), torch.from_numpy(tokens),
        torch.from_numpy(hidden), start, n_valid, tc)
    w_out = np.asarray(w_out)
    tol = 1e-5 if kind in ("int8", "mixed") else 1e-2
    assert np.abs(g_out.numpy() - w_out).max() <= tol * np.abs(w_out).max()
