"""The port's model families against the JAX package on the CPU, in f32.

Qwen2 (`LlamaParams` with qkv biases, here G = 7 query heads to a KV head as
in Qwen2-7B, rope_theta 1e6, tied and untied heads) and Mixtral (MoE, the
config of tests/test_model_variants.py:160-168) through `model_forward`,
`moe_block` and the engine: the same weights (JAX's init, carried over the
numpy bridge) and the same inputs (numpy, seeded) on both sides. f32 leaves
only summation-order differences: forwards and MoE outputs agree to 1e-5,
and greedy token streams (eager and fused, spec and AR) are identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
    SamplingConfig as JSamplingConfig, TreeConfig as JTreeConfig,
)
from flowspec_tpu.draft.eagle import init_eagle_params as jinit_eagle
from flowspec_tpu.models import bias as jbias
from flowspec_tpu.models import model_forward as jmodel_forward
from flowspec_tpu.models import (
    embed_tokens as jembed, final_hidden as jfinal, init_kv_cache as jinit_kv,
    lm_head_logits as jlogits,
)
from flowspec_tpu.models.llama import init_llama_params
from flowspec_tpu.models.mixtral import init_mixtral_params, moe_block as jmoe
from flowspec_tpu.runtime.engine import SpecEngine as JSpecEngine
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch import models as tm
from flowspec_tpu_torch.models.mixtral import (
    MixtralParams, moe_block, top_experts,
)
from flowspec_tpu_torch.runtime import SpecEngine
from tests.test_torch_engine import SMALL_TREE
from tests.torch_engine_util import one_torch_thread  # noqa: F401
from tests.torch_bridge_util import np_of, port_eagle, port_llama, port_mixtral

F32 = dict(rtol=1e-5, atol=1e-5)
S_MAX = 64
N_NEW = 20

# Qwen2 in small: qkv biases, 7 query heads on one KV head (Qwen2-7B's G),
# Qwen2's rope_theta and eps
QWEN2 = JModelConfig(vocab_size=48, hidden_size=112, intermediate_size=192,
                     num_hidden_layers=2, num_attention_heads=7,
                     num_key_value_heads=1, attention_bias=True,
                     rms_norm_eps=1e-6, rope_theta=1e6,
                     max_position_embeddings=512, dtype="float32")
# tests/test_model_variants.py:160-168
MIXTRAL = JModelConfig(vocab_size=32, hidden_size=64, intermediate_size=96,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, num_local_experts=4,
                       num_experts_per_tok=2, max_position_embeddings=512,
                       dtype="float32")


def _port_cfg(jc):
    return tcfg.ModelConfig(**dataclasses.asdict(jc))


def qwen2_params(tied: bool):
    """JAX Qwen2 params: init_llama_params with random qkv biases (the init
    gives zeros), the head the embedding's transpose when tied."""
    mc = dataclasses.replace(QWEN2, tie_word_embeddings=tied)
    p = init_llama_params(jax.random.key(3), mc, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    lp = dataclasses.replace(p.layers, **{
        f: jnp.asarray(rng.normal(0, 0.5, getattr(p.layers, f).shape),
                       jnp.float32) for f in ("bq", "bk", "bv")})
    p = dataclasses.replace(p, layers=lp)
    if tied:
        p = dataclasses.replace(p, lm_head=p.embed.T)
    return mc, p


def _chunks(vocab):
    """Two prefill chunks (9 then 5 tokens): the second writes at 9."""
    toks = np.random.default_rng(7).integers(0, vocab, 14)
    return [toks[:9], toks[9:]]


def jax_logits(params, cfg, chunks):
    cache = jinit_kv(cfg.num_hidden_layers, 1, cfg.num_key_value_heads,
                     S_MAX, cfg.head_dim_, jnp.float32)
    out, start = [], 0
    for toks in chunks:
        t = len(toks)
        hidden = jembed(params, jnp.asarray(toks, jnp.int32)[None])
        bias = jbias.prefill_bias(jnp.asarray(start), t, S_MAX)
        h, cache = jmodel_forward(params, cache, hidden,
                                  start + jnp.arange(t, dtype=jnp.int32),
                                  bias, jnp.asarray(start), cfg)
        out.append(np.asarray(jlogits(params, jfinal(params, h, cfg))[0]))
        start += t
    return np.concatenate(out)


def port_logits(params, cfg, chunks):
    cache = tm.init_kv_cache(cfg.num_hidden_layers, 1,
                             cfg.num_key_value_heads, S_MAX, cfg.head_dim_,
                             torch.float32, "cpu")
    out, start = [], 0
    for toks in chunks:
        t = len(toks)
        hidden = tm.embed_tokens(params, torch.from_numpy(
            np.asarray(toks, np.int32))[None])
        bias = tm.prefill_bias(start, t, S_MAX, device="cpu")
        h, cache = tm.model_forward(params, cache, hidden,
                                    start + torch.arange(t), bias, start, cfg)
        out.append(np_of(tm.lm_head_logits(
            params, tm.final_hidden(params, h, cfg))[0]))
        start += t
    return np.concatenate(out)


@pytest.mark.parametrize("tied", [False, True])
def test_qwen2_forward_matches_jax(tied):
    mc, p = qwen2_params(tied)
    port = port_llama(p)
    assert port.layers.bq is not None and mc.num_attention_heads == 7
    chunks = _chunks(mc.vocab_size)
    np.testing.assert_allclose(port_logits(port, _port_cfg(mc), chunks),
                               jax_logits(p, mc, chunks), **F32)


def _engines(mc, params, port_params, **kw):
    draft = jinit_eagle(jax.random.key(11), mc, embed=params.embed,
                        dtype=jnp.float32)
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**SMALL_TREE),
                         sampling=JSamplingConfig(), max_seq_len=128,
                         prefill_chunk=16, **kw)
    cfg = tcfg.EngineConfig(model=_port_cfg(mc),
                            tree=tcfg.TreeConfig(**SMALL_TREE),
                            sampling=tcfg.SamplingConfig(), max_seq_len=128,
                            prefill_chunk=16, **kw)
    return (JSpecEngine(params, draft, jcfg),
            SpecEngine(port_params, port_eagle(draft), cfg, device="cpu"))


def _ints(xs):
    return [int(t) for t in xs]


@pytest.mark.parametrize("tied", [False, True])
def test_qwen2_engine_matches_jax(tied):
    """generate and generate_fused, token for token and round for round."""
    mc, p = qwen2_params(tied)
    jeng, port = _engines(mc, p, port_llama(p))
    prompt = list(np.random.default_rng(1).integers(3, 45, 10))
    want, wstats = jeng.generate(prompt, max_new_tokens=N_NEW,
                                 eos_token_id=-1)
    got, gstats = port.generate(prompt, max_new_tokens=N_NEW,
                                eos_token_id=-1)
    fused, fstats = port.generate_fused(prompt, max_new_tokens=N_NEW,
                                        eos_token_id=-1)
    assert _ints(want) == got == fused
    assert gstats["rounds"] == wstats["rounds"] == fstats["rounds"]


@pytest.fixture(scope="module")
def mixtral():
    p = init_mixtral_params(jax.random.key(0), MIXTRAL, dtype=jnp.float32)
    return p, port_mixtral(p)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("router", ["random", "tied"])
def test_moe_block_matches_jax(mixtral, router):
    """One layer's MoE on 13 tokens. "tied": a zero router, so all experts
    tie and both packages must pick experts 0 and 1 (JAX's lax.top_k order)
    with weights 1/2."""
    jp, tp = mixtral
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp.layers)
    tlp = tp.layers.layer(0)
    if router == "tied":
        jlp = dataclasses.replace(jlp, router=jnp.zeros_like(jlp.router))
        tlp = dataclasses.replace(tlp, router=torch.zeros_like(tlp.router))
    x = _x((1, 13, MIXTRAL.hidden_size), 5)
    want = np.asarray(jmoe(jnp.asarray(x), jlp, MIXTRAL))
    got = np_of(moe_block(torch.from_numpy(x), tlp, _port_cfg(MIXTRAL)))
    np.testing.assert_allclose(got, want, **F32)
    if router == "tied":
        xs = torch.from_numpy(x)[0]
        ref = sum(moe_expert(xs, tlp, j) for j in (0, 1)) / 2
        np.testing.assert_allclose(got[0], np_of(ref), **F32)


def moe_expert(x, lp, j):
    """Expert j's SwiGLU MLP on x (T, H)."""
    return (torch.nn.functional.silu(x @ lp.w_gate[j]) * (x @ lp.w_up[j])
            ) @ lp.w_down[j]


def test_top_experts_orders_ties_like_lax_top_k():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 2)
    gv, gi = top_experts(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi.tolist() == [[1, 2], [0, 1], [0, 2]]


def test_mixtral_forward_matches_jax(mixtral):
    jp, tp = mixtral
    assert isinstance(tp, MixtralParams)
    chunks = _chunks(MIXTRAL.vocab_size)
    np.testing.assert_allclose(port_logits(tp, _port_cfg(MIXTRAL), chunks),
                               jax_logits(jp, MIXTRAL, chunks), **F32)


def test_mixtral_engine_matches_jax(mixtral):
    """spec == AR in the port, and the port's streams (generate,
    generate_fused, generate_ar, generate_ar_fused) equal the JAX
    engine's."""
    jp, tp = mixtral
    jeng, port = _engines(MIXTRAL, jp, tp)
    prompt = list(np.random.default_rng(0).integers(3, 30, 10))
    want, wstats = jeng.generate(prompt, max_new_tokens=N_NEW,
                                 eos_token_id=-1)
    got, gstats = port.generate(prompt, max_new_tokens=N_NEW,
                                eos_token_id=-1)
    fused, _ = port.generate_fused(prompt, max_new_tokens=N_NEW,
                                   eos_token_id=-1)
    ar, _ = port.generate_ar(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    ar_fused, _ = port.generate_ar_fused(prompt, max_new_tokens=N_NEW,
                                         eos_token_id=-1)
    assert _ints(want) == got == fused == ar == ar_fused
    assert gstats["rounds"] == wstats["rounds"]


def test_engine_forward_fn_runs_every_base_forward(mixtral):
    """SpecEngine(forward_fn=...) takes the base model's three forwards:
    prefill chunks, verify rounds and AR steps."""
    _, tp = mixtral
    calls = []

    def fwd(*args):
        calls.append(args[2].shape[1])
        return tm.model_forward(*args)

    cfg = tcfg.EngineConfig(model=_port_cfg(MIXTRAL),
                            tree=tcfg.TreeConfig(**SMALL_TREE),
                            sampling=tcfg.SamplingConfig(), max_seq_len=128,
                            prefill_chunk=16)
    draft = port_eagle(jinit_eagle(jax.random.key(11), MIXTRAL,
                                   embed=jnp.asarray(np_of(tp.embed)),
                                   dtype=jnp.float32))
    eng = SpecEngine(tp, draft, cfg, device="cpu", forward_fn=fwd)
    prompt = list(range(3, 13))
    ref = SpecEngine(tp, draft, cfg, device="cpu")
    assert eng.generate(prompt, 6, eos_token_id=-1)[0] == \
        ref.generate(prompt, 6, eos_token_id=-1)[0]
    node_cap = eng.cfg.tree.node_cap
    assert calls[0] == 16 and set(calls[1:]) == {node_cap}
    calls.clear()
    eng.generate_ar(prompt, 4, eos_token_id=-1)
    assert calls == [16, 1, 1, 1, 1]      # a step a token, the last unread


def test_smoke_lossless_witness_sides_with_the_base(mixtral):
    """`chip_smoke.py`'s lossless gate for an MoE base: at a divergence off
    a logit near-tie, the AR prefix forwarded at the verify's row count
    must side with the spec token. In f32 that forward gives the AR path's
    logits, so a spec token far below its maximum fails the gate."""
    import chip_smoke
    jp, tp = mixtral
    _, port = _engines(MIXTRAL, jp, tp)
    prompt = [int(t) for t in np.random.default_rng(1).integers(3, 30, 10)]
    ar, _ = port.generate_ar(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    ar = ar[len(prompt):]
    gaps = []
    for i in range(0, N_NEW, 3):
        w = chip_smoke.verify_width_logits(port, prompt, ar[:i])
        _, want = port._prefill_chunks(port.init_state(), prompt + ar[:i])
        np.testing.assert_allclose(w.numpy(), want.float().numpy(), **F32)
        assert int(w.argmax()) == ar[i]
        top = torch.topk(w, 2).values
        gaps.append((float(top[0] - top[1]), i, int(w.argmin())))
    gap, i, worst = max(gaps)
    assert gap >= chip_smoke.NEAR_TIE_GAP
    spec = ar[:i] + [worst] + ar[i + 1:]
    _, faults = chip_smoke.divergences(port, [prompt], [spec], [ar])
    assert faults[0]["position"] == i
    assert faults[0]["verify_width"]["ar_below_max"] == 0.0
    with pytest.raises(AssertionError, match="off a near-tie"):
        chip_smoke.check_lossless("mixtral", faults)
    # the witness siding with spec, or a logit near-tie, excuses it; a
    # base without the witness (LLaMA, Qwen2) keeps the logit rule alone
    chip_smoke.check_lossless("mixtral", [{
        **faults[0], "verify_width": {"spec_below_max": 0.0,
                                      "ar_below_max": gap}}])
    chip_smoke.check_lossless("mixtral", [{"position": i, "top2_gap": 0.01}])
    with pytest.raises(AssertionError, match="off a near-tie"):
        chip_smoke.check_lossless("qwen2", [{"position": i,
                                             "top2_gap": gap}])
