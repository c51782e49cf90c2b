"""The port's fused decode path against the JAX engine's, on the CPU in f32.

`generate_fused` / `generate_ar_fused` (on the card, CUDA graphs of the
round; here the same loop body without capture), KV buckets, the
`force_accept` bench mode and `resume_and_generate` must give the JAX
package's tokens and rounds, token for token, on the trained struct_tiny8
pair (int8 base and draft, tests/fixtures/struct_tiny8_*.npz) and on the
tiny random pair of tests/test_torch_engine.py. These mirror
tests/test_engine.py (kv buckets, force_accept) and tests/test_resume.py.
f32 leaves only summation-order differences between the two packages, far
below the top-2 logit gaps greedy decoding decides on.
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
from flowspec_tpu.draft.eagle import init_eagle_params
from flowspec_tpu.models.llama import init_llama_params
from flowspec_tpu.runtime.engine import SpecEngine as JSpecEngine
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.models.kv_cache import grow_kv
from flowspec_tpu_torch.ops.tree_attention import tree_attention_plain
from flowspec_tpu_torch.runtime import SpecEngine
from flowspec_tpu_torch.runtime.engine import _grow_kv
from tests.test_torch_engine import N_NEW, SMALL_TREE, _struct_pair
from tests.torch_engine_util import one_torch_thread  # noqa: F401
from tests.torch_bridge_util import port_eagle, port_llama

SMALL_PROMPT = [5, 9, 3, 7, 4, 8, 6]


def _ints(xs):
    return [int(t) for t in xs]


@pytest.fixture(scope="module")
def struct():
    """(JAX engine, port engine, prompt) on the trained int8 pair."""
    return _struct_pair("int8")


@pytest.fixture(scope="module")
def small():
    """(JAX engine, port engine) on the tiny random pair (vocab 32)."""
    mc = dataclasses.replace(JModelConfig.tiny(vocab_size=32, n_layers=2),
                             dtype="float32")
    params = init_llama_params(jax.random.key(0), mc, dtype=jnp.float32)
    draft = init_eagle_params(jax.random.key(100), mc, embed=params.embed,
                              dtype=jnp.float32)
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**SMALL_TREE),
                         sampling=JSamplingConfig(), max_seq_len=256,
                         prefill_chunk=16)
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(mc)),
        tree=tcfg.TreeConfig(**SMALL_TREE), sampling=tcfg.SamplingConfig(),
        max_seq_len=256, prefill_chunk=16)
    return (JSpecEngine(params, draft, jcfg),
            SpecEngine(port_llama(params), port_eagle(draft), cfg,
                       device="cpu"))


@pytest.fixture(scope="module")
def bucketed(struct, small):
    """{pair: (JAX engine, port engine, prompt)} with KV buckets: the small
    pair's (16, 32, 64) of tests/test_engine.py (prompt 7: three buckets);
    the struct pair's (16, 32, 48) (its 24-token prompt fits 48 and needs
    the full 128 after)."""
    return {"small": (*_with(*small, kv_buckets=(16, 32, 64)), SMALL_PROMPT),
            "struct": (*_with(*struct[:2], kv_buckets=(16, 32, 48)),
                       struct[2])}


def _with(jeng, port, **kw):
    """Both engines again with EngineConfig fields `kw` changed."""
    return (JSpecEngine(jeng.params, jeng.draft,
                        dataclasses.replace(jeng.cfg, **kw)),
            SpecEngine(port.params, port.draft,
                       dataclasses.replace(port.cfg, **kw), device="cpu"))


def test_generate_fused_matches_jax_and_eager(struct):
    jeng, port, prompt = struct
    want, wstats = jeng.generate_fused(prompt, max_new_tokens=N_NEW,
                                       eos_token_id=-1)
    got, gstats = port.generate_fused(prompt, max_new_tokens=N_NEW,
                                      eos_token_id=-1)
    assert _ints(want) == got
    assert gstats == wstats
    assert gstats["kv_buckets_used"] == 1 and gstats["accept_per_round"] > 1.5
    eager, estats = port.generate(prompt, max_new_tokens=N_NEW,
                                  eos_token_id=-1)
    assert eager == got and estats["rounds"] == gstats["rounds"]


@pytest.mark.parametrize("eos_at", [None, 5])
@pytest.mark.parametrize("pair", ["small", "struct"])
def test_generate_fused_with_kv_buckets_matches_jax(struct, small, bucketed,
                                                    pair, eos_at):
    """With KV buckets the chain of segments engages two buckets or more
    and gives the tokens of the single allocation; with an EOS inside the
    first bucket the chain stops there, as JAX's does."""
    port = {"small": small, "struct": struct}[pair][1]
    jb, pb, prompt = bucketed[pair]
    ref, _ = port.generate_fused(prompt, max_new_tokens=N_NEW,
                                 eos_token_id=-1)
    eos = -1 if eos_at is None else ref[len(prompt) + eos_at]
    assert pb._plan_buckets(len(prompt), N_NEW) == \
        jb._plan_buckets(len(prompt), N_NEW)
    want, wstats = jb.generate_fused(prompt, max_new_tokens=N_NEW,
                                     eos_token_id=eos)
    got, gstats = pb.generate_fused(prompt, max_new_tokens=N_NEW,
                                    eos_token_id=eos)
    assert _ints(want) == got
    assert gstats == wstats
    if eos_at is None:
        assert got == ref and gstats["kv_buckets_used"] >= 2, gstats
    else:
        assert got[-1] == eos and got == ref[:len(got)]
        assert gstats["kv_buckets_used"] == 1, gstats


def test_force_accept_matches_jax(small):
    """force_accept=3 commits min(3, deepest path) nodes a round, the same
    tokens and rounds as JAX, and more tokens a round than the real
    verdict."""
    jeng, port = small
    prompt = SMALL_PROMPT
    _, ref = port.generate_fused(prompt, max_new_tokens=24, eos_token_id=-1)
    jf, pf = _with(jeng, port, force_accept=3)
    want, wstats = jf.generate_fused(prompt, max_new_tokens=24,
                                     eos_token_id=-1)
    got, gstats = pf.generate_fused(prompt, max_new_tokens=24,
                                    eos_token_id=-1)
    assert _ints(want) == got
    assert gstats == wstats
    assert gstats["accept_per_round"] >= 2.5 and \
        gstats["rounds"] < ref["rounds"], (gstats, ref)


def test_generate_ar_fused_matches_jax_and_spec(small):
    jeng, port = small
    prompt = list(np.random.default_rng(3).integers(3, 30, 12))
    want, wstats = jeng.generate_ar_fused(prompt, max_new_tokens=25,
                                          eos_token_id=-1)
    got, gstats = port.generate_ar_fused(prompt, max_new_tokens=25,
                                         eos_token_id=-1)
    assert _ints(want) == got and gstats == wstats
    spec, _ = port.generate_fused(prompt, max_new_tokens=25, eos_token_id=-1)
    assert spec == got
    eos = got[len(prompt) + 4]
    cut, stats = port.generate_ar_fused(prompt, max_new_tokens=25,
                                        eos_token_id=eos)
    assert cut == got[:len(cut)] and cut[-1] == eos
    assert stats["new_tokens"] == len(cut) - len(prompt)


def test_generate_fused_samples_with_temperature(small):
    """SamplingConfig(temperature > 0) through the fused loop (the
    stochastic walk that reads nothing back): in-vocabulary tokens, the same
    stream for the same seed, another for another seed."""
    _, port = small
    eng = SpecEngine(port.params, port.draft, dataclasses.replace(
        port.cfg, sampling=tcfg.SamplingConfig(temperature=1.0)),
        device="cpu")
    prompt = SMALL_PROMPT
    a, stats = eng.generate_fused(prompt, max_new_tokens=25,
                                  eos_token_id=-1, seed=1)
    b, _ = eng.generate_fused(prompt, max_new_tokens=25, eos_token_id=-1,
                              seed=1)
    c, _ = eng.generate_fused(prompt, max_new_tokens=25, eos_token_id=-1,
                              seed=2)
    assert a == b and a != c
    assert len(a) == len(prompt) + 25 and all(0 <= t < 32 for t in a)
    assert stats["accept_per_round"] >= 1.0


def test_resume_and_generate_matches_jax_and_full_prefill(struct):
    """Two turns on the trained pair (multi-token commits, so the first
    turn's stop falls mid-round and the state has committed past the
    returned stream): the continuation equals JAX's and a fresh prefill of
    the whole history; the second turn's extra prompt is longer than the
    decode pair buffers (depth_cap + 1)."""
    jeng, port, prompt = struct
    extra = list(np.random.default_rng(5).integers(
        3, port.cfg.model.vocab_size, 13))
    got1, _, state = port.generate(prompt, max_new_tokens=13,
                                   eos_token_id=-1, return_state=True)
    want1, _, jstate = jeng.generate(prompt, max_new_tokens=13,
                                     eos_token_id=-1, return_state=True)
    assert _ints(want1) == got1
    got2, gstats = port.resume_and_generate(state, got1, extra,
                                            max_new_tokens=11,
                                            eos_token_id=-1)
    want2, wstats = jeng.resume_and_generate(jstate, want1, extra,
                                             max_new_tokens=11,
                                             eos_token_id=-1)
    assert _ints(want2) == got2 and gstats == wstats
    fresh, _ = port.generate(got1 + _ints(extra), max_new_tokens=11,
                             eos_token_id=-1)
    assert got2 == fresh


def test_grow_kv_keeps_live_rows_and_lengths(small):
    """_grow_kv zero-pads the sequence axis only: the live rows, the
    lengths and every other field survive a bucket move bit for bit."""
    _, port = small
    state = port.prefill(port.init_state(0, max_seq=40),
                         list(range(3, 23)))
    rows0, drows0 = state.base_cache.max_len, state.draft_cache.max_len
    k0, v0 = state.base_cache.k.clone(), state.base_cache.v.clone()
    dk0 = state.draft_cache.k.clone()
    grown = _grow_kv(state, *port._kv_rows(600))
    assert grown.base_cache.max_len == 768 > rows0 == 256
    assert grown.draft_cache.max_len > drows0
    assert torch.equal(grown.base_cache.k[:, :, :, :rows0], k0)
    assert torch.equal(grown.base_cache.v[:, :, :, :rows0], v0)
    assert torch.equal(grown.draft_cache.k[:, :, :, :drows0], dk0)
    assert not grown.base_cache.k[:, :, :, rows0:].any()
    assert not grown.draft_cache.v[:, :, :, drows0:].any()
    for a, b in ((grown.commit_len, state.commit_len),
                 (grown.base_cache.length, state.base_cache.length),
                 (grown.draft_cache.length, state.draft_cache.length),
                 (grown.n_pending, state.n_pending)):
        assert a.dtype == torch.int32 and int(a) == int(b)
    assert int(grown.commit_len) == 20
    with pytest.raises(ValueError):
        grow_kv(grown.base_cache, 256)


@pytest.mark.parametrize("n_valid", [1, 63, 64, 65, 209, 256, 300, 512])
def test_tree_attention_plain_takes_a_device_n_valid(n_valid):
    """A 0-d tensor n_valid (the serving path's) gives the host int's
    result: on the CPU it is read and the same 256-row blocks are
    attended."""
    rng = np.random.default_rng(n_valid)
    nq, nkv, t, s, d = 4, 2, 9, 512, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((1, nq, t, d), (1, nkv, s, d), (1, nkv, s, d)))
    bias = torch.full((t, s), -1e9)
    bias[:, :n_valid] = 0.0
    want = tree_attention_plain(q, k, v, bias, n_valid)
    got = tree_attention_plain(q, k, v, bias,
                               torch.tensor(n_valid, dtype=torch.int32))
    assert torch.equal(got, want)
