"""The PyTorch port's whole slice against the JAX engine.

On the trained struct_tiny8 pair (tests/fixtures/struct_tiny8_*.npz) with
int8 base and draft in f32 on the CPU, the port's SpecEngine.generate must
be token-identical to the JAX SpecEngine.generate with equal accept/round:
f32 leaves only summation-order differences (~1e-6 relative) between the
two, far below the top-2 logit gaps greedy decoding decides on. And the
port's greedy spec stream must equal its own AR stream.

With packed 4-bit weights (nf4, int4, mixed) JAX on the CPU would take its
f32 dequant path, while the port decodes in bf16 as the TPU kernels do. So
for token identity the JAX engine is sent through its Pallas kernels in
interpret mode (`flowspec_tpu.ops.quant._USE_PALLAS` set from the test; no
file of the JAX package changes), which leaves the f32 sums' order and, at
f32, the product's bf16 rounding (~2e-3 relative in the logits) between
the two — still below the trained pair's top-2 gaps: same tokens, rounds
and accept/round (the nf4 and int4 cases run from
tests/test_torch_engine_nf4.py and test_torch_engine_int4.py, one kind a
file, the pair and the fixture from tests/torch_engine_util.py). And for
every kind on a tiny random pair, base and draft
quantized, the port's greedy spec stream equals its own AR stream (the
invariant of tests/test_quant.py:158-178).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowspec_tpu.config import (
    EngineConfig as JEngineConfig, SamplingConfig as JSamplingConfig,
    TreeConfig as JTreeConfig,
)
from flowspec_tpu.config import ModelConfig as JModelConfig
from flowspec_tpu.draft.eagle import init_eagle_params, quantize_eagle_params
from flowspec_tpu.models.llama import init_llama_params, quantize_llama_params
from flowspec_tpu.runtime.engine import make_beam_head as jmake_beam_head
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.runtime import SpecEngine
from flowspec_tpu_torch.runtime.engine import make_beam_head
from tests.torch_bridge_util import port_eagle, port_llama
from tests.torch_engine_util import (  # noqa: F401 (fixtures)
    N_NEW, _struct_pair, jax_4bit_through_pallas, one_torch_thread,
)


@pytest.fixture(scope="module")
def pair():
    return _struct_pair("int8")


@pytest.mark.parametrize("kind", ["mixed"])
def test_port_generate_matches_jax_token_for_token_4bit(
        kind, jax_4bit_through_pallas):
    jeng, port, prompt = _struct_pair(kind)
    want, wstats = jeng.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    got, gstats = port.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    assert [int(t) for t in want] == got
    assert gstats["rounds"] == wstats["rounds"]
    assert gstats["accept_per_round"] == wstats["accept_per_round"] > 1.5


def test_port_generate_matches_jax_token_for_token(pair):
    jeng, port, prompt = pair
    want, wstats = jeng.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    got, gstats = port.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    assert [int(t) for t in want] == got
    assert gstats["rounds"] == wstats["rounds"]
    assert gstats["accept_per_round"] == wstats["accept_per_round"]
    # a trained pair: the tree must actually earn multi-token rounds
    assert gstats["accept_per_round"] > 1.5


def test_port_spec_equals_port_ar(pair):
    _, port, prompt = pair
    spec, _ = port.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    ar, _ = port.generate_ar(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    assert spec == ar


def test_engine_defaults_to_cuda(pair):
    _, port, _ = pair
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpecEngine(port.params, port.draft, port.cfg)


# ---- every quantization kind on a tiny random pair -------------------------

SMALL_TREE = dict(top_k=8, depth=4, total_tokens=24, expand_tokens=16,
                  expand_depth=2, node_cap=48, leaf_cap=48, depth_cap=12,
                  chunk_len=8)


@pytest.fixture(scope="module")
def tiny_pair():
    mc = dataclasses.replace(JModelConfig.tiny(vocab_size=32, n_layers=2),
                             dtype="float32")
    params = init_llama_params(jax.random.key(0), mc, dtype=jnp.float32)
    draft = init_eagle_params(jax.random.key(100), mc, embed=params.embed,
                              dtype=jnp.float32)
    return mc, params, draft


def _tiny_engine(tiny_pair, kind, sampling=None):
    mc, params, draft = tiny_pair
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(mc)),
        tree=tcfg.TreeConfig(**SMALL_TREE),
        sampling=sampling or tcfg.SamplingConfig(), max_seq_len=256,
        prefill_chunk=16)
    return SpecEngine(port_llama(quantize_llama_params(params, kind)),
                      port_eagle(quantize_eagle_params(draft, kind)), cfg,
                      device="cpu")


@pytest.mark.parametrize("kind", ["int8", "nf4", "int4", "mixed"])
def test_port_quantized_spec_equals_port_ar(tiny_pair, kind):
    eng = _tiny_engine(tiny_pair, kind)
    prompt = list(np.random.default_rng(0).integers(3, 30, 12))
    ar, _ = eng.generate_ar(prompt, max_new_tokens=25, eos_token_id=-1)
    spec, stats = eng.generate(prompt, max_new_tokens=25, eos_token_id=-1)
    assert spec == ar, (kind, stats)
    assert stats["new_tokens"] == 25


@pytest.mark.parametrize("kind", ["int8", "nf4", "int4", "mixed"])
def test_make_beam_head_type_matches_jax(tiny_pair, kind):
    """"auto": an int8 head for an int8 or nf4 draft, the plain lm_head for
    an int4 one ("mixed" keeps the draft int8)."""
    mc, params, draft = tiny_pair
    jdraft = quantize_eagle_params(draft, kind)
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**SMALL_TREE),
                         sampling=JSamplingConfig(), max_seq_len=256)
    want = jmake_beam_head(params, jdraft, jcfg)
    tc = tcfg.EngineConfig(model=tcfg.ModelConfig(**dataclasses.asdict(mc)),
                           tree=tcfg.TreeConfig(**SMALL_TREE),
                           sampling=tcfg.SamplingConfig(), max_seq_len=256)
    got = make_beam_head(port_llama(params), port_eagle(jdraft), tc)
    assert type(got).__name__ == ("Tensor" if type(want).__name__
                                  == "ArrayImpl" else type(want).__name__)
    assert type(got).__name__ == {"int8": "Int8Tensor", "nf4": "Int8Tensor",
                                  "mixed": "Int8Tensor",
                                  "int4": "Tensor"}[kind]
    if kind != "int4":
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))


def test_port_generate_samples_with_temperature(tiny_pair):
    """SamplingConfig(temperature > 0) runs through generate (stochastic
    acceptance): in-vocabulary tokens, the same stream for the same seed,
    another for another seed."""
    eng = _tiny_engine(tiny_pair, "int8",
                       tcfg.SamplingConfig(temperature=1.0))
    prompt = list(np.random.default_rng(0).integers(3, 30, 12))
    a, stats = eng.generate(prompt, max_new_tokens=25, eos_token_id=-1, seed=1)
    b, _ = eng.generate(prompt, max_new_tokens=25, eos_token_id=-1, seed=1)
    c, _ = eng.generate(prompt, max_new_tokens=25, eos_token_id=-1, seed=2)
    assert a == b and a != c
    assert len(a) == 12 + 25 and all(0 <= t < 32 for t in a)
    assert stats["accept_per_round"] >= 1.0
