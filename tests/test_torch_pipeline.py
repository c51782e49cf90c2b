"""The port's `PipelineEngine` against the JAX package's, on the CPU in f32.

On tests/test_pipeline.py's tiny setup (`_cfg`: vocab 12, four layers on
four stages, node_cap 64, chunks of 6): every schedule's `generate` gives
the JAX engine's tokens (and the port's AR stream) with a stats dict equal
key for key; `generate_fused` and an EOS stop do too; a turn reads back at
most three small flag vectors; `resume_and_generate` continues a kept state
as JAX's does and as a fresh run on the whole history does
(tests/test_resume.py:132), also from a JAX state bridged to the port. The
JAX engines are module-scoped, so JAX compiles each program once.
Uneven layer splits are in tests/test_torch_tree_pipeline.py beside the
checkpoints of the same engine, the other hard corners in
tests/test_torch_pipeline_stress.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
    SamplingConfig as JSamplingConfig, StageTopology as JStageTopology,
    TreeConfig as JTreeConfig,
)
from flowspec_tpu.draft.eagle import init_eagle_params
from flowspec_tpu.models.llama import init_llama_params
from flowspec_tpu.parallel import PipelineEngine as JPipelineEngine
from flowspec_tpu_torch import bridge
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.parallel import PipelineEngine
from flowspec_tpu_torch.runtime import SpecEngine
from tests.torch_bridge_util import port_eagle, port_llama, to_numpy_dict

SCHEDULES = ["ar", "serial", "naive", "pruned", "continuous", "pipedec"]
TREE = dict(top_k=8, depth=4, total_tokens=24, expand_tokens=12,
            expand_depth=2, node_cap=64, leaf_cap=64, depth_cap=14,
            chunk_len=6, chunk_cap=12)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are tiny: the port's ops run on one thread, leaving
    the other cores to the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(mc, tree=TREE, temperature=0.0, topology=None, max_seq=256):
    """(JAX EngineConfig, port EngineConfig) of the same values."""
    topology = topology or (4, JStageTopology.even(
        mc.num_hidden_layers, 4).layers_per_stage)
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**tree),
                         sampling=JSamplingConfig(temperature=temperature),
                         max_seq_len=max_seq, prefill_chunk=8,
                         topology=JStageTopology(*topology))
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(mc)),
        tree=tcfg.TreeConfig(**tree),
        sampling=tcfg.SamplingConfig(temperature=temperature),
        max_seq_len=max_seq, prefill_chunk=8,
        topology=tcfg.StageTopology(*topology))
    return jcfg, cfg


def tiny_model(vocab, n_layers=4):
    return dataclasses.replace(JModelConfig.tiny(vocab_size=vocab,
                                                 n_layers=n_layers),
                               dtype="float32")


def equal_runs(jeng, eng, prompt, method="generate", **kw):
    """Both engines through `method`: the port's tokens and stats, held
    equal to JAX's."""
    want, wstats = getattr(jeng, method)(prompt, **kw)
    got, stats = getattr(eng, method)(prompt, **kw)
    assert got == [int(t) for t in want], (method, stats, wstats)
    assert stats == wstats
    return got, stats


def lossless(jeng, eng, prompt, n_new, port_ar):
    """`equal_runs` of `generate`, and the port's AR stream."""
    out, stats = equal_runs(jeng, eng, prompt, max_new_tokens=n_new,
                            eos_token_id=-1)
    assert out == port_ar.generate_ar(prompt, max_new_tokens=n_new,
                                      eos_token_id=-1)[0]
    return stats


@pytest.fixture(scope="module")
def weights():
    mc = tiny_model(12)
    p = init_llama_params(jax.random.key(2), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(7), mc, embed=p.embed,
                          dtype=jnp.float32)
    return mc, p, d, port_llama(p), port_eagle(d)


@pytest.fixture(scope="module")
def engines(weights):
    """The module's (JAX, port) engine pair of a schedule, each built once
    (JAX compiles its programs once)."""
    built = {}

    def pair(schedule):
        if schedule not in built:
            mc, p, d, tp, td = weights
            jcfg, cfg = configs(mc)
            built[schedule] = (
                JPipelineEngine(p, d, jcfg, schedule=schedule),
                PipelineEngine(tp, td, cfg, schedule=schedule,
                               device="cpu"))
        return built[schedule]
    return pair


@pytest.fixture(scope="module")
def port_ar(weights):
    mc, _, _, tp, td = weights
    return SpecEngine(tp, td, configs(mc)[1], device="cpu")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_matches_jax(engines, port_ar, schedule):
    jeng, eng = engines(schedule)
    prompt = np.random.default_rng(0).integers(3, 11, 9).tolist()
    reads = eng.reads.count
    stats = lossless(jeng, eng, prompt, 20, port_ar)
    assert stats["accept_per_round"] >= 1.0
    assert 1 <= eng.reads.count - reads <= 3 * stats["turns"]
    assert eng.c_buf == jeng.c_buf and eng.out_cap == jeng.out_cap


def test_acceptance_beyond_root_matches_jax(engines):
    jeng, eng = engines("continuous")
    prompt = np.random.default_rng(1).integers(3, 11, 12).tolist()
    _, stats = equal_runs(jeng, eng, prompt, max_new_tokens=30,
                          eos_token_id=-1)
    assert stats["accept_per_round"] > 1.0 and stats["ne_fires"] > 0


def test_generate_fused_matches_jax_and_generate(engines):
    jeng, eng = engines("continuous")
    prompt = np.random.default_rng(5).integers(3, 11, 9).tolist()
    out, stats = equal_runs(jeng, eng, prompt, method="generate_fused",
                            max_new_tokens=18, eos_token_id=-1)
    eager, estats = eng.generate(prompt, max_new_tokens=18, eos_token_id=-1)
    assert out == eager and stats["rounds"] == estats["rounds"]
    assert stats["accept_per_round"] == 18 / stats["rounds"]


@pytest.mark.parametrize("method", ["generate", "generate_fused"])
def test_eos_stops_like_jax(engines, port_ar, method):
    jeng, eng = engines("continuous")
    prompt = np.random.default_rng(0).integers(3, 11, 8).tolist()
    ar = port_ar.generate_ar(prompt, max_new_tokens=25, eos_token_id=-1)[0]
    gen = ar[len(prompt):]
    # the token met last for the first time: the stop falls mid-stream
    first = max(i for i, t in enumerate(gen) if t not in gen[:i])
    assert first >= 8
    eos = gen[first]
    out, _ = equal_runs(jeng, eng, prompt, method=method, max_new_tokens=25,
                        eos_token_id=eos)
    assert out == ar[:len(prompt) + gen.index(eos) + 1]


def test_continuous_fewer_turns_than_naive(engines):
    prompt = np.random.default_rng(2).integers(3, 11, 10).tolist()
    naive = engines("naive")[1].generate(prompt, max_new_tokens=25,
                                                  eos_token_id=-1)
    cont = engines("continuous")[1].generate(
        prompt, max_new_tokens=25, eos_token_id=-1)
    assert naive[0] == cont[0]
    assert cont[1]["turns"] <= naive[1]["turns"]


def test_resume_matches_jax_and_full_prefill(engines):
    """Two chained resumes (as tests/test_resume.py:132 chains them): each
    equals JAX's resume (tokens and stats) and a fresh port run on the
    whole history."""
    jeng, eng = engines("continuous")
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, 11, 11).tolist()
    kw = dict(eos_token_id=-1, return_state=True)
    jout, _, jst = jeng.generate(prompt, max_new_tokens=10, **kw)
    out, _, st = eng.generate(prompt, max_new_tokens=10, **kw)
    assert out == [int(t) for t in jout]
    for extra_len, n_new in ((7, 10), (4, 8)):
        extra = rng.integers(3, 11, extra_len).tolist()
        jout2, jstats, jst = jeng.resume_and_generate(
            jst, out, extra, max_new_tokens=n_new, **kw)
        out2, stats, st = eng.resume_and_generate(st, out, extra,
                                                  max_new_tokens=n_new, **kw)
        assert out2 == [int(t) for t in jout2] and stats == jstats
        fresh, _ = eng.generate(out + extra, max_new_tokens=n_new,
                                eos_token_id=-1)
        assert out2 == fresh
        out = out2


def test_bridged_jax_state_resumes_in_the_port(engines):
    """A JAX PipeState after a generate, bridged (bridge.pipe_state), is
    grown to the port's rows and resumed with JAX's tokens and stats."""
    jeng, eng = engines("continuous")
    rng = np.random.default_rng(8)
    prompt = rng.integers(3, 11, 9).tolist()
    extra = rng.integers(3, 11, 5).tolist()
    jout, _, jst = jeng.generate(prompt, max_new_tokens=9, eos_token_id=-1,
                                 return_state=True)
    jout = [int(t) for t in jout]
    leaves = {f.name: to_numpy_dict(getattr(jst, f.name))
              for f in dataclasses.fields(jst) if f.name != "key"}
    st = bridge.pipe_state(leaves, eng.layer_split, device="cpu")
    assert st.kv.k.shape[0] == 4 and int(st.commit_len) >= len(jout) - 1
    want, wstats = jeng.resume_and_generate(jst, jout, extra,
                                            max_new_tokens=9,
                                            eos_token_id=-1)
    got, stats = eng.resume_and_generate(st, jout, extra, max_new_tokens=9,
                                         eos_token_id=-1)
    assert got == [int(t) for t in want] and stats == wstats
    assert st.kv.max_len < eng.base_rows    # grown on resume, not before
