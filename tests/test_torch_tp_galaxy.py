"""The port's galaxy TP, PP x TP and expert-parallel Mixtral against the
JAX package's, on the CPU in f32.

- The ring primitives (`ring_ag_matmuls`, `ring_matmul_rs`) give what
  JAX's give under `shard_map` on the same inputs (tests/test_galaxy.py:
  26-60).
- `TPEngine(galaxy=True)` at tp 2 on tests/test_galaxy.py's setup gives
  the JAX galaxy engine's tokens, rounds and accept/round, the galaxy
  forward engaged on every verify (16 rows) and prefill chunk.
- `PipelineEngine` on `stage_tp_mesh(4, 2)`, continuous, gives the JAX
  engine's tokens and stats on tests/test_tp.py:74-107's setup; on an
  uneven split (1, 3, 2, 2) the stats and tokens of the port's unsharded
  pipeline on that split, which are the AR stream.
- Mixtral at tp 2 (two experts a rank) gives the unsharded engine's and
  JAX's `SpecEngine`'s tokens and stats.
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
from flowspec_tpu.models.mixtral import init_mixtral_params
from flowspec_tpu.parallel import PipelineEngine as JPipelineEngine
from flowspec_tpu.parallel.mesh import (
    stage_tp_mesh as jstage_tp_mesh, tp_mesh as jtp_mesh,
)
from flowspec_tpu.parallel.tp import TPEngine as JTPEngine
from flowspec_tpu.runtime.engine import SpecEngine as JSpecEngine
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.parallel import (
    PipelineEngine, TPEngine, stage_tp_mesh, tp_mesh,
)
from flowspec_tpu_torch.parallel.comm import InProcessGroup
from flowspec_tpu_torch.parallel.galaxy import ring_ag_matmuls, ring_matmul_rs
from flowspec_tpu_torch.runtime import SpecEngine
from tests.torch_bridge_util import port_eagle, port_llama, port_mixtral


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg):
    """The port's EngineConfig of the same values as a JAX one."""
    return tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(jcfg.model)),
        tree=tcfg.TreeConfig(**dataclasses.asdict(jcfg.tree)),
        sampling=tcfg.SamplingConfig(
            **dataclasses.asdict(jcfg.sampling)),
        topology=tcfg.StageTopology(
            **dataclasses.asdict(jcfg.topology)),
        max_new_tokens=jcfg.max_new_tokens, max_seq_len=jcfg.max_seq_len,
        prefill_chunk=jcfg.prefill_chunk)


def same_run(want, wstats, got, gstats, keys=("rounds",
                                              "accept_per_round")):
    assert [int(t) for t in want] == got
    for k in keys:
        assert gstats[k] == wstats[k], k


def test_ring_primitives_match_jax():
    from jax.sharding import PartitionSpec as P
    from flowspec_tpu.parallel import galaxy as jg

    tp, t, h, o = 4, 8, 16, 12
    k = jax.random.key(0)
    x = jax.random.normal(k, (t, h), jnp.float32)
    w1 = jax.random.normal(jax.random.fold_in(k, 1), (h, o), jnp.float32)
    w2 = jax.random.normal(jax.random.fold_in(k, 2), (h, o), jnp.float32)
    wr = jax.random.normal(jax.random.fold_in(k, 3), (h, o * 2), jnp.float32)
    mesh = jtp_mesh(tp)
    ag = jax.shard_map(
        lambda xl, a, b: jg.ring_ag_matmuls(xl, [a, b], "tp", tp),
        mesh=mesh, in_specs=(P("tp", None), P(None, "tp"), P(None, "tp")),
        out_specs=[P(None, "tp"), P(None, "tp")], check_vma=False)
    j1, j2 = (np.asarray(y) for y in ag(x, w1, w2))
    rs = jax.shard_map(
        lambda yl, wl: jg.ring_matmul_rs(yl, wl, "tp", tp),
        mesh=mesh, in_specs=(P(None, "tp"), P("tp", None)),
        out_specs=P("tp", None), check_vma=False)
    jz = np.asarray(rs(x, wr))

    g = InProcessGroup(tp)
    xt, w1t, w2t, wrt = (torch.from_numpy(np.array(a))
                         for a in (x, w1, w2, wr))
    cols = lambda w: list(w.chunk(tp, dim=1))
    y1, y2 = ring_ag_matmuls(list(xt.chunk(tp)), [cols(w1t), cols(w2t)], g)
    np.testing.assert_allclose(torch.cat(y1, 1).numpy(), j1, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat(y2, 1).numpy(), j2, rtol=1e-5,
                               atol=1e-5)
    z = ring_matmul_rs(list(xt.chunk(tp, dim=1)), list(wrt.chunk(tp)), g)
    np.testing.assert_allclose(torch.cat(z).numpy(), jz, rtol=1e-5,
                               atol=1e-5)


def test_galaxy_engine_matches_jax():
    mc = dataclasses.replace(JModelConfig.tiny(), dtype="float32")
    jcfg = JEngineConfig(
        model=mc, tree=JTreeConfig(total_tokens=15, top_k=4, depth=3,
                                   node_cap=16, leaf_cap=8, depth_cap=6),
        sampling=JSamplingConfig(), max_new_tokens=24, max_seq_len=160,
        prefill_chunk=16)
    p = init_llama_params(jax.random.key(3), cfg=mc)
    d = init_eagle_params(jax.random.key(4), mc, embed=p.embed,
                          dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(3, 30, 11).tolist()
    jeng = JTPEngine(p, d, jcfg, mesh=jtp_mesh(2), galaxy=True)
    want, wstats = jeng.generate(prompt, max_new_tokens=24, eos_token_id=-1)
    eng = TPEngine(port_llama(p), port_eagle(d), port_cfg(jcfg),
                   mesh=tp_mesh(2), galaxy=True, device="cpu")
    got, gstats = eng.generate(prompt, max_new_tokens=24, eos_token_id=-1)
    same_run(want, wstats, got, gstats)
    # the prefill chunk and every verify (16 rows) took the galaxy stack
    assert eng.forward_fn.engaged == 1 + gstats["rounds"]
    assert eng.forward_fn.fallbacks == 0
    # the AR step (one row, one a new token) falls back to the plain TP
    # forward
    ar, _ = eng.generate_ar(prompt, max_new_tokens=24, eos_token_id=-1)
    assert ar == got and eng.forward_fn.fallbacks == 24


def pipe_setup():
    mc = JModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=8, num_attention_heads=8,
                      num_key_value_heads=4, max_position_embeddings=512,
                      dtype="float32")
    tc = JTreeConfig(top_k=6, depth=3, total_tokens=18, expand_tokens=12,
                     expand_depth=2, node_cap=48, leaf_cap=48, depth_cap=12,
                     chunk_len=4, chunk_cap=12)
    jcfg = JEngineConfig(model=mc, tree=tc, sampling=JSamplingConfig(),
                         max_seq_len=256, prefill_chunk=8,
                         topology=JStageTopology.even(8, 4))
    p = init_llama_params(jax.random.key(5), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(15), mc, embed=p.embed,
                          dtype=jnp.float32)
    prompt = np.random.default_rng(7).integers(3, 120, 10).tolist()
    return jcfg, p, d, prompt


def test_pipeline_stage_tp_matches_jax():
    jcfg, p, d, prompt = pipe_setup()
    jeng = JPipelineEngine(p, d, jcfg, mesh=jstage_tp_mesh(4, 2),
                           schedule="continuous")
    want, wstats = jeng.generate(prompt, max_new_tokens=10, eos_token_id=-1)
    cfg = port_cfg(jcfg)
    eng = PipelineEngine(port_llama(p), port_eagle(d), cfg,
                         mesh=stage_tp_mesh(4, 2), schedule="continuous",
                         device="cpu")
    assert eng.tp == 2
    # the stage views' weights are tp shards, not the whole
    assert eng.stage_params[0].shards[1].layers.wq.shape == (2, 64, 32)
    got, gstats = eng.generate(prompt, max_new_tokens=10, eos_token_id=-1)
    assert [int(t) for t in want] == got
    assert gstats == wstats

    # an uneven split: the unsharded pipeline's tokens and stats
    cfg2 = dataclasses.replace(cfg, topology=tcfg.StageTopology(
        num_stages=4, layers_per_stage=(1, 3, 2, 2)))
    ref = PipelineEngine(port_llama(p), port_eagle(d), cfg2,
                         schedule="continuous", device="cpu")
    eng2 = PipelineEngine(port_llama(p), port_eagle(d), cfg2,
                          mesh=stage_tp_mesh(4, 2), schedule="continuous",
                          device="cpu")
    assert [len(range(lo, hi)) for lo, hi in eng2.stage_layers] == \
        [1, 3, 2, 2]
    r_out, r_stats = ref.generate(prompt, max_new_tokens=10,
                                  eos_token_id=-1)
    out2, stats2 = eng2.generate(prompt, max_new_tokens=10, eos_token_id=-1)
    assert out2 == r_out == got and stats2 == r_stats


def test_mixtral_expert_parallel_matches_jax():
    mc = JModelConfig(vocab_size=32, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, num_local_experts=4,
                      num_experts_per_tok=2, max_position_embeddings=512,
                      dtype="float32")
    tree = dict(top_k=8, depth=4, total_tokens=24, expand_tokens=16,
                expand_depth=2, node_cap=48, leaf_cap=48, depth_cap=12,
                chunk_len=8)
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**tree),
                         sampling=JSamplingConfig(), max_seq_len=256,
                         prefill_chunk=16)
    p = init_mixtral_params(jax.random.key(0), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(100), mc, embed=p.embed,
                          dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(3, 30, 10).tolist()
    want, wstats = JSpecEngine(p, d, jcfg).generate(
        prompt, max_new_tokens=20, eos_token_id=-1)
    cfg = port_cfg(jcfg)
    ref, rstats = SpecEngine(port_mixtral(p), port_eagle(d), cfg,
                             device="cpu").generate(
        prompt, max_new_tokens=20, eos_token_id=-1)
    eng = TPEngine(port_mixtral(p), port_eagle(d), cfg, mesh=tp_mesh(2),
                   device="cpu")
    assert eng.params.shards[0].layers.w_gate.shape[1] == 2
    got, gstats = eng.generate(prompt, max_new_tokens=20, eos_token_id=-1)
    same_run(want, wstats, got, gstats)
    assert got == ref and gstats == rstats
