"""The port's `PipelineEngine` against the JAX package's in the hard corners.

The high-acceptance stress (vocab 8, a deep top-7 beam, 4-token chunks,
seeds 4 and 5: verdicts that leave only zero-length queue entries, the
pipedec draft-KV ordering) for pruned / continuous / pipedec; none_expand
firing on bubble turns, and not firing when off; Mixtral through the
pipeline (tests/test_pipeline.py:131-230, tests/test_model_variants.py:180).
Each gives the JAX engine's tokens, its stats key for key and the port's AR
stream. A JAX engine serves a second seed's weights of the same shapes
through its compiled programs (`rebind`). Stochastic continuous decoding
keeps the first token's law.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from flowspec_tpu.config import ModelConfig as JModelConfig
from flowspec_tpu.draft.eagle import init_eagle_params
from flowspec_tpu.models.llama import init_llama_params
from flowspec_tpu.models.mixtral import init_mixtral_params
from flowspec_tpu.parallel import PipelineEngine as JPipelineEngine
from flowspec_tpu.parallel.mesh import put_global
from flowspec_tpu.runtime.engine import make_beam_head as j_beam_head
from flowspec_tpu_torch.parallel import PipelineEngine
from flowspec_tpu_torch.runtime import SpecEngine
from tests.test_torch_pipeline import TREE, configs, lossless, tiny_model
from tests.torch_bridge_util import port_eagle, port_llama, port_mixtral

STRESS = dict(top_k=7, depth=5, total_tokens=28, expand_tokens=12,
              expand_depth=2, node_cap=64, leaf_cap=64, depth_cap=14,
              chunk_len=4, chunk_cap=14)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are tiny: the port's ops run on one thread, leaving
    the other cores to the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rebind(jeng, p, d):
    """A copy of the JAX engine `jeng` serving weights `p`, `d` of the same
    shapes: its jitted programs take the weights as arguments, so the copy
    runs them without compiling again."""
    j2 = copy.copy(jeng)
    j2.params = jeng._shard_params(p)
    j2.draft = put_global(d, NamedSharding(jeng.mesh, PartitionSpec()))
    j2.beam_head = j_beam_head(j2.params, j2.draft, jeng.cfg)
    return j2


def stress_weights(seed):
    mc = tiny_model(8)
    p = init_llama_params(jax.random.key(seed), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(100 + seed), mc, embed=p.embed,
                          dtype=jnp.float32)
    return p, d, port_llama(p), port_eagle(d)


@pytest.fixture(scope="module")
def stress():
    """Per seed 4, 5: the weights, the port's AR engine and per schedule
    the (JAX, port) engine pair; seed 5's JAX engines rebind seed 4's."""
    mc = tiny_model(8)
    jcfg, cfg = configs(mc, STRESS)
    out = {}
    for seed in (4, 5):
        p, d, tp, td = stress_weights(seed)
        pairs = {}
        for sched in ("pruned", "continuous", "pipedec"):
            jeng = (JPipelineEngine(p, d, jcfg, schedule=sched) if seed == 4
                    else rebind(out[4]["pairs"][sched][0], p, d))
            pairs[sched] = (jeng, PipelineEngine(tp, td, cfg, schedule=sched,
                                                 device="cpu"))
        out[seed] = {"pairs": pairs, "weights": (p, d, tp, td),
                     "ar": SpecEngine(tp, td, cfg, device="cpu")}
    return out


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("schedule", ["pruned", "continuous", "pipedec"])
def test_high_acceptance_stress_matches_jax(stress, seed, schedule):
    prompt = [int(t) for t in np.random.default_rng(seed).integers(2, 7, 8)]
    jeng, eng = stress[seed]["pairs"][schedule]
    lossless(jeng, eng, prompt, 24, stress[seed]["ar"])


def test_none_expand_fires_like_jax(stress):
    """none_expand on bubble turns (ref stage_ea_model.py:1347-1382): the
    same fires, rounds and tokens as JAX's; with it off, none fire and the
    rounds are no fewer."""
    mc = tiny_model(8)
    p, d, tp, td = stress[4]["weights"]
    jcfg, cfg = configs(mc, {**STRESS, "none_expand": False})
    off = (JPipelineEngine(p, d, jcfg, schedule="continuous"),
           PipelineEngine(tp, td, cfg, schedule="continuous", device="cpu"))
    on = stress[4]["pairs"]["continuous"]
    rounds, fires = {}, {}
    for key, (jeng, eng) in (("on", on), ("off", off)):
        rounds[key] = fires[key] = 0
        for seed in (5, 6):
            prompt = [int(t) for t in
                      np.random.default_rng(seed).integers(2, 7, 8)]
            stats = lossless(jeng, eng, prompt, 24, stress[4]["ar"])
            rounds[key] += stats["rounds"]
            fires[key] += stats["ne_fires"]
    assert fires["on"] > 0 and fires["off"] == 0
    assert rounds["on"] <= rounds["off"], rounds


def test_mixtral_pipeline_matches_jax():
    """MoE through the four-stage pipeline (the pipeline half of
    tests/test_model_variants.py:180)."""
    mc = JModelConfig(vocab_size=32, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=4, num_attention_heads=4,
                      num_key_value_heads=2, num_local_experts=4,
                      num_experts_per_tok=2, max_position_embeddings=512,
                      dtype="float32")
    tree = dict(top_k=6, depth=3, total_tokens=16, expand_tokens=12,
                expand_depth=2, node_cap=32, leaf_cap=32, depth_cap=10,
                chunk_len=6)
    jcfg, cfg = configs(mc, tree, max_seq=128)
    p = init_mixtral_params(jax.random.key(0), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(9), mc, embed=p.embed,
                          dtype=jnp.float32)
    tp, td = port_mixtral(p), port_eagle(d)
    prompt = [int(t) for t in np.random.default_rng(0).integers(3, 30, 9)]
    lossless(JPipelineEngine(p, d, jcfg, schedule="continuous"),
             PipelineEngine(tp, td, cfg, schedule="continuous",
                            device="cpu"),
             prompt, 14, SpecEngine(tp, td, cfg, device="cpu"))


def test_stochastic_continuous_first_token_law():
    """At temperature 1 the first token `generate` emits is a draw from
    the base model's next-token distribution after the prompt: 300 seeds
    match softmax(base logits) in total variation, and draw more than one
    token."""
    mc = tiny_model(12)
    p = init_llama_params(jax.random.key(2), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(7), mc, embed=p.embed,
                          dtype=jnp.float32)
    _, cfg = configs(mc, TREE, temperature=1.0)
    tp, td = port_llama(p), port_eagle(d)
    eng = PipelineEngine(tp, td, cfg, schedule="continuous", device="cpu")
    prompt = [5, 9, 3, 7, 4, 11]
    n = 300
    firsts = np.array([eng.generate(prompt, max_new_tokens=1,
                                    eos_token_id=-1, seed=s)[0][len(prompt)]
                       for s in range(n)])
    spec = SpecEngine(tp, td, cfg, device="cpu")
    _, last_logits = spec._prefill_chunks(spec.init_state(0), prompt)
    p_ref = torch.softmax(last_logits.float(), dim=-1).numpy()
    emp = np.bincount(firsts, minlength=12) / n
    tv = 0.5 * np.abs(emp - p_ref).sum()
    assert tv < 0.15, (tv, emp.round(3).tolist(), p_ref.round(3).tolist())
    assert len(set(firsts.tolist())) > 1
