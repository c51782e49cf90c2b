"""The dry run's trained-fixture gates (`entry.py trained_gates`) on the CPU.

`tests/fixtures/tiny_l8_base.npz` holds JAX's `init_llama_params(
jax.random.key(0), mc8, f32)` draw (the 8-layer tiny base of
`__graft_entry__.py:156-158`, which the port cannot draw) in `save_base`'s
leaf layout: it must equal that draw leaf for leaf, read by JAX's loader
and by the port's. `dryrun_multichip(4, device="cpu")` must pass both
gates (continuous and pruned equal to the AR stream, accept/round above
1.5 and 2.5), and at 4 stages on the continuous schedule the struct tiny8
gate's tokens and accept/round must equal a JAX `PipelineEngine`'s on the
same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flowspec_tpu.config import EngineConfig as JEngineConfig
from flowspec_tpu.config import ModelConfig as JModelConfig
from flowspec_tpu.config import SamplingConfig as JSamplingConfig
from flowspec_tpu.config import StageTopology as JStageTopology
from flowspec_tpu.config import TreeConfig as JTreeConfig
from flowspec_tpu.eval.synth import gen_struct_corpus
from flowspec_tpu.models.llama import init_llama_params
from flowspec_tpu.parallel import PipelineEngine as JPipelineEngine
from flowspec_tpu_torch.entry import (
    STRUCT_BASE, STRUCT_DRAFT, TINY_L8_BASE, dryrun_multichip, struct_gate,
    tiny_l8_gate,
)
from flowspec_tpu_torch.parallel import PipelineEngine, stage_mesh
from tests.torch_bridge_util import port_llama
from tests.torch_engine_util import one_torch_thread  # noqa: F401
from tools.train_struct_base import (
    SCALES, load_base, load_draft, model_config,
)

CPU = torch.device("cpu")


def _mc8():
    return dataclasses.replace(JModelConfig.tiny(vocab_size=64, n_layers=8),
                               dtype="float32")


def test_tiny_l8_base_fixture_equals_jax_draw():
    want = init_llama_params(jax.random.key(0), _mc8(), dtype=jnp.float32)
    leaves = jax.tree_util.tree_leaves(want)
    with np.load(TINY_L8_BASE) as z:
        assert sorted(z.files) == sorted(f"p{i}" for i in range(len(leaves)))
        for i, leaf in enumerate(leaves):
            assert z[f"p{i}"].dtype == np.float32
            np.testing.assert_array_equal(z[f"p{i}"], np.asarray(leaf))
    # JAX's own loader reads it back as the draw, and the port's loader
    # gives the bridged draw
    for a, b in zip(jax.tree_util.tree_leaves(
            load_base(str(TINY_L8_BASE), _mc8())), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, base, *_ = tiny_l8_gate(4, CPU)
    ref = port_llama(want)
    for f in ("embed", "final_norm", "lm_head"):
        assert torch.equal(getattr(base, f), getattr(ref, f)), f
    for f in dataclasses.fields(base.layers):
        assert torch.equal(getattr(base.layers, f.name),
                           getattr(ref.layers, f.name)), f.name


def test_dryrun_multichip_passes_both_trained_gates():
    report = dryrun_multichip(4, device="cpu")
    for name, bar in (("continuous_trained", 1.5), ("pruned_trained", 1.5),
                      ("continuous_struct_d8", 2.5),
                      ("pruned_struct_d8", 2.5)):
        r = report[name]
        assert r["ok"] and r["equal"], (name, r)
        assert r["accept_per_round"] > bar and r["stages"] == 4, (name, r)
        assert r["dtype"] == "float32"


def test_struct_gate_continuous_equals_jax_pipeline():
    """At 4 stages, continuous: the port's gate run gives a JAX
    `PipelineEngine`'s tokens and accept/round on the same weights."""
    s8 = SCALES["tiny8"]
    mc = dataclasses.replace(model_config(s8), dtype="float32")
    jbase = load_base(str(STRUCT_BASE), mc)
    jdraft = load_draft(str(STRUCT_DRAFT), jbase.embed, jnp.float32)
    tc = JTreeConfig(top_k=8, depth=8, total_tokens=48, expand_tokens=24,
                     expand_depth=2, node_cap=64, leaf_cap=64, depth_cap=12,
                     chunk_len=8, chunk_cap=12, score_temperature=0.2)
    jcfg = JEngineConfig(model=mc, tree=tc, sampling=JSamplingConfig(),
                         max_seq_len=256, prefill_chunk=8,
                         topology=JStageTopology.even(s8["layers"], 4))
    prompt = gen_struct_corpus(1, 32, vocab=s8["vocab"], seed=2,
                               n_classes=s8["n_classes"],
                               copy_dist=s8["copy_dist"])[0, :24]
    jeng = JPipelineEngine(jbase, jdraft, jcfg,
                           mesh=Mesh(np.array(jax.devices()[:4]), ("stage",)),
                           schedule="continuous")
    want, wstats = jeng.generate(prompt, max_new_tokens=32, eos_token_id=-1)

    cfg, base, draft, tprompt, new = struct_gate(4, CPU)
    assert tprompt == prompt.tolist() and new == 32
    eng = PipelineEngine(base, draft, cfg, device=CPU, mesh=stage_mesh(4),
                         schedule="continuous")
    got, stats = eng.generate(tprompt, max_new_tokens=new, eos_token_id=-1)
    assert got == [int(t) for t in want]
    assert stats["accept_per_round"] == pytest.approx(
        wstats["accept_per_round"], abs=0)
    assert stats["rounds"] == wstats["rounds"]
    assert stats["accept_per_round"] > 2.5
