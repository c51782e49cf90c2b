"""What the port's engine parity tests share: the trained struct_tiny8 pair
(tests/fixtures/struct_tiny8_*.npz) quantized one way, as a JAX engine and
the port's, and the fixture that sends JAX's packed 4-bit products through
the TPU kernels in interpret mode. The 4-bit cases of
`test_port_generate_matches_jax_token_for_token_4bit` run one kind a file
(tests/test_torch_engine.py, test_torch_engine_nf4.py,
test_torch_engine_int4.py), so that `--dist loadfile` spreads them over
workers; `one_torch_thread`, which the port's heavier CPU test modules
import."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import (
    EngineConfig as JEngineConfig, SamplingConfig as JSamplingConfig,
    TreeConfig as JTreeConfig,
)
from flowspec_tpu.draft.eagle import quantize_eagle_params
from flowspec_tpu.models.llama import quantize_llama_params
from flowspec_tpu.runtime.engine import SpecEngine as JSpecEngine
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.runtime import SpecEngine
from tests.torch_bridge_util import port_eagle, port_llama
from tools.train_struct_base import (
    SCALES, load_base, load_draft, model_config,
)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TREE = dict(total_tokens=48, depth=8, score_temperature=0.2, node_cap=96,
            leaf_cap=96, depth_cap=16)
N_NEW = 40


def _struct_pair(kind):
    mc = dataclasses.replace(model_config(SCALES["tiny8"]), dtype="float32")
    base = load_base(os.path.join(FIX, "struct_tiny8_base.npz"), mc)
    draft = load_draft(os.path.join(FIX, "struct_tiny8_draft.npz"),
                       base.embed, jnp.float32)
    base = quantize_llama_params(base, kind)
    draft = quantize_eagle_params(draft, kind)
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**TREE),
                         sampling=JSamplingConfig(), max_seq_len=128)
    tc = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(mc)),
        tree=tcfg.TreeConfig(**TREE), sampling=tcfg.SamplingConfig(),
        max_seq_len=128)
    port = SpecEngine(port_llama(base), port_eagle(draft), tc, device="cpu")
    prompt = np.random.default_rng(2).integers(
        3, mc.vocab_size, size=24).astype(np.int32)
    return JSpecEngine(base, draft, jcfg), port, prompt



@pytest.fixture
def jax_4bit_through_pallas(monkeypatch):
    """Send JAX's nf4 / int4 products through the TPU kernels in interpret
    mode; drop every trace made that way afterwards, so no later test of
    this process reuses one."""
    from jax.experimental.pallas import tpu as pltpu
    from flowspec_tpu.ops import quant as jquant
    monkeypatch.setattr(jquant, "_USE_PALLAS",
                        {"int8": False, "nf4": True, "int4": True})
    with pltpu.force_tpu_interpret_mode():
        yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops of a module importing this fixture on one thread:
    with six test workers on eight cores, eight threads an op each slowed
    these modules' CPU runs several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
