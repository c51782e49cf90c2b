"""The port's tensor parallelism against the JAX package's, on the CPU.

Shards: for tp 2 and 4, every leaf of `shard_params_tp`,
`_shard_mixtral_tp` and `shard_draft_tp` holds on rank r exactly JAX's
`leaf.addressable_shards[r].data` (the JAX layout over the test's 8
virtual CPU devices), for f32 and bf16, the int8 / int4 / nf4 containers,
Qwen2's biases and Mixtral's experts. Engines, in f32 on tests/test_tp.py's
config (8 query heads on 4 KV heads, vocab 64): the port's `TPEngine`
(in-process ranks) gives JAX's `TPEngine`'s tokens, rounds and accept/round
at tp 2 and 4. tests/test_torch_tp_dist.py shares this module's setup
for the rest: int8 at tp 2, `generate_fused`, a TP state saved unsharded,
and `BatchedSpecEngine.serve` over sharded weights.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
    SamplingConfig as JSamplingConfig, TreeConfig as JTreeConfig,
)
from flowspec_tpu.draft.eagle import (
    init_eagle_params, quantize_eagle_params,
)
from flowspec_tpu.models.llama import (
    init_llama_params, quantize_llama_params,
)
from flowspec_tpu.models.mixtral import init_mixtral_params
from flowspec_tpu.parallel import tp as jtp
from flowspec_tpu.parallel.mesh import tp_mesh as jtp_mesh
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.parallel import (
    TPEngine, shard_draft_tp, shard_params_tp, tp_mesh,
)
from tests.torch_bridge_util import (
    np_of, port_eagle, port_llama, port_mixtral,
)

TREE = dict(top_k=6, depth=3, total_tokens=15, expand_tokens=8,
            expand_depth=2, node_cap=32, leaf_cap=32, depth_cap=10,
            chunk_len=8)
N_NEW = 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the port's ops on one thread, the other cores left to
    the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_cfg(dtype="float32", **kw):
    """tests/test_tp.py's model: tiny() with 8 query heads on 4 KV heads."""
    mc = JModelConfig.tiny(vocab_size=64, n_layers=2)
    return dataclasses.replace(mc, dtype=dtype, num_attention_heads=8,
                               num_key_value_heads=4, **kw)


def configs(mc, tree=TREE):
    """(JAX EngineConfig, port EngineConfig) of the same values."""
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**tree),
                         sampling=JSamplingConfig(), max_seq_len=256,
                         prefill_chunk=16)
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(mc)),
        tree=tcfg.TreeConfig(**tree), sampling=tcfg.SamplingConfig(),
        max_seq_len=256, prefill_chunk=16)
    return jcfg, cfg


# ---- shard layouts ---------------------------------------------------------

def leaves(x, prefix=""):
    """(path, array or tensor) of every leaf of a dataclass tree (None
    leaves left out)."""
    if dataclasses.is_dataclass(x):
        out = []
        for f in dataclasses.fields(x):
            out += leaves(getattr(x, f.name), f"{prefix}{f.name}.")
        return out
    return [] if x is None else [(prefix.rstrip("."), x)]


def jax_shard(leaf, r):
    """JAX's shard of `leaf` on the mesh's device r."""
    shards = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
    if len(shards) == 1:        # left unplaced (the draft's w_out): whole
        return np.asarray(leaf)
    return np.asarray(shards[r].data)


def assert_same_shards(jax_tree, port_shards, tp):
    want = dict(leaves(jax_tree))
    assert len(port_shards) == tp
    for r, shard in enumerate(port_shards):
        got = dict(leaves(shard))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            w = jax_shard(want[path], r)
            g = np_of(t)
            assert g.shape == w.shape, (r, path, g.shape, w.shape)
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)


def normal(rng, shape, dtype, scale=None):
    """N(0, 1) x In^-1/2 (or `scale`) as a JAX array of `dtype`."""
    std = shape[-2] ** -0.5 if scale is None else scale
    return jnp.asarray(rng.normal(0, std, shape), dtype)


@functools.lru_cache(maxsize=None)
def qwen2_like(dtype, kind=None):
    """A JAX LLaMA base with Qwen2's qkv biases (random), quantized as
    `kind` (None: not), drawn with numpy (no init program to compile);
    wide enough for whole 64-row blocks in every row shard at tp 4 (wo In
    256, w_down In 512): H 256, 8 query heads on 4 KV heads, I 512."""
    if kind is not None:
        return quantize_llama_params(qwen2_like(dtype), kind)
    from flowspec_tpu.models.llama import LlamaLayerParams, LlamaParams
    rng = np.random.default_rng(3)
    dt = jnp.dtype(dtype)
    n, h, i, v, q, kv = 2, 256, 512, 64, 256, 128
    w = lambda *shape, scale=None: normal(rng, shape, dt, scale)
    layers = LlamaLayerParams(
        wq=w(n, h, q), wk=w(n, h, kv), wv=w(n, h, kv), wo=w(n, q, h),
        bq=w(n, q, scale=0.5), bk=w(n, kv, scale=0.5), bv=w(n, kv, scale=0.5),
        w_gate=w(n, h, i), w_up=w(n, h, i), w_down=w(n, i, h),
        input_ln=w(n, h, scale=1.0), post_ln=w(n, h, scale=1.0))
    return LlamaParams(embed=w(v, h, scale=0.02), layers=layers,
                       final_norm=w(h, 1, scale=1.0)[:, 0], lm_head=w(h, v))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4", "nf4"])
def test_llama_shards_equal_jax_shards(kind, tp):
    """Every leaf of the megatron layout, rank by rank, bit for bit."""
    p = qwen2_like("bfloat16" if kind == "bf16" else "float32",
                   None if kind in ("f32", "bf16") else kind)
    want = jtp.shard_params_tp(p, jtp_mesh(tp))
    got = shard_params_tp(port_llama(p), tp_mesh(tp))
    assert_same_shards(want, got.shards, tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_mixtral_shards_equal_jax_shards(tp):
    mc = model_cfg(num_local_experts=4, num_experts_per_tok=2)
    p = init_mixtral_params(jax.random.key(0), mc, dtype=jnp.float32)
    want = jtp.shard_params_tp(p, jtp_mesh(tp))
    got = shard_params_tp(port_mixtral(p), tp_mesh(tp))
    assert_same_shards(want, got.shards, tp)
    assert got.shards[0].layers.w_gate.shape[1] == 4 // tp


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["f32", "int8", "nf4"])
def test_draft_shards_equal_jax_shards(kind, tp):
    """The draft in the megatron layout: fc and fc_b by column, w_out /
    embed / post_ln replicated."""
    want = jtp.shard_draft_tp(thin_draft(kind), jtp_mesh(tp))
    got = shard_draft_tp(port_eagle(thin_draft(kind)), tp_mesh(tp))
    assert_same_shards(want, got.shards, tp)


@functools.lru_cache(maxsize=None)
def thin_draft(kind):
    """A thin JAX draft quantized as `kind` ("f32": not), drawn with numpy:
    W 256 on a 128-wide base, so w_out is present; 16 query heads on 8 KV
    heads of head dim 16; every row shard whole 64-row blocks at tp 4."""
    if kind != "f32":
        return quantize_eagle_params(thin_draft("f32"), kind)
    from flowspec_tpu.draft.eagle import EagleParams
    rng = np.random.default_rng(9)
    w = lambda *shape, scale=None: normal(rng, shape, jnp.float32, scale)
    return EagleParams(
        embed=w(64, 128, scale=0.02), fc_w=w(256, 256),
        fc_b=w(256, 1, scale=0.1)[:, 0], wq=w(256, 256), wk=w(256, 128),
        wv=w(256, 128), wo=w(256, 256), w_gate=w(256, 512),
        w_up=w(256, 512), w_down=w(512, 256),
        post_ln=w(256, 1, scale=1.0)[:, 0], w_out=w(256, 128))


def test_packed4_row_shard_needs_whole_scale_blocks():
    from flowspec_tpu_torch.models.llama import quantize_llama_params as q4
    p = q4(port_llama(init_llama_params(jax.random.key(3), model_cfg(),
                                        dtype=jnp.float32)), "nf4")
    with pytest.raises(ValueError, match="whole 64-row scale blocks"):
        shard_params_tp(p, tp_mesh(2))      # wo In 64 / 2 = 32 rows


# ---- engines ---------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    mc = model_cfg()
    jcfg, cfg = configs(mc)
    p = init_llama_params(jax.random.key(3), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(9), mc, embed=p.embed,
                          dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(3, 60, 11).tolist()
    return jcfg, cfg, p, d, prompt


def equal_runs(jeng, eng, prompt, method="generate", n_new=N_NEW):
    want, wstats = getattr(jeng, method)(prompt, max_new_tokens=n_new,
                                         eos_token_id=-1)
    got, gstats = getattr(eng, method)(prompt, max_new_tokens=n_new,
                                       eos_token_id=-1)
    assert [int(t) for t in want] == got
    assert gstats["rounds"] == wstats["rounds"]
    assert gstats["accept_per_round"] == wstats["accept_per_round"]
    return got, gstats


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_matches_jax(setup, tp):
    jcfg, cfg, p, d, prompt = setup
    jeng = jtp.TPEngine(p, d, jcfg, mesh=jtp_mesh(tp))
    eng = TPEngine(port_llama(p), port_eagle(d), cfg, mesh=tp_mesh(tp),
                   device="cpu")
    assert eng.params.shards[0].layers.wq.shape == (2, 64, 64 // tp)
    assert eng.init_state().base_cache.k.shape[2] == 4   # every rank's heads
    equal_runs(jeng, eng, prompt)
