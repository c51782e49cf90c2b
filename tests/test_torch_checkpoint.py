"""Checkpoints shared by the two packages, on the CPU.

Params saved by the JAX package's `save_params` load bit for bit in the
port's `load_params` and the reverse (bf16, int8, nf4, int4, Mixtral, an
EAGLE draft, a KV cache); a port engine state saved after 4 rounds and
loaded back finishes with the uninterrupted stream (greedy, and sampling
with the same seed: the generator's state is saved); and a greedy state
saved by the JAX engine loads in the port and finishes with the JAX
engine's uninterrupted stream (f32, where the two packages decide the same
tokens; tests/test_checkpoint.py is the JAX package's own check).
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
from flowspec_tpu.models import checkpoint as jckpt
from flowspec_tpu.models.kv_cache import init_kv_cache as jinit_kv
from flowspec_tpu.models.llama import (
    init_llama_params, quantize_llama_params,
)
from flowspec_tpu.models.mixtral import init_mixtral_params
from flowspec_tpu.runtime.engine import SpecEngine as JSpecEngine
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.draft.eagle import EagleParams
from flowspec_tpu_torch.models import checkpoint as ckpt
from flowspec_tpu_torch.models.kv_cache import KVCache
from flowspec_tpu_torch.models.llama import LlamaParams
from flowspec_tpu_torch.models.mixtral import MixtralParams
from flowspec_tpu_torch.ops.quant import Int4Tensor, Int8Tensor, NF4Tensor
from flowspec_tpu_torch.runtime import SpecEngine
from tests.torch_bridge_util import (
    port_cache, port_eagle, port_llama, port_mixtral,
)

CONTAINER = {"int8": Int8Tensor, "nf4": NF4Tensor, "int4": Int4Tensor}


def _leaves(tree, prefix=""):
    """{path: (class of the container, numpy bits)} of a JAX or port tree."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        path = prefix + f.name
        if dataclasses.is_dataclass(v):
            out[path] = (type(v).__name__, None)
            out.update(_leaves(v, path + "."))
        elif v is None:
            out[path] = (None, None)
        elif isinstance(v, torch.Tensor):
            out[path] = ("leaf", v.view(torch.int16).numpy().view(np.uint16)
                         if v.dtype == torch.bfloat16 else v.numpy())
        else:
            a = np.asarray(v)
            out[path] = ("leaf", a.view(np.uint16)
                         if a.dtype.name == "bfloat16" else a)
    return out


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert type(a).__name__ == type(b).__name__
    assert {k: v[0] for k, v in la.items()} == {k: v[0] for k, v in lb.items()}
    for k, (kind, x) in la.items():
        if kind == "leaf":
            y = lb[k][1]
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def _jax_trees(kind):
    mc = JModelConfig.tiny(vocab_size=64)
    if kind == "mixtral":
        mc = dataclasses.replace(mc, num_local_experts=4)
        return init_mixtral_params(jax.random.key(0), mc), port_mixtral
    p = init_llama_params(jax.random.key(0), mc)            # bf16
    if kind != "bf16":
        p = quantize_llama_params(p, kind)
    return p, port_llama


@pytest.mark.parametrize("kind", ["bf16", "int8", "nf4", "int4", "mixtral"])
def test_params_cross_load(tmp_path, kind):
    """JAX save -> port load, and port save -> JAX load, bit for bit."""
    jp, to_port = _jax_trees(kind)
    jckpt.save_params(jp, str(tmp_path / "jax"))
    got = ckpt.load_params(str(tmp_path / "jax"), device="cpu")
    assert isinstance(got, MixtralParams if kind == "mixtral"
                      else LlamaParams)
    if kind in CONTAINER:
        assert type(got.layers.wq) is CONTAINER[kind]
    _assert_bit_equal(got, jp)
    ckpt.save_params(to_port(jp), str(tmp_path / "port"))
    _assert_bit_equal(jckpt.load_params(str(tmp_path / "port")), jp)


def test_draft_and_cache_cross_load(tmp_path):
    """An int8 EAGLE draft (w_out None), a thin bf16 one and a KV cache."""
    from flowspec_tpu.draft.eagle import quantize_eagle_params
    mc = JModelConfig.tiny(vocab_size=64)
    full = quantize_eagle_params(jinit_eagle(jax.random.key(1), mc), "int8")
    thin = jinit_eagle(jax.random.key(2), mc, width=32, n_heads=2,
                       n_kv_heads=2, inter=64)
    cache = jinit_kv(2, 1, 2, 32, 16, jnp.bfloat16)
    cache = dataclasses.replace(
        cache, k=cache.k + 1.5, length=jnp.asarray(7, jnp.int32))
    for name, tree, to_port in (("full", full, port_eagle),
                                ("thin", thin, port_eagle),
                                ("cache", cache, port_cache)):
        jckpt.save_params(tree, str(tmp_path / ("jax_" + name)))
        got = ckpt.load_params(str(tmp_path / ("jax_" + name)), device="cpu")
        assert isinstance(got, KVCache if name == "cache" else EagleParams)
        _assert_bit_equal(got, tree)
        ckpt.save_params(to_port(tree), str(tmp_path / ("port_" + name)))
        _assert_bit_equal(
            jckpt.load_params(str(tmp_path / ("port_" + name))), tree)
    assert got.length.shape == () and int(got.length) == 7


def test_pipe_state_is_refused(tmp_path):
    (tmp_path / "manifest.json").write_text(
        '{"__class__": "PipeState", "fields": {}}')
    with pytest.raises(ValueError, match="PipeState"):
        ckpt.load_state(str(tmp_path), device="cpu")


MC = dataclasses.replace(JModelConfig.tiny(vocab_size=16, n_layers=2),
                         dtype="float32")
TREE = dict(top_k=6, depth=3, total_tokens=16, expand_tokens=12,
            expand_depth=2, node_cap=32, leaf_cap=32, depth_cap=10,
            chunk_len=8)
N_NEW = 12


@pytest.fixture(scope="module")
def pair():
    p = init_llama_params(jax.random.key(0), MC, dtype=jnp.float32)
    d = jinit_eagle(jax.random.key(9), MC, embed=p.embed, dtype=jnp.float32)
    return p, d


def _port_engine(pair, temperature=0.0):
    p, d = pair
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(MC)),
        tree=tcfg.TreeConfig(**TREE),
        sampling=tcfg.SamplingConfig(temperature=temperature),
        max_seq_len=128, prefill_chunk=16)
    return SpecEngine(port_llama(p), port_eagle(d), cfg, device="cpu")


def _finish(eng, st, out, n_total):
    while len(out) < n_total:
        st, acc, n = eng._round(st)
        out += acc[:int(n)].tolist()
    return out[:n_total]


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_port_state_resume_equals_uninterrupted(tmp_path, pair, temperature):
    eng = _port_engine(pair, temperature)
    prompt = [int(t) for t in np.random.default_rng(0).integers(3, 14, 8)]
    full, _ = eng.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1,
                           seed=3)
    st = eng.prefill(eng.init_state(3), prompt)
    out = list(prompt)
    for _ in range(4):
        st, acc, n = eng._round(st)
        out += acc[:int(n)].tolist()
    ckpt.save_state(st, str(tmp_path / "st"))
    st2 = ckpt.load_state(str(tmp_path / "st"), device="cpu")
    assert int(st2.commit_len) == int(st.commit_len)
    assert torch.equal(st2.rng, st.rng)
    assert _finish(eng, st2, out, len(prompt) + N_NEW) == full


def test_jax_greedy_state_resumes_in_the_port(tmp_path, pair):
    """A greedy state of the JAX engine, saved after 4 rounds, loads in the
    port (its PRNG key seeds a fresh draw stream) and finishes with the JAX
    engine's uninterrupted stream."""
    p, d = pair
    jcfg = JEngineConfig(model=MC, tree=JTreeConfig(**TREE),
                         sampling=JSamplingConfig(), max_seq_len=128,
                         prefill_chunk=16)
    jeng = JSpecEngine(p, d, jcfg)
    prompt = [int(t) for t in np.random.default_rng(0).integers(3, 14, 8)]
    full, _ = jeng.generate(prompt, max_new_tokens=N_NEW, eos_token_id=-1)
    st = jeng.prefill(jeng.init_state(0), prompt)
    out = list(prompt)
    for _ in range(4):
        st, res = jeng._round(st, jeng.params, jeng.draft)
        out += [int(t) for t in
                np.asarray(res.accepted)[:int(res.n_accepted)]]
    jckpt.save_state(st, str(tmp_path / "st"))
    port_st = ckpt.load_state(str(tmp_path / "st"), device="cpu")
    assert port_st.rng.shape == (1, 2)
    assert int(port_st.commit_len) == int(st.commit_len)
    eng = _port_engine(pair)
    assert _finish(eng, port_st, out, len(prompt) + N_NEW) == \
        [int(t) for t in full]
