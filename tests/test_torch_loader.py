"""The port's checkpoint loaders against the JAX package's, on the CPU.

Tiny LLaMA, Qwen2 and Mixtral checkpoints written by `transformers`
(`save_pretrained`, as tests/test_loader.py does) in F32, F16 and BF16, the
Qwen2 ones sharded through `model.safetensors.index.json`, and EAGLE heads
in the reference's HF layout (`*.safetensors` and `*.bin`). Every tensor the
port loads must equal, bit for bit, what the JAX loader gives for the same
files: loaded in f32 (exact from every source dtype) and in bf16 (one
round-to-nearest-even on both sides). The JAX loader reads through
`safetensors`' numpy API, which has no bfloat16, so for BF16 files the
reference is the same stacking and transposition of the tensors that
`safetensors`' torch API reads. The port's own reader must give the bytes
of the `safetensors` package for every dtype.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.draft.eagle import load_eagle_params as jload_eagle
from flowspec_tpu.models import loader as jloader
from flowspec_tpu.models.mixtral import load_mixtral_params as jload_mixtral
from flowspec_tpu_torch import models as tm
from flowspec_tpu_torch.draft.eagle import load_eagle_params
from flowspec_tpu_torch.models import loader
from flowspec_tpu_torch.models.mixtral import load_mixtral_params

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

SRC_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16}


def _hf_model(family: str, tied: bool = False):
    common = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, tie_word_embeddings=tied)
    torch.manual_seed({"llama": 0, "qwen2": 1, "mixtral": 2}[family])
    if family == "llama":
        return transformers.LlamaForCausalLM(
            transformers.LlamaConfig(**common))
    if family == "qwen2":
        return transformers.Qwen2ForCausalLM(
            transformers.Qwen2Config(**common, rope_theta=1e6,
                                     rms_norm_eps=1e-6))
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **common, num_local_experts=4, num_experts_per_tok=2))


def write_checkpoint(path, family, src_dtype, tied=False):
    """A tiny HF checkpoint in `src_dtype`; the Qwen2 ones in shards of
    ~20 KB named by an index. Returns the model (f32, for logits)."""
    hf = _hf_model(family, tied).eval()
    shard = "20KB" if family == "qwen2" else "5GB"
    hf.to(SRC_DTYPES[src_dtype]).save_pretrained(
        path, safe_serialization=True, max_shard_size=shard)
    return hf.float()


def _flat(tree, prefix=""):
    """{path: numpy} of a dataclass tree of arrays or tensors (a port bias
    of None is JAX's zero bias)."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        elif v is not None:
            if isinstance(v, torch.Tensor):
                v = (v.view(torch.int16).numpy().view(np.uint16)
                     if v.dtype == torch.bfloat16 else v.numpy())
            else:
                v = np.asarray(v)
                v = v.view(np.uint16) if v.dtype.name == "bfloat16" else v
            out[prefix + f.name] = v
    return out


def _assert_same(port, want):
    got = _flat(port)
    want = {k: v for k, v in _flat(want).items()
            if k in got or np.any(v)}           # JAX's zero biases
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _torch_reference(path, family, cfg, dtype):
    """The JAX loader's result for a BF16 checkpoint, from the tensors of
    `safetensors`' torch API: the same transposes and stacks, in numpy
    with ml_dtypes' bfloat16 rounding as the JAX loader's astype does."""
    from safetensors import safe_open
    t = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".safetensors"):
            with safe_open(os.path.join(path, f), framework="pt") as h:
                t.update({k: h.get_tensor(k).float().numpy()
                          for k in h.keys()})

    class Np(dict):
        def __missing__(self, k):
            return t[k]

        def keys(self):
            return t.keys()

    orig = jloader._open_safetensors
    jloader._open_safetensors = lambda _: Np()
    try:
        if family == "mixtral":
            return jload_mixtral(path, cfg, dtype=dtype)
        return jloader.load_llama_params(path, cfg, dtype=dtype)
    finally:
        jloader._open_safetensors = orig


CASES = [(fam, dt) for fam in ("llama", "qwen2", "mixtral")
         for dt in ("F32", "F16", "BF16")]


@pytest.mark.parametrize("family,src_dtype", CASES)
def test_loader_matches_jax_loader(tmp_path, family, src_dtype):
    write_checkpoint(tmp_path, family, src_dtype)
    path = str(tmp_path)
    if family == "qwen2":
        assert os.path.exists(os.path.join(path,
                                           "model.safetensors.index.json"))
    jcfg = jloader.load_model_config(path)
    cfg = loader.load_model_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.attention_bias == (family == "qwen2")
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        if src_dtype == "BF16":
            want = _torch_reference(path, family, jcfg, jdt)
        elif family == "mixtral":
            want = jload_mixtral(path, jcfg, dtype=jdt)
        else:
            want = jloader.load_llama_params(path, jcfg, dtype=jdt)
        load = load_mixtral_params if family == "mixtral" \
            else loader.load_llama_params
        _assert_same(load(path, cfg, dtype=tdt, device="cpu"), want)


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_loaded_params_give_transformers_logits(tmp_path, family):
    """The loaded params through the port's forward give the logits of the
    model that wrote them (tied LLaMA head; Qwen2 biases, rope 1e6)."""
    hf = write_checkpoint(tmp_path, family, "F32", tied=family == "llama")
    cfg = loader.load_model_config(str(tmp_path))
    assert cfg.tie_word_embeddings == (family == "llama")
    params = loader.load_llama_params(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    if family == "llama":
        assert torch.equal(params.lm_head, params.embed.T)
    tokens = list(np.random.default_rng(0).integers(0, 96, 11))
    with torch.no_grad():
        ref = hf(torch.tensor([tokens])).logits[0].numpy()
    s = 64
    cache = tm.init_kv_cache(cfg.num_hidden_layers, 1,
                             cfg.num_key_value_heads, s, cfg.head_dim_,
                             torch.float32, "cpu")
    hidden = tm.embed_tokens(params, torch.tensor([tokens]))
    out, _ = tm.model_forward(params, cache, hidden, torch.arange(11),
                              tm.prefill_bias(0, 11, s, device="cpu"), 0, cfg)
    got = tm.lm_head_logits(params, tm.final_hidden(params, out, cfg))[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_reader_matches_safetensors(tmp_path):
    """Every dtype, a 0-d tensor and odd lengths (offsets that are not a
    multiple of the next tensor's element size), single file and sharded
    with an index."""
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((3, 5), generator=g),
        "f16": torch.randn((7,), generator=g).half(),
        "bf16": torch.randn((2, 3, 4), generator=g).bfloat16(),
        "f64": torch.randn((3,), generator=g).double(),
        "i8": torch.randint(-128, 128, (5,), generator=g).to(torch.int8),
        "u8": torch.randint(0, 256, (3, 3), generator=g).to(torch.uint8),
        "i32": torch.randint(-9, 9, (4,), generator=g).to(torch.int32),
        "i64": torch.randint(-9, 9, (2,), generator=g),
        "i16": torch.randint(-9, 9, (3,), generator=g).to(torch.int16),
        "b": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
    }
    safetensors_torch.save_file(tensors, str(tmp_path / "one.safetensors"))
    names = sorted(tensors)
    shards = {"a.safetensors": names[::2], "b.safetensors": names[1::2]}
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    for f, ns in shards.items():
        safetensors_torch.save_file({n: tensors[n] for n in ns},
                                    str(sharded / f))
    with open(sharded / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {n: fn for fn, ns in shards.items()
                                  for n in ns}}, f)
    one = loader.SafetensorsFile(str(tmp_path / "one.safetensors"))
    both = loader.Checkpoint(str(sharded))
    want = safetensors_torch.load_file(str(tmp_path / "one.safetensors"))
    assert sorted(one.keys()) == sorted(both.keys()) == names
    for n in names:
        for got in (one[n], both[n]):
            assert got.dtype == want[n].dtype and got.shape == want[n].shape
            assert torch.equal(got, want[n]), n


def _eagle_tensors(h=32, nq=4, nkv=2, inter=64, fc_bias=True):
    rng = np.random.default_rng(4)
    d = h // nq

    def w(o, i):
        return torch.from_numpy(rng.normal(0, 0.2, (o, i)).astype(np.float32))

    t = {"fc.weight": w(h, 2 * h),
         "layers.0.self_attn.q_proj.weight": w(nq * d, h),
         "layers.0.self_attn.k_proj.weight": w(nkv * d, h),
         "layers.0.self_attn.v_proj.weight": w(nkv * d, h),
         "layers.0.self_attn.o_proj.weight": w(h, nq * d),
         "layers.0.mlp.gate_proj.weight": w(inter, h),
         "layers.0.mlp.up_proj.weight": w(inter, h),
         "layers.0.mlp.down_proj.weight": w(h, inter),
         "layers.0.post_attention_layernorm.weight":
             torch.from_numpy(rng.normal(1, 0.1, (h,)).astype(np.float32))}
    if fc_bias:
        t["fc.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, (h,)).astype(np.float32))
    return t


@pytest.mark.parametrize("layout", ["safetensors", "bin"])
@pytest.mark.parametrize("fc_bias", [True, False])
def test_eagle_loader_matches_jax(tmp_path, layout, fc_bias):
    t = _eagle_tensors(fc_bias=fc_bias)
    if layout == "safetensors":
        safetensors_torch.save_file(t, str(tmp_path / "model.safetensors"))
    else:
        torch.save(t, str(tmp_path / "pytorch_model.bin"))
    embed = np.random.default_rng(5).normal(0, 1, (96, 32)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jload_eagle(str(tmp_path), jnp.asarray(embed, jdt), dtype=jdt)
        got = load_eagle_params(str(tmp_path),
                                torch.from_numpy(embed).to(tdt), dtype=tdt)
        assert got.w_out is None and want.w_out is None
        _assert_same(got, want)


def test_loaders_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    write_checkpoint(tmp_path, "llama", "F32")
    for load in (loader.load_llama_params, load_mixtral_params):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(str(tmp_path))
