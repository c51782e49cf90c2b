"""The port's training (`flowspec_tpu_torch/train/`) against the JAX
trainers on the CPU.

Inputs come from numpy seeds; JAX's parameters reach the port through the
bridge, so both sides start from the same numbers. Tolerances:
- the optimizer, against `optax.adamw(cosine_decay_schedule)` over 50
  updates of fixed gradients: f32 parameters within 1e-6 relative
  (Frobenius, each field);
- the teacher's hiddens against `model_forward` + `final_hidden`: 1e-5;
- the distillation losses (bench and struct: hard CE, thin W 32 draft;
  tiny: soft CE, full width) in f32: values within 1e-5, every field's
  gradient within 1e-4 relative Frobenius error;
- the base's LM loss (bf16 compute, f32 masters): CE within 1e-2, every
  gradient within 3e-2 relative Frobenius error (bf16 roundings differ);
- five training steps on the same batches: trainables within 1e-4
  relative, and the same delta-shrink alpha.
The files each package writes load in the other bit for bit. A cut tiny
run of the struct protocol (60 base steps of 800, 3 distillation pools of
25, 2 eval prompts of 32 tokens of 48) must show a falling base CE, an f32
engine lossless on every prompt and greedy accept/round > 1; its base,
started from JAX's draw on the JAX tool's batches, follows the tool's
`train_base` over the same steps (CE and held-out CE / top-1 within 1e-2,
each leaf's move within 2 % in norm and 85 % in sign). One training step of
the tiny draft and of a tiny base gives every trainable field a finite
nonzero gradient, the attention's projections included.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flowspec_tpu.config import ModelConfig as JModelConfig
from flowspec_tpu.draft import eagle as jeagle
from flowspec_tpu.models import model_forward as jmodel_forward
from flowspec_tpu.models.bias import prefill_bias as jprefill_bias
from flowspec_tpu.models.kv_cache import init_kv_cache as jinit_kv_cache
from flowspec_tpu.models.llama import embed_tokens as jembed_tokens
from flowspec_tpu.models.llama import final_hidden as jfinal_hidden
from flowspec_tpu.models.llama import init_llama_params as jinit_llama
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.draft.eagle import (
    draft_view, init_eagle_params, load_thin_draft,
)
from flowspec_tpu_torch.eval import struct_base as tstruct
from flowspec_tpu_torch.train import bench_draft, teacher, tiny_draft
from flowspec_tpu_torch.train import struct_base as train_struct
from flowspec_tpu_torch.models.llama import init_llama_params
from flowspec_tpu_torch.ops import _build
from flowspec_tpu_torch.train.distill import (
    DRAFT_FIELDS, DraftTrainer, trainable_of,
)
from flowspec_tpu_torch.train.losses import lm_loss
from flowspec_tpu_torch.train.optim import AdamW
from tests.torch_bridge_util import port_eagle, port_llama
from tests.torch_engine_util import one_torch_thread  # noqa: F401
from tools import train_struct_base as jstruct
from tools.train_tiny_draft import draft_forward as jtiny_draft_forward


FIXTURES = Path(__file__).resolve().parent / "fixtures"


def rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def port_cfg(mc):
    return tcfg.ModelConfig(**dataclasses.asdict(mc))


# ---- the optimizer ----------------------------------------------------------

@pytest.mark.parametrize("lr,decay,alpha,b2,wd,step0", [
    (3e-3, 40, 0.05, 0.999, 1e-4, 0),      # train_tiny_draft.py:202-203
    (1e-3, 50, 0.02, 0.999, 1e-4, 0),      # train_bench_draft.py:228-229
    (3e-3, 60, 0.05, 0.95, 0.01, 0),       # train_struct_base.py:223-225
    (3e-3, 60, 0.05, 0.95, 0.01, 17),      # its resume offset
])
def test_adamw_matches_optax(lr, decay, alpha, b2, wd, step0):
    rng = np.random.default_rng(step0 + decay)
    p0 = {"w": rng.standard_normal((48, 40)).astype(np.float32),
          "b": rng.standard_normal((96,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(50)]
    sched = optax.cosine_decay_schedule(lr, decay, alpha)
    opt = optax.adamw(lambda c: sched(c + step0), b1=0.9, b2=b2,
                      weight_decay=wd)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(pj)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, pj)
        pj = optax.apply_updates(pj, upd)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    ours = AdamW(pt.values(), lr, decay, alpha, b2=b2, weight_decay=wd,
                 step0=step0)
    for g in grads:
        for k, t in pt.items():
            t.grad = torch.from_numpy(g[k])
        ours.step()
    for k in pt:
        assert rel(pt[k], pj[k]) <= 1e-6, k


# ---- the teacher ------------------------------------------------------------

@pytest.mark.parametrize("lanes", [1, 3])
def test_teacher_hiddens_match_jax(lanes):
    jc = dataclasses.replace(JModelConfig.tiny(vocab_size=64, n_layers=2),
                             dtype="float32")
    base = jinit_llama(jax.random.key(0), jc, dtype=jnp.float32)
    tokens = np.random.default_rng(1).integers(0, 64, (4, 24)).astype(
        np.int32)
    t = tokens.shape[1]

    def one(seq):
        cache = jinit_kv_cache(jc.num_hidden_layers, 1,
                               jc.num_key_value_heads, t, jc.head_dim_,
                               jnp.float32)
        bias = jprefill_bias(jnp.zeros((), jnp.int32), t, t)
        out, _ = jmodel_forward(base, cache, jembed_tokens(base, seq[None]),
                                jnp.arange(t, dtype=jnp.int32), bias,
                                jnp.zeros((), jnp.int32), jc)
        return jfinal_hidden(base, out, jc)[0]

    want = np.stack([np.asarray(one(jnp.asarray(s))) for s in tokens])
    got = teacher.teacher_hiddens(port_llama(base), tokens, port_cfg(jc),
                                  lanes=lanes)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_corpus_file_round_trips_and_refuses_another_base(tmp_path):
    tokens = np.arange(12, dtype=np.int32).reshape(3, 4)
    hiddens = torch.randn((3, 4, 8)).to(torch.bfloat16)
    path = teacher.corpus_path(tmp_path, "7b_int8_seed0", 0, 3, 4)
    assert path.name.startswith("flowspec_torch_corpus_7b_int8_seed0")
    teacher.save_corpus(path, tokens, hiddens, "7b_int8_seed0")
    tok, hid = teacher.load_corpus(path, "7b_int8_seed0", "cpu")
    assert np.array_equal(tok, tokens) and torch.equal(hid, hiddens)
    with pytest.raises(ValueError, match="13b_mixed_seed0"):
        teacher.load_corpus(path, "13b_mixed_seed0", "cpu")


# ---- the distillation losses ------------------------------------------------

def _pairs_setup(kind):
    """JAX's f32 tiny base and initial draft, a batch of tokens and teacher
    hiddens: "bench" / "struct" a thin W 32 draft (the tools'
    `init_eagle_params(key(9), width=...)`; (6, 16) and (4, 20) pairs),
    "tiny" its full-width draft. In f32 the head product rounds nothing,
    so both packages' losses are f32 sums throughout."""
    jc = dataclasses.replace(JModelConfig.tiny(vocab_size=64, n_layers=2),
                             dtype="float32")
    base = jinit_llama(jax.random.key(0), jc)
    draft0 = jeagle.init_eagle_params(
        jax.random.key(9), jc, embed=base.embed, dtype=jnp.float32,
        width=None if kind == "tiny" else 32)
    rng = np.random.default_rng({"bench": 0, "struct": 1, "tiny": 2}[kind])
    b, t = (4, 20) if kind == "struct" else (6, 16)
    tok = rng.integers(0, 64, (b, t)).astype(np.int32)
    hid = rng.standard_normal((b, t, 64)).astype(np.float32)
    hid_j = jnp.asarray(hid, jnp.dtype(jc.dtype))
    return jc, base, draft0, tok, hid_j


def _jax_loss(kind, jc, base, draft0):
    """The tools' loss closures, rebuilt: `tools/train_bench_draft.py:
    184-225` and `train_struct_base.py:349-380` (hard CE, weights 0.5 /
    1), `train_tiny_draft.py:136, 184-197` (soft CE, weights 1 / 0.3)."""
    dcfg = jeagle.draft_view(draft0, jc)
    head = base.lm_head
    dt = jnp.dtype(jc.dtype)

    def pairs(trainable, tok_b, hid_b):
        p = jeagle.EagleParams(embed=base.embed, **trainable)
        t_pairs = tok_b.shape[1] - 1
        h_in = hid_b[:, :-1].astype(jnp.float32)
        x = jeagle.fuse(p, tok_b[:, 1:], h_in)
        pos = jnp.arange(t_pairs, dtype=jnp.int32)
        bias = jnp.where(pos[None, :] <= pos[:, None], 0.0,
                         -1e9).astype(jnp.float32)

        def one(x1, h1):
            k = jnp.zeros((1, dcfg.num_key_value_heads, t_pairs,
                           dcfg.head_dim_), jnp.float32)
            out, _, _ = jeagle.eagle_layer(x1[None], p, k, jnp.zeros_like(k),
                                           pos, bias,
                                           jnp.zeros((), jnp.int32), dcfg)
            return jeagle.project_out(p, out, h1[None])[0]

        return jax.vmap(one)(x, h_in)

    def hard(trainable, tok_b, hid_b):
        out = pairs(trainable, tok_b, hid_b)
        d = out - hid_b[:, 1:].astype(jnp.float32)
        ad = jnp.abs(d)
        hub = jnp.where(ad < 1.0, 0.5 * d * d, ad - 0.5).mean()
        ld = jnp.einsum("bth,hv->btv", out.astype(dt), head,
                        preferred_element_type=jnp.float32)
        lt = jnp.einsum("bth,hv->btv", hid_b[:, 1:], head,
                        preferred_element_type=jnp.float32)
        lab = jnp.argmax(lt, axis=-1)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(ld, axis=-1),
                                  lab[..., None], axis=-1).mean()
        agree = (jnp.argmax(ld, axis=-1) == lab).mean()
        return 0.5 * hub + ce, (hub, ce, agree)

    def soft(trainable, tok_b, hid_b):
        draft = jeagle.EagleParams(embed=base.embed, **trainable)
        out = jtiny_draft_forward(draft, tok_b, hid_b, jc)
        tgt = hid_b[:, 1:]
        d = out - tgt
        ad = jnp.abs(d)
        hub = jnp.where(ad < 1.0, 0.5 * d * d, ad - 0.5).mean()
        ld = (out @ head).astype(jnp.float32)
        lt = (tgt @ head).astype(jnp.float32)
        ce = -(jax.nn.softmax(lt, axis=-1)
               * jax.nn.log_softmax(ld, axis=-1)).sum(-1).mean()
        agree = (jnp.argmax(ld, axis=-1) == jnp.argmax(lt, axis=-1)).mean()
        return 1.0 * hub + 0.3 * ce, (hub, ce, agree)

    return soft if kind == "tiny" else hard


def _port_trainer(kind, jc, base, draft0, lr=1e-3, steps=5):
    pbase = port_llama(base)
    pdraft = port_eagle(draft0)
    weights = (1.0, 0.3) if kind == "tiny" else (0.5, 1.0)
    return DraftTrainer(trainable_of(pdraft), pbase.embed,
                        pbase.lm_head.float(), draft_view(pdraft,
                                                          port_cfg(jc)),
                        lr=lr, decay_steps=steps, alpha=0.02,
                        hidden_w=weights[0], ce_w=weights[1],
                        soft=kind == "tiny")


def _torch_hid(hid_j):
    h = np.array(hid_j.astype(jnp.float32))
    return torch.from_numpy(h).to(getattr(torch, str(hid_j.dtype)))


@pytest.mark.parametrize("kind", ["bench", "struct", "tiny"])
def test_distill_loss_and_gradients_match_jax(kind):
    jc, base, draft0, tok, hid_j = _pairs_setup(kind)
    fields = [f for f in DRAFT_FIELDS if getattr(draft0, f) is not None]
    trainable = {f: getattr(draft0, f) for f in fields}
    (l, aux), g = jax.jit(jax.value_and_grad(
        _jax_loss(kind, jc, base, draft0), has_aux=True))(
        trainable, jnp.asarray(tok), hid_j)
    tr = _port_trainer(kind, jc, base, draft0)
    loss, got = tr.loss(torch.from_numpy(tok), _torch_hid(hid_j))
    loss.backward()
    for a, b in zip((loss, *got), (l, *aux)):
        assert abs(float(a.detach()) - float(b)) <= 1e-5, (kind, a, b)
    for f in fields:
        assert rel(tr.trainable[f].grad, g[f]) <= 1e-4, (kind, f)


def test_lm_loss_and_gradients_match_jax():
    s = dict(vocab=128, hidden=64, inter=128, layers=2, heads=4, kv=2)
    jc = jstruct.model_config(s)
    params = jinit_llama(jax.random.key(3), jc, dtype=jnp.float32)
    tok = np.random.default_rng(0).integers(0, 128, (4, 24)).astype(np.int32)
    (ce, acc), g = jax.jit(jax.value_and_grad(
        jstruct.make_lm_loss(jc, 24), has_aux=True))(params, jnp.asarray(tok))
    masters = train_struct.f32_masters(port_llama(params))
    tce, tacc = lm_loss(masters, torch.from_numpy(tok), port_cfg(jc))
    tce.backward()
    assert abs(float(tce.detach()) - float(ce)) <= 1e-2
    assert abs(float(tacc) - float(acc)) <= 1e-2
    for name in ("embed", "final_norm", "lm_head"):
        assert rel(getattr(masters, name).grad, getattr(g, name)) <= 3e-2, \
            name
    for f in dataclasses.fields(masters.layers):
        assert rel(getattr(masters.layers, f.name).grad,
                   getattr(g.layers, f.name)) <= 3e-2, f.name


@pytest.mark.parametrize("kind", ["draft", "base"])
def test_one_step_gives_every_field_a_gradient(kind):
    """The whole differentiable path reaches every trainable field,
    attention projections included (a kernel in the graph would cut them
    off: autograd cannot see into its output)."""
    if kind == "draft":
        jc, base, draft0, tok, hid_j = _pairs_setup("tiny")
        tr = _port_trainer("tiny", jc, base, draft0)
        tr.step(torch.from_numpy(tok), _torch_hid(hid_j))
        norms = tr.first_grad_norms
    else:
        s = {**tstruct.SCALES["tiny"], "layers": 2}
        mc = tstruct.model_config(s)
        corpus = np.random.default_rng(0).integers(0, 512, (8, 32))
        _, masters, _ = train_struct.train_base(mc, corpus, s, 1, "cpu",
                                                log=lambda m: None)
        norms = {n: float(t.grad.norm()) for n, t in (
            [(f, getattr(masters.layers, f)) for f in
             train_struct.LAYER_FIELDS]
            + [(n, getattr(masters, n))
               for n in ("embed", "final_norm", "lm_head")])}
    for f in ("wq", "wk", "wv", "wo"):
        assert f in norms
    for f, n in norms.items():
        assert n is not None and np.isfinite(n) and n > 0, (kind, f, n)


def test_refuse_grad_raises_only_under_grad_mode():
    """The kernels' guard (`ops/_build.py refuse_grad`, which every wrapper
    calls before a launch on the card): an operand that requires a
    gradient raises under grad mode, naming the kernel; under
    `torch.no_grad()`, or with no such operand, it passes."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="int8_matmul: .* no backward"):
        _build.refuse_grad("int8_matmul", torch.ones(2), x)
    with torch.no_grad():
        _build.refuse_grad("int8_matmul", x)
    _build.refuse_grad("int8_matmul", x.detach(), None)


# ---- five steps and the delta shrink ----------------------------------------

def test_five_steps_and_alpha_match_jax():
    jc, base, draft0, tok, hid_j = _pairs_setup("bench")
    fields = [f for f in DRAFT_FIELDS if getattr(draft0, f) is not None]
    loss_fn = _jax_loss("bench", jc, base, draft0)
    idx = np.random.default_rng(5).integers(0, 4, (5, 3))
    trainable = {f: getattr(draft0, f) for f in fields}
    opt = optax.adamw(optax.cosine_decay_schedule(1e-3, 5, 0.02),
                      weight_decay=1e-4)
    state = opt.init(trainable)

    @jax.jit
    def step(tr, st, tok_b, hid_b):
        _, g = jax.value_and_grad(loss_fn, has_aux=True)(tr, tok_b, hid_b)
        upd, st = opt.update(g, st, tr)
        return optax.apply_updates(tr, upd), st

    tok_j = jnp.asarray(tok)
    for i in idx:
        trainable, state = step(trainable, state, tok_j[i], hid_j[i])
    ours = _port_trainer("bench", jc, base, draft0)
    hid_t = _torch_hid(hid_j)
    ours.run(torch.from_numpy(tok), hid_t, 5, 3, batches=idx)
    for f in fields:
        assert rel(ours.trainable[f], trainable[f]) <= 1e-4, f

    grid = bench_draft.ALPHAS
    best_a, best_ag = 0.0, -1.0
    for a in grid:
        tr_a = {**trainable, "w_out": trainable["w_out"] * a}
        ag = float(loss_fn(tr_a, tok_j[4:], hid_j[4:])[1][2])
        if ag > best_ag:
            best_a, best_ag = a, ag
    alpha, agree, _ = ours.select_alpha(torch.from_numpy(tok[4:]),
                                        hid_t[4:], grid, log=lambda m: None)
    assert alpha == best_a and abs(agree - best_ag) <= 1e-6


# ---- files both ways --------------------------------------------------------

def test_bench_cli_writes_a_thin_draft_jax_reads(tmp_path):
    out = tmp_path / "draft_tiny_thin_fp16.npz"
    res = bench_draft.run(bench_draft.parse_args(
        ["--scale", "tiny", "--steps", "6", "--rollouts", "4", "--holdout",
         "2", "--gen-tokens", "16", "--eval-prompts", "1", "--log-every",
         "0", "--device", "cpu", "--out", str(out)]), log=lambda m: None)
    stats = res["stats"]
    assert stats["lossless"] and stats["w_out_alpha"] in bench_draft.ALPHAS
    assert (tmp_path / "draft_tiny_thin_fp16.json").exists()
    tr = res["trainer"].trainable
    assert set(np.load(out).files) == set(DRAFT_FIELDS) == set(tr)
    embed = jnp.zeros((64, 64), jnp.bfloat16)
    jd = jeagle.load_thin_draft(str(out), embed, dtype=jnp.float16)
    td = load_thin_draft(str(out), torch.zeros((64, 64)),
                         dtype=torch.float16)
    for f in DRAFT_FIELDS:
        want = tr[f].detach().to(torch.float16).numpy()
        assert np.array_equal(np.asarray(getattr(jd, f)).view(np.uint16),
                              want.view(np.uint16)), f
        assert torch.equal(getattr(td, f), tr[f].detach().half()), f


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 / fp16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_struct_files_load_bit_equal_in_jax(tmp_path):
    s = {**tstruct.SCALES["tiny"], "layers": 2}
    jc, mc = jstruct.model_config(s), tstruct.model_config(s)
    gen = torch.Generator().manual_seed(0)
    params = init_llama_params(gen, mc, device="cpu")
    path = str(tmp_path / "base.npz")
    tstruct.save_base(params, path)
    mine = tstruct.load_base(path, mc, device="cpu")
    with np.load(path) as z:
        for i, name in enumerate(tstruct.BASE_LEAVES):
            assert np.array_equal(_bits(z[f"p{i}"]), _bits(
                tstruct._leaf(params, name).to(torch.float16))), name
    for name, leaf in zip(tstruct.BASE_LEAVES,
                          jax.tree_util.tree_leaves(jstruct.load_base(path,
                                                                      jc))):
        assert np.array_equal(_bits(leaf),
                              _bits(tstruct._leaf(mine, name))), name

    draft = init_eagle_params(gen, mc, embed=params.embed, width=64)
    dpath = str(tmp_path / "draft.npz")
    tstruct.save_draft(draft, dpath)
    jd = jstruct.load_draft(dpath, jnp.zeros((512, 128), jnp.bfloat16),
                            jnp.bfloat16)
    td = tstruct.load_draft(dpath, params.embed, torch.bfloat16)
    with np.load(dpath) as z:
        assert set(z.files) == set(DRAFT_FIELDS)
        for f in DRAFT_FIELDS:
            assert np.array_equal(_bits(z[f]), _bits(
                getattr(draft, f).to(torch.float16))), f
            assert np.array_equal(_bits(getattr(jd, f)),
                                  _bits(getattr(td, f))), f


def test_tiny_fixture_has_the_keys_the_fixture_test_reads(tmp_path):
    out = tmp_path / "tiny_draft_trained.npz"
    res = tiny_draft.run(tiny_draft.parse_args(
        ["--rollouts", "8", "--random", "4", "--steps", "8",
         "--eval-prompts", "1", "--log-every", "0", "--device", "cpu",
         "--out", str(out)]), log=lambda m: None)
    with np.load(out) as z, np.load(FIXTURES / "tiny_draft_trained.npz") \
            as ref:
        assert set(z.files) == set(ref.files)
        for f in ref.files:
            assert z[f].shape == ref[f].shape and z[f].dtype == ref[f].dtype
        assert float(z["accept_per_round"]) == res["accept_per_round"]


# ---- the struct protocol, cut -----------------------------------------------

CUT = {"steps": 60, "distill_outer": 3}      # of 800 steps and 25 pools


@pytest.fixture(scope="module")
def cut_run(tmp_path_factory):
    """The struct protocol cut (CUT, 2 eval prompts of 32 tokens of 48) on
    the CPU, its base started from JAX's key(3) draw (saved by the JAX
    tool's `save_base`, read as f32 masters) and trained on the batches the
    JAX tool draws (`fold_in(key(4242), step)`), so the JAX tool's
    `train_base` can take the same steps."""
    s = tstruct.SCALES["tiny"]
    snap = str(tmp_path_factory.mktemp("cut") / "start.npz")
    jstruct.save_base(jinit_llama(jax.random.key(3), jstruct.model_config(s),
                                  dtype=jnp.float32), snap)
    idx = [np.array(jax.random.randint(
        jax.random.fold_in(jax.random.key(4242), it), (s["batch"],), 0,
        s["n_seqs"])) for it in range(CUT["steps"])]
    out = train_struct.run("tiny", "cpu", CUT, n_eval=2, eval_tokens=32,
                           base_init=snap, base_batches=idx,
                           log=lambda m: None)
    return snap, out


def test_cut_tiny_struct_run_trains_and_stays_lossless(cut_run):
    _, (params, draft, res, extra) = cut_run
    # the served pair carries no autograd graph (on the card a kernel
    # refuses an operand that requires a gradient)
    assert not any(t.requires_grad for t in train_struct.leaves_of(params))
    assert not any(getattr(draft, f).requires_grad for f in DRAFT_FIELDS
                   if getattr(draft, f) is not None)
    ces = [c for c, _ in extra["base"]]
    assert np.mean(ces[-10:]) < np.mean(ces[:10])
    assert res["base_holdout_ce"] < np.log(tstruct.SCALES["tiny"]["vocab"])
    assert res["greedy_lossless"] == "2/2" and res["eval_dtype"] == "float32"
    assert res["accept_per_round_greedy"] > 1.0


def test_base_snapshot_resumes_at_its_step(tmp_path):
    """`train_base` snapshots every `save_every` steps (`save_base`'s
    layout, the step beside it) and a run resumed from the snapshot takes
    the remaining steps only, its schedule offset by the saved step."""
    s = {**tstruct.SCALES["tiny"], "layers": 1}
    mc = tstruct.model_config(s)
    corpus = np.random.default_rng(0).integers(0, 512, (32, 24))
    snap = str(tmp_path / "snap.npz")
    _, masters, hist = train_struct.train_base(
        mc, corpus, s, 3, "cpu", save_every=2, save_path=snap,
        log=lambda m: None)
    assert len(hist) == 3 and int(np.load(snap + ".step.npy")) == 2
    _, resumed, hist = train_struct.train_base(
        mc, corpus, s, 3, "cpu", init_from=snap, log=lambda m: None)
    assert len(hist) == 1
    assert resumed.lm_head.shape == masters.lm_head.shape


def test_base_training_follows_the_jax_tool(cut_run, monkeypatch):
    """The cut run's base steps against the JAX tool's `train_base`
    (`tools/train_struct_base.py:192`) from the same start
    (STRUCT_BASE_INIT) on the same batches: the last step's CE and the
    held-out CE and top-1 within 1e-2; what the steps moved each leaf by,
    its norm within 2 % of JAX's and its sign JAX's on at least 85 % of
    the elements (Adam's steps are near lr x sign(grad), so a wrong
    gradient agrees on about half). At this cut neither package's held-out
    top-1 reaches the unigram rate: the JAX tool's tiny run needs its 800
    steps."""
    snap, (params, _, res, extra) = cut_run
    s = tstruct.SCALES["tiny"]
    jc, mc = jstruct.model_config(s), tstruct.model_config(s)
    corpus = train_struct.gen_struct_corpus(
        s["n_seqs"] + s["holdout"], s["seq_len"], vocab=s["vocab"], seed=0,
        n_classes=s["n_classes"], copy_dist=s["copy_dist"])
    train, hold = corpus[:s["n_seqs"]], corpus[s["n_seqs"]:]
    monkeypatch.setenv("STRUCT_BASE_INIT", snap)
    jlog = []
    jparams, jeval = jstruct.train_base(jc, train, s, CUT["steps"],
                                        log=jlog.append)
    jce_h, jtop1 = (float(v) for v in jeval(jnp.asarray(hold)))
    jce = float(jlog[-1].split(" ce ")[1].split()[0])
    ce, ce_h, top1 = (extra["base"][-1][0], res["base_holdout_ce"],
                      res["base_holdout_top1"])
    unigram = np.bincount(train.ravel()).max() / train.size
    print(f"base after {CUT['steps']} steps: last CE port {ce:.4f} jax "
          f"{jce:.4f}; held-out CE port {ce_h:.4f} jax {jce_h:.4f}, top-1 "
          f"port {top1:.4f} jax {jtop1:.4f}, unigram {unigram:.4f}")
    assert abs(ce - jce) <= 1e-2
    assert abs(ce_h - jce_h) <= 1e-2 and abs(top1 - jtop1) <= 1e-2
    start = tstruct.load_base(snap, mc, device="cpu")
    for name, jl in zip(tstruct.BASE_LEAVES,
                        jax.tree_util.tree_leaves(jparams)):
        t0 = tstruct._leaf(start, name).float()
        ours = (tstruct._leaf(params, name).float() - t0).numpy()
        theirs = np.asarray(jl, np.float32) - t0.numpy()
        ratio = np.linalg.norm(ours) / np.linalg.norm(theirs)
        signs = np.mean(np.sign(ours) == np.sign(theirs))
        print(f"{name}: move norm ratio {ratio:.4f}, signs equal {signs:.4f}")
        assert abs(ratio - 1) <= 2e-2 and signs >= 0.85, (name, ratio, signs)
