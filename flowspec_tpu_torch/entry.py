"""Entry points: one speculative round of the flagship model, and the
multi-device dry run.

Port of `__graft_entry__.py`: `entry()` (`:27`) gives (fn, args) for one
`_spec_round` of the flagship LLaMA-family configuration, and
`dryrun_multichip(n)` (`:52`) drives every multi-device path of the port
against the AR stream of one unsharded engine: the six pipeline schedules
over n stages, the TP engine and the galaxy TP engine at min(n, KV heads)
ranks, and for n >= 4 a (n/2, 2) stage x tp mesh on an uneven layer split.
Every path runs in-process (`parallel/mesh.py`), on the card unless the
caller passes `device="cpu"`.

The model is JAX's tiny one (`:74-87`): vocab 512, 8 query heads on 4 KV
heads, 2n layers, f32, on the CPU, where every stream must equal the AR
stream token for token. The card's attention kernel takes bf16 and a head
dim of 64 or 128, so there the same model is bf16 at hidden 512 (head dim
64, intermediate 1024), and a stream that leaves the AR stream passes only
where the AR model's top-2 logit gap at the divergence is under 0.05 (a
near-tie that bf16 rounding may decide either way); the rest of such a
stream is not compared.

Two gates drive the pipeline's prune, merge and expand paths at real
multi-token commits, not only at the random drafts' acceptance of about 1
(`:143-184`, `:186-231`), over `stages8` stages (n when n is 2, 4 or 8;
8 when n > 8), when their fixtures exist:
- the trained tiny draft (`tests/fixtures/tiny_draft_trained_l8.npz`) on
  its 8-layer tiny base, JAX's `init_llama_params(key(0))` draw written
  to `tests/fixtures/tiny_l8_base.npz` in `save_base`'s leaf layout:
  continuous and pruned must give the AR stream at accept/round > 1.5.
  Its head dim is 16 and the card's attention kernel takes 64 or 128, so
  it runs where the device is the CPU; on the card the report says it was
  not run and why;
- the struct tiny8 pair (`tests/fixtures/struct_tiny8_*.npz`, loaded by
  `eval/struct_base.py`) on the d8/tau0.2/n48 tree in chunks of 8:
  continuous and pruned must give the AR stream at accept/round > 2.5, in
  f32 on the CPU, in bf16 under the near-tie rule on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from flowspec_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingConfig, StageTopology, TreeConfig,
)
from flowspec_tpu_torch.draft.eagle import init_eagle_params
from flowspec_tpu_torch.models.llama import LlamaLayerParams, LlamaParams
from flowspec_tpu_torch.runtime.engine import (
    SpecEngine, _spec_round, resolve_device,
)

NEAR_TIE_GAP = 0.05
FIXTURES = Path(__file__).resolve().parent.parent / "tests" / "fixtures"
TINY_L8_BASE = FIXTURES / "tiny_l8_base.npz"
TINY_L8_DRAFT = FIXTURES / "tiny_draft_trained_l8.npz"
STRUCT_BASE = FIXTURES / "struct_tiny8_base.npz"
STRUCT_DRAFT = FIXTURES / "struct_tiny8_draft.npz"


def random_llama(mc: ModelConfig, generator: torch.Generator,
                 device) -> LlamaParams:
    """Unquantized random params in mc.dtype with `init_llama_params`'s
    law (`flowspec_tpu/models/llama.py:317-353`): N(0, 1) x In^-1/2, the
    embedding N(0, 0.02), unit norms; drawn in place on `device`."""
    dt = getattr(torch, mc.dtype)
    h, i, v, n = (mc.hidden_size, mc.intermediate_size, mc.vocab_size,
                  mc.num_hidden_layers)
    d, nq, nkv = mc.head_dim_, mc.num_attention_heads, mc.num_key_value_heads

    def init(shape, std=None):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, shape[-2] ** -0.5 if std is None else std,
            generator=generator)

    layers = LlamaLayerParams(
        wq=init((n, h, nq * d)), wk=init((n, h, nkv * d)),
        wv=init((n, h, nkv * d)), wo=init((n, nq * d, h)),
        w_gate=init((n, h, i)), w_up=init((n, h, i)),
        w_down=init((n, i, h)),
        input_ln=torch.ones((n, h), dtype=dt, device=device),
        post_ln=torch.ones((n, h), dtype=dt, device=device))
    return LlamaParams(embed=init((v, h), 0.02), layers=layers,
                       final_norm=torch.ones((h,), dtype=dt, device=device),
                       lm_head=init((h, v)))


def _engine(vocab=32000, hidden=2048, layers=16, heads=16,
            dtype="bfloat16", device=None) -> SpecEngine:
    dev = resolve_device(device)
    mc = ModelConfig(vocab_size=vocab, hidden_size=hidden,
                     intermediate_size=hidden * 11008 // 4096,
                     num_hidden_layers=layers, num_attention_heads=heads,
                     num_key_value_heads=heads, dtype=dtype)
    cfg = EngineConfig(model=mc, tree=TreeConfig(),
                       sampling=SamplingConfig(), max_seq_len=1024)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = random_llama(mc, gen, dev)
    draft = init_eagle_params(gen, mc, embed=params.embed)
    return SpecEngine(params, draft, cfg, device=dev)


def entry(device=None, **shape):
    """(fn, args): one speculative decode round (draft beam, tree build,
    tree-masked verify, acceptance, KV compaction) of the flagship
    LLaMA-family model (`_engine`'s defaults; `shape` overrides them, as
    a test does), fn(*args) -> (state, accepted, n_accepted). The state
    seeds a one-pair draft context instead of a prefill, as JAX's does:
    the round is the same."""
    eng = _engine(device=device, **shape)
    state = eng.init_state()
    dev = eng.device
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    state = dataclasses.replace(
        state, commit_len=one.clone(), n_pending=one.clone(),
        pending_tokens=state.pending_tokens.index_fill(1, torch.zeros(
            (1,), dtype=torch.long, device=dev), 7),
        root_token=one * 7)
    fn = functools.partial(_spec_round, cfg=eng.cfg.model,
                           tree_cfg=eng.cfg.tree, sampling=eng.cfg.sampling)
    return fn, (state, eng.params, eng.draft, eng.beam_head)


def dryrun_model(p: int, device) -> tuple:
    """(ModelConfig, TreeConfig) of the dry run over p devices (module
    docstring)."""
    cpu = device.type == "cpu"
    mc = ModelConfig(vocab_size=512, hidden_size=128 if cpu else 512,
                     intermediate_size=256 if cpu else 1024,
                     num_hidden_layers=2 * p, num_attention_heads=8,
                     num_key_value_heads=4, max_position_embeddings=512,
                     dtype="float32" if cpu else "bfloat16")
    tc = TreeConfig(top_k=6, depth=3, total_tokens=18, expand_tokens=12,
                    expand_depth=2, node_cap=48, leaf_cap=48, depth_cap=12,
                    chunk_len=4, chunk_cap=12)
    return mc, tc


def _check(name, out, ar, ref: SpecEngine, prompt, exact: bool) -> dict:
    """`out` against the AR stream `ar` (both with the prompt): equal, or
    (not `exact`) leaving it at a near-tie of the AR model."""
    n = len(prompt)
    j = next((i for i, (a, b) in enumerate(zip(out[n:], ar[n:])) if a != b),
             None)
    if j is None and len(out) == len(ar):
        return {"ok": True, "equal": True}
    gap = None
    if j is not None and not exact:
        _, logits = ref._prefill_chunks(ref.init_state(), ar[:n + j])
        top = torch.topk(logits.float(), 2).values
        gap = float(top[0] - top[1])
    ok = gap is not None and gap < NEAR_TIE_GAP
    if not ok:
        raise AssertionError(f"dryrun {name}: stream {out} != AR {ar} "
                             f"(first divergence {j}, AR top-2 gap {gap})")
    return {"ok": True, "equal": False, "divergence": j, "ar_top2_gap": gap}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Validate every multi-device path over `n_devices` ranks or stages,
    in-process (module docstring). Returns each path's check and stats;
    raises on a failed one."""
    from flowspec_tpu_torch.parallel import (
        PipelineEngine, TPEngine, stage_mesh, stage_tp_mesh, tp_mesh,
    )
    dev = resolve_device(device)
    exact = dev.type == "cpu"
    p = n_devices
    mc, tc = dryrun_model(p, dev)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=256, prefill_chunk=8,
                       topology=StageTopology.even(2 * p, p))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = random_llama(mc, gen, dev)
    draft = init_eagle_params(gen, mc, embed=params.embed)
    prompt = np.arange(10, 30).tolist()
    new = 6

    # the reference: the unsharded engine's AR stream
    ref = SpecEngine(params, draft, cfg, device=dev)
    ar, _ = ref.generate_ar(prompt, max_new_tokens=new, eos_token_id=-1)
    report = {"device": str(dev), "n": p, "dtype": mc.dtype}

    def run(name, eng, **kw):
        out, stats = eng.generate(prompt, max_new_tokens=new,
                                  eos_token_id=-1, **kw)
        if stats["new_tokens"] != new:
            raise AssertionError(f"dryrun {name}: {stats}")
        report[name] = {**_check(name, out, ar, ref, prompt, exact),
                        **{k: stats[k] for k in ("new_tokens", "rounds",
                                                 "turns") if k in stats}}
        print(f"dryrun {name}: ok {stats}", flush=True)

    for schedule in ("continuous", "pruned", "naive", "serial", "ar",
                     "pipedec"):
        run(schedule, PipelineEngine(params, draft, cfg, device=dev,
                                     mesh=stage_mesh(p), schedule=schedule))

    tp_n = min(p, mc.num_key_value_heads)
    run(f"tp{tp_n}", TPEngine(params, draft, cfg, mesh=tp_mesh(tp_n),
                              device=dev))
    gal = TPEngine(params, draft, cfg, mesh=tp_mesh(tp_n), galaxy=True,
                   device=dev)
    run(f"galaxy_tp{tp_n}", gal)
    report[f"galaxy_tp{tp_n}"].update(engaged=gal.forward_fn.engaged,
                                      fallbacks=gal.forward_fn.fallbacks)
    if not gal.forward_fn.engaged:
        raise AssertionError("dryrun galaxy: the galaxy forward never ran")

    if p >= 4:
        # an uneven split: stage 0 one layer short, the last one long
        split = list(StageTopology.even(2 * p, p // 2).layers_per_stage)
        split[0] -= 1
        split[-1] += 1
        cfg2 = dataclasses.replace(cfg, topology=StageTopology(
            num_stages=p // 2, layers_per_stage=tuple(split)))
        name = f"stage{p // 2}_tp2"
        run(name, PipelineEngine(params, draft, cfg2, device=dev,
                                 mesh=stage_tp_mesh(p // 2, 2),
                                 schedule="continuous"))
        report[name]["split"] = split

    stages8 = p if p in (2, 4, 8) else (8 if p > 8 else 0)
    if stages8:
        report.update(trained_gates(stages8, dev))
    print(f"dryrun_multichip ok: {p} ranks on {dev}", flush=True)
    return report


def tiny_l8_gate(stages: int, device):
    """(engine config, base, draft, prompt, new tokens) of the trained
    tiny draft's gate (`__graft_entry__.py:143-184`), f32."""
    from flowspec_tpu_torch.eval.struct_base import load_base, load_draft
    mc = dataclasses.replace(ModelConfig.tiny(vocab_size=64, n_layers=8),
                             dtype="float32")
    base = load_base(str(TINY_L8_BASE), mc, device)
    draft = load_draft(str(TINY_L8_DRAFT), base.embed, torch.float32)
    tc = TreeConfig(top_k=6, depth=5, total_tokens=24, expand_tokens=12,
                    expand_depth=2, node_cap=48, leaf_cap=48, depth_cap=10,
                    chunk_len=8, chunk_cap=12)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=256, prefill_chunk=8,
                       topology=StageTopology.even(8, stages))
    return cfg, base, draft, (np.arange(10, 30) % 64).tolist(), 24


def struct_gate(stages: int, device):
    """(engine config, base, draft, prompt, new tokens) of the struct tiny8
    gate (`__graft_entry__.py:186-231`): f32 on the CPU, bf16 on the
    card."""
    from flowspec_tpu_torch.eval.struct_base import (
        SCALES, load_base, load_draft, model_config,
    )
    from flowspec_tpu_torch.eval.synth import gen_struct_corpus
    s8 = SCALES["tiny8"]
    mc = dataclasses.replace(model_config(s8), dtype=(
        "float32" if device.type == "cpu" else "bfloat16"))
    base = load_base(str(STRUCT_BASE), mc, device)
    draft = load_draft(str(STRUCT_DRAFT), base.embed, getattr(torch,
                                                              mc.dtype))
    tc = TreeConfig(top_k=8, depth=8, total_tokens=48, expand_tokens=24,
                    expand_depth=2, node_cap=64, leaf_cap=64, depth_cap=12,
                    chunk_len=8, chunk_cap=12, score_temperature=0.2)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=256, prefill_chunk=8,
                       topology=StageTopology.even(s8["layers"], stages))
    prompt = gen_struct_corpus(1, 32, vocab=s8["vocab"], seed=2,
                               n_classes=s8["n_classes"],
                               copy_dist=s8["copy_dist"])[0, :24]
    return cfg, base, draft, prompt.tolist(), 32


def trained_gates(stages: int, device) -> dict:
    """The dry run's two trained-fixture gates over `stages` in-process
    stages (module docstring): continuous and pruned against the AR stream
    of the unsharded engine, with their accept/round above the bar. A gate
    whose fixtures are missing is left out, as in the JAX package."""
    from flowspec_tpu_torch.parallel import PipelineEngine, stage_mesh
    exact = device.type == "cpu"
    out = {}
    gates = (("trained", tiny_l8_gate, 1.5, (TINY_L8_BASE, TINY_L8_DRAFT)),
             ("struct_d8", struct_gate, 2.5, (STRUCT_BASE, STRUCT_DRAFT)))
    for tag, make, bar, files in gates:
        if not all(f.exists() for f in files):
            continue
        if tag == "trained" and not exact:
            out["trained"] = {"ok": None, "run": False, "why": (
                "head dim 16: the card's attention kernel takes 64 or 128; "
                "the gate runs where the device is the CPU")}
            continue
        cfg, base, draft, prompt, new = make(stages, device)
        ref = SpecEngine(base, draft, cfg, device=device)
        ar, _ = ref.generate_ar(prompt, max_new_tokens=new, eos_token_id=-1)
        for schedule in ("continuous", "pruned"):
            name = f"{schedule}_{tag}"
            eng = PipelineEngine(base, draft, cfg, device=device,
                                 mesh=stage_mesh(stages), schedule=schedule)
            got, stats = eng.generate(prompt, max_new_tokens=new,
                                      eos_token_id=-1)
            apr = stats["accept_per_round"]
            out[name] = {**_check(name, got, ar, ref, prompt, exact),
                         "accept_per_round": apr, "stages": stages,
                         "dtype": cfg.model.dtype,
                         **{k: stats[k] for k in ("new_tokens", "rounds",
                                                  "turns") if k in stats}}
            if stats["new_tokens"] != new or not apr > bar:
                raise AssertionError(f"dryrun {name}: accept_per_round "
                                     f"{apr} (bar {bar}), {stats}")
            print(f"dryrun {name} ({stages} stages): lossless, "
                  f"accept_per_round={apr:.2f}", flush=True)
    return out
