"""The port's evaluation path against the JAX package's, on the CPU.

Held exactly (f32, tokens identical, integer statistics equal, timing
fields left out): every chat template, single- and multi-turn, byte-equal
to JAX's; `struct_tables`, `gen_struct_corpus` and
`oracle_next_token_dist` bit-equal; every leaf of the port's struct
loaders equal to JAX's `tools.train_struct_base` loaders, bridged;
`run_eval` over 2 mt_bench questions x 2 turns on the struct_tiny8 f32
pair (byte tokenizer at V 1024), fused and with the longest-common-prefix
resume: every turn's token stream and every summary field but throughput
and latency equal to JAX's `SpecEngine`'s; `run_eval_serve` with
`max_turns=2` and `prefix_cache` on tests/test_batched.py's tiny f32 pair
(4 lanes' worth of questions over 2 lanes, the store at its default cap
and at 2, where it evicts): rows equal to JAX's but throughput, `resumed`
equal, `cold` = questions - resumed on the turn-2 rows; `length_sweep`'s
choice; the `Profiler` under the same calls as JAX's: the same stream
names and summary keys, memory zeros on the CPU, a saved file rendered by
`tools/show_timestamps.py`. The sweep CLI (`--cpu --random tiny`) and the
demo (`--cpu --random tiny`, every engine) run end to end with JAX's row
keys, budgets and printed lines.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import (
    EngineConfig as JEngineConfig, SamplingConfig as JSamplingConfig,
    TreeConfig as JTreeConfig,
)
from flowspec_tpu.eval import harness as jharness
from flowspec_tpu.eval import synth as jsynth
from flowspec_tpu.eval.sweep import byte_tokenizer as jbyte_tokenizer
from flowspec_tpu.runtime.engine import SpecEngine as JSpecEngine
from flowspec_tpu.utils import chat as jchat
from flowspec_tpu.utils.profiler import Profiler as JProfiler
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.eval import harness, struct_base, synth
from flowspec_tpu_torch.eval.sweep import byte_tokenizer
from flowspec_tpu_torch.runtime import SpecEngine
from flowspec_tpu_torch.utils import chat
from flowspec_tpu_torch.utils.profiler import Profiler
from tests.test_torch_batched import TREE as LANE_TREE
from tests.test_torch_batched import setup_pair
from tests.torch_bridge_util import port_eagle, port_llama
from tests.torch_engine_util import FIX, TREE, one_torch_thread  # noqa: F401
from tools import train_struct_base as jsb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MT_BENCH = os.path.join(ROOT, "data", "mt_bench", "question.jsonl")
TIMING = ("throughput_tok_s", "avg_latency_s")
N_NEW = 12


def _ints(x):
    return [int(t) for t in x]


class Recorder:
    """An engine whose decoding calls record their output streams."""

    CALLS = ("generate", "generate_fused", "resume_and_generate", "serve")

    def __init__(self, eng):
        self.eng, self.outs = eng, []

    def __getattr__(self, name):
        fn = getattr(self.eng, name)
        if name not in self.CALLS:
            return fn

        def call(*a, **kw):
            r = fn(*a, **kw)
            self.outs.append([_ints(o) for o in r[0]] if name == "serve"
                             else _ints(r[0]))
            return r
        return call


# ---- chat templates --------------------------------------------------------

TURNS = [[("Hello", None)],
         [("Hi", "Hey there"), ("Bye", None)],
         [("Q1", "A1"), ("Q2", "A2"), ("Q3", None)]]


@pytest.mark.parametrize("template", ["vicuna", "llama2", "llama-2-chat",
                                      "llama3", "llama-3"])
@pytest.mark.parametrize("turns", TURNS, ids=["one", "two", "three"])
@pytest.mark.parametrize("system", [None, "Be brief."])
def test_templates_byte_equal_jax(template, turns, system):
    want = jchat.build_prompt(turns, template=template, system=system)
    assert chat.build_prompt(turns, template=template, system=system) == want
    assert (chat.VICUNA_SYSTEM, chat.LLAMA2_SYSTEM) == (jchat.VICUNA_SYSTEM,
                                                        jchat.LLAMA2_SYSTEM)


def test_unknown_template_raises_as_jax():
    for fn in (jchat.build_prompt, chat.build_prompt):
        with pytest.raises(ValueError):
            fn([("Q", None)], template="chatml")


# ---- synthetic corpus -------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_seqs=3, seq_len=40, vocab=512, seed=1, n_classes=16, copy_dist=8),
    dict(n_seqs=1, seq_len=32, vocab=1024, seed=2, n_classes=8, copy_dist=8),
    dict(n_seqs=2, seq_len=24, vocab=256, seed=5, table_seed=3)])
def test_synth_bit_equal_jax(kw):
    a, b = synth.gen_struct_corpus(**kw), jsynth.gen_struct_corpus(**kw)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    vocab, n_classes = kw["vocab"], kw.get("n_classes", 64)
    ts = kw.get("table_seed", 0)
    for x, y in zip(synth.struct_tables(vocab, n_classes, ts),
                    jsynth.struct_tables(vocab, n_classes, ts)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    okw = dict(n_classes=n_classes, copy_dist=kw.get("copy_dist", 16),
               table_seed=ts)
    for t in (kw.get("copy_dist", 16), kw["seq_len"] - 1):
        assert np.array_equal(
            synth.oracle_next_token_dist(a[0], t, vocab, **okw),
            jsynth.oracle_next_token_dist(b[0], t, vocab, **okw))


# ---- struct loaders ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_struct_loaders_equal_jax_bridged(dtype):
    """Every leaf of the port's load_base / load_draft equals JAX's loaders'
    through the bridge, the trained qkv biases included."""
    s8 = struct_base.SCALES["tiny8"]
    assert s8 == jsb.SCALES["tiny8"]
    assert struct_base.DRAFT_FIELDS == jsb.DRAFT_FIELDS
    jmc = dataclasses.replace(jsb.model_config(jsb.SCALES["tiny8"]),
                              dtype=dtype)
    mc = dataclasses.replace(struct_base.model_config(s8), dtype=dtype)
    assert dataclasses.asdict(mc) == dataclasses.asdict(jmc)
    bpath = os.path.join(FIX, "struct_tiny8_base.npz")
    dpath = os.path.join(FIX, "struct_tiny8_draft.npz")
    jbase = jsb.load_base(bpath, jmc)
    jdraft = jsb.load_draft(dpath, jbase.embed, jnp.dtype(dtype))
    want_b, want_d = port_llama(jbase), port_eagle(jdraft)
    got_b = struct_base.load_base(bpath, mc, device="cpu")
    got_d = struct_base.load_draft(dpath, got_b.embed, getattr(torch, dtype))

    def same(a, b, name):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name

    for f in ("embed", "final_norm", "lm_head"):
        same(getattr(got_b, f), getattr(want_b, f), f)
    for f in dataclasses.fields(got_b.layers):
        same(getattr(got_b.layers, f.name), getattr(want_b.layers, f.name),
             f.name)
    for f in dataclasses.fields(got_d):
        g, w = getattr(got_d, f.name), getattr(want_d, f.name)
        assert (g is None) == (w is None), f.name
        if g is not None:
            same(g, w, f.name)


# ---- run_eval ----------------------------------------------------------------

@pytest.fixture(scope="module")
def struct_engines():
    """The struct_tiny8 pair in f32, a JAX SpecEngine and the port's on the
    bridged weights, sized for mt_bench's second turns."""
    mc = dataclasses.replace(jsb.model_config(jsb.SCALES["tiny8"]),
                             dtype="float32")
    base = jsb.load_base(os.path.join(FIX, "struct_tiny8_base.npz"), mc)
    draft = jsb.load_draft(os.path.join(FIX, "struct_tiny8_draft.npz"),
                           base.embed, jnp.float32)
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**TREE),
                         sampling=JSamplingConfig(), max_seq_len=640)
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(mc)),
        tree=tcfg.TreeConfig(**TREE), sampling=tcfg.SamplingConfig(),
        max_seq_len=640)
    return (JSpecEngine(base, draft, jcfg),
            SpecEngine(port_llama(base), port_eagle(draft), cfg,
                       device="cpu"))


def _eval(mod, eng, qs, resume):
    rec = Recorder(eng)
    tok, detok = byte_tokenizer(1024)
    call = rec.generate if resume else rec.generate_fused
    gen = lambda t: call(t, max_new_tokens=N_NEW, eos_token_id=-1)
    res = mod.run_eval(gen, tok, detok, qs, name="mt_bench", max_turns=2,
                       engine=rec if resume else None, resume=resume,
                       max_new_tokens=N_NEW)
    return res, rec.outs


@pytest.mark.parametrize("resume", [False, True], ids=["fused", "resume"])
def test_run_eval_multiturn_equals_jax(struct_engines, resume):
    jeng, eng = struct_engines
    qs = harness.load_questions(MT_BENCH, limit=2)
    assert qs == jharness.load_questions(MT_BENCH, limit=2)
    tok, jtok = byte_tokenizer(1024)[0], jbyte_tokenizer(1024)[0]
    assert all(tok(q["turns"][0]) == jtok(q["turns"][0]) for q in qs)
    want, want_outs = _eval(jharness, jeng, qs, resume)
    got, got_outs = _eval(harness, eng, qs, resume)
    assert len(got_outs) == 4 and got_outs == want_outs
    ws, gs = want.summary(), got.summary()
    for k in TIMING:
        ws.pop(k), gs.pop(k)
    assert gs == ws
    assert gs["new_tokens"] == 4 * N_NEW and gs["conversation_turns"] == 4
    assert gs["resume_hits"] == (2 if resume else 0)


# ---- run_eval_serve ------------------------------------------------------------

@pytest.fixture(scope="module")
def lane_engines():
    return setup_pair(2, tree=LANE_TREE, max_seq_len=512)


@pytest.mark.parametrize("store_cap", [8, 2])
def test_run_eval_serve_multiturn_equals_jax(lane_engines, store_cap):
    """4 questions x 2 turns over 2 lanes with the chat preamble prefilled
    once: per-turn rows and served streams equal to JAX's; a store of 2
    evicts, and the turn-2 row shows it as `cold`."""
    jeng, eng = (Recorder(e) for e in lane_engines)
    qs = harness.load_questions(MT_BENCH, limit=4)
    tok, detok = byte_tokenizer(16)
    kw = dict(max_new_tokens=8, prefix_cache=True, max_turns=2,
              store_cap=store_cap, detokenize=detok)
    want = jharness.run_eval_serve(jeng, tok, qs, **kw)
    got = harness.run_eval_serve(eng, tok, qs, **kw)
    assert eng.outs == jeng.outs
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        g.pop("throughput_tok_s"), w.pop("throughput_tok_s")
        cold = g.pop("cold", None)
        assert g == w
        assert cold == (None if g["turn"] == 1
                        else g["questions"] - g["resumed"])
        assert g["new_tokens"] == 8 * g["questions"]
    assert (got[1]["resumed"] == 4) == (got[1]["cold"] == 0) == \
        (store_cap == 8)


def test_length_sweep_picks_jax_knee():
    for knee in (4, 16, 32):
        fwd = lambda n: 1.0 if n <= knee else n / knee
        assert harness.length_sweep(fwd) == jharness.length_sweep(fwd)
    lengths = (4, 8, 16, 32, 64)
    fwd = lambda n: 1.0 if n <= 16 else n / 16
    assert harness.length_sweep(fwd, lengths) == 16 == \
        jharness.length_sweep(fwd, lengths)


# ---- profiler ----------------------------------------------------------------

def _drive(p):
    with p.time_context("step"):
        pass
    with p.time_context("step"):
        pass
    p.mark("boundary")
    with p.memory_context("alloc"):
        pass
    with p.profile_context("both"):
        pass
    p.start("open")
    p.stop("open")


def test_profiler_matches_jax_streams_and_keys(tmp_path, capsys):
    """The same calls give the same stream names and summary keys as JAX's
    profiler; memory stats are zeros on the CPU; a file the port saved
    renders through tools/show_timestamps.py."""
    jp, p = JProfiler(sync=True), Profiler(sync=True, device="cpu")
    _drive(jp), _drive(p)
    assert [e for e, _ in p.stream] == [e for e, _ in jp.stream]
    times = [t for _, t in p.stream]
    assert times == sorted(times)
    js, s = jp.summary(), p.summary()
    assert {k: sorted(v) for k, v in s.items()} == \
        {k: sorted(v) for k, v in js.items()}
    assert s["step"]["count"] == 2 and s["alloc"]["count"] == 1
    assert s["alloc"]["alloc_delta_mb"] == s["alloc"]["peak_mb"] == 0
    assert Profiler.memory_stats("cpu") == {
        "bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    rec = tmp_path / "r.json"
    p.save(str(rec))
    saved = json.loads(rec.read_text())
    assert set(saved) == {"summary", "stream"}
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import show_timestamps
    finally:
        sys.path.pop(0)
    show_timestamps.main([str(rec), "--top", "2"])
    out = capsys.readouterr().out
    assert "boundary" in out and "top 2 gaps" in out
    p.reset()
    assert p.memory == {} and p.stream == []


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    p = Profiler(device="cpu")
    with p.trace(str(tmp_path)):
        torch.ones(8) * 2
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


def test_entry_points_take_the_card_unless_told_cpu(tmp_path):
    """Without a card, the profiler's fence, the struct loader, the sweep
    and the demo raise unless told `cpu`; nothing falls back."""
    from flowspec_tpu_torch import demo
    from flowspec_tpu_torch.eval import sweep
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Profiler(sync=True).start("x")
    mc = struct_base.model_config(struct_base.SCALES["tiny8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        struct_base.load_base(os.path.join(FIX, "struct_tiny8_base.npz"), mc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["--random", "tiny", "--data", MT_BENCH,
                    "--out", str(tmp_path / "x.jsonl")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--random", "tiny"])


# ---- the sweep CLI and the demo ---------------------------------------------

ROW_KEYS = {"temperature", "depth", "expand_depth", "score_temp",
            "chunk_len", "engine", "schedule", "draft", "quant", "wall_s"}
SERVE_KEYS = {"name", "turn", "questions", "new_tokens", "throughput_tok_s",
              "rounds", "slot_utilization", "latency_rounds_p50",
              "latency_rounds_p95", "queue_order", "prefix_cache", "warmed"}


def test_sweep_cli_depth_grid(tmp_path):
    from flowspec_tpu_torch.eval.sweep import main
    out = tmp_path / "rows.jsonl"
    rows = main(["--cpu", "--random", "tiny", "--engine", "single",
                 "--data", "data/qa/question.jsonl", "--limit", "1",
                 "--depths", "3,4", "--expand-depths", "2",
                 "--chunk-lens", "8", "--max-new-tokens", "8",
                 "--out", str(out)])
    assert len(rows) == 2 and {r["depth"] for r in rows} == {3, 4}
    keys = ROW_KEYS | set(jharness.EvalResult(name="x").summary())
    assert all(set(r) == keys for r in rows)
    assert all(r["new_tokens"] == 8 for r in rows)
    assert [json.loads(x) for x in out.read_text().splitlines()] == rows


def test_sweep_cli_serve_prefix_cache(tmp_path):
    from flowspec_tpu_torch.eval.sweep import main
    base = ["--cpu", "--random", "tiny", "--engine", "serve",
            "--serve-slots", "2", "--data", "data/mt_bench/question.jsonl",
            "--limit", "4", "--depths", "3", "--expand-depths", "2",
            "--chunk-lens", "8", "--max-new-tokens", "8",
            "--max-seq-len", "512"]
    r0 = main(base + ["--out", str(tmp_path / "a.jsonl")])[0]
    r1 = main(base + ["--prefix-cache", "--queue-order", "sjf",
                      "--out", str(tmp_path / "b.jsonl")])[0]
    assert set(r0) == set(r1) == ROW_KEYS | SERVE_KEYS
    assert r0["new_tokens"] == r1["new_tokens"] == 32
    assert r1["rounds"] < r0["rounds"], (r1["rounds"], r0["rounds"])
    assert r1["prefix_cache"] and r1["queue_order"] == "sjf"
    assert 0 < r1["slot_utilization"] <= 1


def test_sweep_cli_temperature_grid_resume(tmp_path):
    from flowspec_tpu_torch.eval.sweep import main
    rows = main(["--cpu", "--random", "tiny", "--engine", "single",
                 "--data", "data/mt_bench/question.jsonl", "--limit", "1",
                 "--max-conv-turns", "2", "--depths", "3",
                 "--expand-depths", "2", "--chunk-lens", "8",
                 "--temperatures", "0,1", "--resume", "--no-fused",
                 "--max-new-tokens", "8",
                 "--out", str(tmp_path / "rows.jsonl")])
    assert [r["temperature"] for r in rows] == [0.0, 1.0]
    assert all(r["resume_hits"] == 1 and r["new_tokens"] == 16
               for r in rows)
    assert all(r["accept_per_round"] is not None for r in rows)


@pytest.mark.parametrize("engine", ["single", "pipeline", "tp", "galaxy",
                                    "serve"])
def test_demo_runs_every_engine(engine, capsys):
    from flowspec_tpu_torch.demo import main
    stats = main(["--cpu", "--random", "tiny", "--engine", engine,
                  "--max-new-tokens", "8", "--requests", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"engine={engine} schedule=continuous "
                        "prompt_len=32")
    assert lines[1].startswith("generated token ids: [")
    assert f"{stats['new_tokens']} tokens in " in lines[2]
    assert " tok/s | accept/round = " in lines[2]
    assert stats["new_tokens"] == (24 if engine == "serve" else 8)
    assert ("slot_utilization = " in lines[2]) == (engine == "serve")
