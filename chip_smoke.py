#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flowspec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each on stdout (each with the wall clock at its
emission, `clock_s`):
  1. device   the card, and `nvidia-smi` name + power limit on a line of its
              own; exits non-zero without a CUDA card or outside the repo;
  2. build    the six CUDA kernels from csrc/ (one nvcc each, in parallel);
  3. kernels  each kernel against its plain PyTorch version at the shapes
              the three serve paths give it, with its time (CUDA events, L2
              flushed before every timed launch, a few ms of device work
              queued ahead of each loop), the plain version's time, one
              PyTorch library call's time (`library_ms`, a yardstick the
              port never calls: SDPA over the KV rows the attention kernel
              reads; null for the packed 4-bit products, which no single
              call computes; there `bf16_matmul_ms` times `x @ w` on a
              pre-decoded bf16 weight, which reads four times the bytes; the
              head has both: `topk∘log_softmax` on a bf16 copy made per call
              and `bf16_matmul_ms` on one made once) and the bound (max of
              bytes / 3.35 TB/s and operations / 989 TFLOP/s bf16). All six
              kernels are redesigns: the split-K wgmma `int8_matmul`,
              `nf4_matmul`, `int4_matmul` and `int4_matmul_smallm`, the
              cluster-joined `tree_attention` and the wgmma `head_topk`. Each
              is also held against its earlier version (`*_strip`,
              `int4_matmul_splitk`, `tree_attention_simt`, `head_topk_strip`;
              `old_ms`, timed in turns: new, old, old, new) and must give
              equal bits on two launches; the three wide matmuls are checked
              at ragged shapes, the head at T 16 / 17, V 2176, k 1, k 32 and
              two ties (inside one 128-column strip and across strips); the
              attention is timed in the serving path's form (n_valid read
              on the card, a grid for the whole allocation) and must give
              the bits of the grid sized from a host n_valid, also timed;
  4. serve / fused / lossless / fused_ar      7B int8 base, int8 thin draft;
     the same four with suffix _13b_mixed   13B, attention int4 + FFN int8,
                                  the 13B thin draft in int8;
     and with suffix _7b_nf4                7B, base and thin draft nf4.
     Each at full width (7B int8 also at full depth; 13B mixed cut to 20
     of 40 layers and 7B nf4 to 16 of 32 since the pipeline phase came in,
     for the run's time, `reduced` in their lines): random base from a
     seeded torch.Generator, the committed thin draft, 64-token prompts, 2
     requests x 128 new tokens (3 at 7B int8 before the batched phase came
     in, and at 13B mixed and 7B nf4 before the families), served in turns
     in one process: eager
     SpecEngine.generate, generate_fused twice (the CUDA graph of the
     round; the first turn captures it), generate again; then generate_ar
     and generate_ar_fused (its graph captured first). Every kernel's
     launch count is set to 0 before a turn and read after; a kernel of the
     path with no launch fails the run. One prefill is counted on its own,
     so the launches per round (per replay, per AR step) are a turn's count
     less its prefills over its rounds; they must equal what the code
     implies (305 / 41 / 9 at 7B), each captured graph must launch exactly
     that a replay, the profiler must see that many of each kernel a
     replay (a trace short of kernels, as the profiler can lose records, is
     taken again, up to 3 requests; one with more fails at once), and the
     comparison-only entry points must not launch at all.
     The fused streams must equal the eager ones token for token (the same
     round body on the same allocation); spec against AR fails the run at
     a first divergence whose AR top-2 logit gap is >= 0.05 (for an MoE
     base, unless the same prefix forwarded at the verify's row count puts
     the spec token within 0.05 of its maximum). One eager and
     one fused request of each run (PROFILE_TOKENS new tokens; device
     activity only) under torch.profiler: the device's idle share and each
     kernel family's ms a round, eager and inside the graph.
     Each serve line carries `round_ms`: per kernel, the sum over the
     shapes of one speculative round of those launches x measured ms,
     beside the same sum of bounds and of its old version's ms; each
     lossless line the same for one AR step as `ar_step_ms`.
  5. buckets / force_accept  at 7B int8: generate_fused with
     kv_buckets=(128,) (buckets 128 -> 216: 256 -> 512 base KV rows, two
     graphs), lossless against AR under the near-tie rule; force_accept=3,
     at least 2.5 tokens a round.
  6. the model families, the same four lines each with suffix
     _qwen2_7b_int8       Qwen2-7B (Qwen/Qwen2-7B config.json: 28/4 heads,
                          G 7, V 152064, qkv biases, rope 1e6) at full
                          width, cut to 14 of 28 layers (since the pipeline
                          phase), int8 base, qkv biases N(0, 0.1);
     _mixtral_8x7b_bf16   Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1: 8
                          experts top-2, 32/8 heads) in bf16 at full width,
                          cut to 8 of 32 layers (`reduced` in its line: 32
                          layers of bf16 experts are 92.8 GB; 16 before the
                          pipeline phase);
     both random from a seeded generator with a random full-width int8
     draft (so the beam head is int8), 2 requests x 64 new tokens, served
     and checked as in 4, the fused request profiled (not the eager one);
     Mixtral's expert products are a profile family of their own
     (`moe_experts`, the GEMM kernels `moe_gemm_names` finds);
  7. lm_head   the verify-width lm_head at 7B within f32 summation order of
     the f32 product, one call's peak memory below one f32 head;
  8. loader    Qwen2-7B at full width cut to 2 layers, bf16 with biases,
     written as a 2-shard HF checkpoint (a writer of this script's own),
     loaded by `models/loader.py` (seconds, GB/s) bit for bit; one request
     from the loaded and one from the source params, equal tokens; the int8
     quantization through `save_params` / `load_params`, bit-equal; an
     engine state saved after 4 rounds and resumed, equal to the
     uninterrupted stream.
  9. batched   7B int8 at full width and depth with the committed thin
     draft in int8, served by BatchedSpecEngine over 4 lanes (adapt_tree:
     32-node trees a lane), max_seq_len 480 (512 base KV rows):
     `batched`: generate_batch eager and generate_batch_fused (the gated
     lane loop's CUDA graph) on 4 prompts x 128 tokens in turns (eager,
     fused, fused, eager; fused lanes must equal eager lanes), beside solo
     generate_fused on the same prompts in turns (B 4, B 1, B 1, B 4);
     launches a batched round counted on the path must equal one lane's
     round's (the lanes ride the rows, not the launches), and so must each
     lane graph's replay; `batched_lossless`: every lane against its AR
     stream and against its solo generate_fused stream under the near-tie
     rule, the lanes that left their solo stream counted; `batched_serve`:
     8 requests, budgets 32-192, fifo then lpt (the serve graph's refills
     on the card), every stream against its AR stream, slot_utilization
     and latency_rounds; `batched_prefix`: a 192-token shared prefix and 8
     suffixes of 16-48 tokens, streams against the prefix-less serve's
     under the near-tie rule, in fewer rounds; `batched_conversation`: two
     conversations, two turns through a ConversationStore, turn 2 against
     a solo resume_and_generate; `batched_profile`: one fused batch request
     and one solo fused request under torch.profiler (idle share, ms a
     round by family, kernels a round), peak memory. The kernel phase holds
     the lanes' shapes: attention over 4 lanes at the verify (T 32, 512
     rows), the draft context and a beam level (T 10, 768 rows), each with
     four different live-row counts, lane b bit-equal to a one-lane launch
     of it; int8 and nf4 at M 128 and 256 on 7B widths (the 4-lane verify
     is 128 rows), int4 at M 128 and 256, int8 on the draft's widths at M
     40 (4 lanes x 10), head top-k at T 4 and T 40.
 10. stream    the same pair served by `serve_stream` (`stream_config`),
     max_seq 431 so that a static engine (4 lanes, 32-node trees) and a
     dynamic one (dynamic_tree: 81 / 48 / 32 nodes for 1 / 2-3 / 4 busy
     lanes; dynamic_batch: widths 1, 2, 4) both hold 512 base KV rows;
     each timed run follows `warmup` and must capture no graph and launch
     its rounds x one round's launches: `stream`: 16 requests, 64-token
     prompts, budgets 32-192, Poisson arrivals at 3 a second on the real
     clock, k 8, served by the two engines in turns (static, dynamic,
     dynamic, static): tok/s, admission and completion p50 / p95 in
     seconds, rounds by (width, tree nodes), slot utilization, accept a
     round, width switches and min width (the dynamic turns must narrow:
     min width < 4, >= 2 switches), every stream against AR; every serve
     graph of the dynamic engine must read its width's buffers (equal
     data_ptrs) and no buffer may move; `stream_preempt`: 4 requests of
     192 tokens, then 4 of 16 from 0.3 s on, preempt_factor 2, at least one
     preemption, the paused requests and every stream against AR;
     `stream_overlap`: 8 requests on a cold 192-token shared prefix,
     suffixes 16-48, 64 tokens each, 0.05 s apart, the template built in a
     thread beside serving, the streams against the prefix-less
     serve_stream's; `stream_boundary`: one host admission
     (`_run_boundary`) against one serve replay, host wall ms. The kernel
     phase holds the dynamic modes' shapes: int8 at the verify's M 162,
     192 and 324 and the draft's M 20, attention over 1, 2 and 4 lanes at
     T 81 / 48 / 32, head top-k at T 2 and T 20.
 11. pipeline  the same 7B int8 pair through `PipelineEngine`
     (`pipeline_config`), 4 stages x 8 layers on the card, the JAX
     TreeConfig defaults (81 nodes in chunks of 16, c_buf 18, node_cap 192,
     depth_cap 24) with score_temperature 0.2, max_seq 216 (768 base and
     draft KV rows): every schedule (continuous, pruned, naive, serial,
     pipedec, ar) through `generate` on the serve prompts (2 x 128 tokens),
     continuous also through `generate_fused` (must equal generate), beside
     `SpecEngine.generate_fused` on the same pair and tree in turns (spec,
     spec, the schedules, continuous fused, spec): tok/s, rounds, turns and
     turns a round, skips, ne_fires, accept a round, wall ms and flag reads
     a turn (at most 3), launches a turn, peak memory; every stream lossless
     against AR; one resume (64 tokens, 16 more prompt tokens, 32 more)
     against a fresh run on the whole history; one profiled 16-token
     continuous request (device ms and kernels a turn by family, idle
     share). The kernel phase adds the pipeline's shapes: attention T 18
     and T 192 over 768 rows, int8 at M 18 on the 7B widths.
 12. tp        tensor parallelism in-process on the one card
     (`tp_config`): the 7B int8 pair at full width and depth through
     `TPEngine` at tp 2 and tp 4 (each rank's shards run one after
     another; the collectives are memory operations), `generate` and
     `generate_fused` (the TP round as one CUDA graph) in turns beside
     `SpecEngine.generate_fused` on the same pair and tree, 2 prompts x 64
     tokens: tok/s, accept a round, launches a round (held to the count
     the code implies, and each graph's replay to it), resident weights
     and peak memory, every stream lossless against AR and against the
     unsharded engine's under the near-tie rule, the fused stream equal to
     the eager one; one profiled fused tp 2 request (idle share);
     `tp_galaxy`: galaxy TP at tp 2 on a bf16 7B-width base cut to 8
     layers (the galaxy path takes unquantized LLaMA weights), an 80-node
     tree so that tp divides the verify's rows, beside plain TP on the same
     weights and lossless against AR, the galaxy forward's engaged count
     > 0 and at least one a round; `tp_pipeline`: PP x TP on
     `stage_tp_mesh(4, 2)`, the pruned schedule on the pipeline phase's
     tree (2 x 32 tokens), lossless; `tp_dryrun`:
     `entry.dryrun_multichip(4)` on the card (bf16, head dim 64: every
     schedule over 4 stages, TP and galaxy at tp 4, the (2, 2) mesh on an
     uneven split, against the AR stream; the struct tiny8 gate, continuous
     and pruned over 4 stages at accept/round > 2.5 under the near-tie
     rule; the trained tiny-draft gate named as not run, CPU-only for its
     head dim 16). The kernel phase adds the shard
     widths: int8 at tp 2 / 4 on the 7B widths (wq Out 2048 / 1024, wo In
     2048 / 1024, w_gate Out 5504 / 2752 -- 2752 takes 64-column strips --
     w_down In 5504 / 2752) at M 64 and 81 (and M 18 at tp 2, the PP x TP
     chunk), the thin draft's at tp 2 / 4 (Out / In 512 / 256, 1408 / 704)
     at M 9 and 10, and attention on 16 / 8 heads (verify T 81, galaxy T
     80, the draft's 4 / 2 heads at T 9 / 10, the PP x TP chunk T 18).
 13. eval      the evaluation path (`eval_config`): the 7B int8 pair at full
     width and depth (random base from the generator seeded SEED, the
     committed thin draft in int8) through the port's sweep CLI
     `eval.sweep.main` on data/mt_bench (byte tokenizer, V 32000), 4
     questions x 2 turns, depth 8, score temperature 0.2, 64 new tokens a
     turn, max_seq 640: `eval_single_fused` (generate_fused) and
     `eval_resume` (`--resume --no-fused`, resume_hits must be 4), each
     row at its token budget, question 1's two answers against
     `generate_ar` under the near-tie rule, each call's host seconds;
     `eval_serve`: `run_eval_serve` on a 4-lane BatchedSpecEngine (81
     nodes a lane, as the sweep builds it), 8 questions x 2 turns, the
     preamble prefilled once, a ConversationStore (`resumed`, `cold`);
     `eval`: each part's Profiler.profile_context summary (seconds, alloc
     delta, peak MB), the launches (int8, attention and head > 0, the
     comparison-only entry points 0) and the tok/s line of `python -m
     flowspec_tpu_torch.demo --random 7b --thin-draft ...` run in a child
     process.
 14. pipeline_procs  a stage per process (`procs_config`): the pipeline
     phase's pair and tree through `PipelineEngine` on a distributed
     stage_mesh(4), 4 stage processes x 8 layers at full width and depth
     on the one card (`python3 chip_smoke.py --stage <rank> <world> <port>
     <out.json>`, each drawing the seeded pair, keeping its block and the
     replicated part), over gloo through pinned host buffers (the one
     transport processes sharing a card have; NCCL refuses two ranks on one
     device), continuous and pruned on the serve prompts (2 x 64 tokens)
     after the in-process engine on the same prompts: `pipeline_procs`:
     tok/s, rounds, turns, turns and accept a round, wall ms a turn, the
     stage ring's host ms and gloo bytes a turn by op, flag checks, int8 /
     attention / head launches per process, each process's drawn, kept and
     resident weights and peak memory; every stream lossless against AR,
     equal token for token and stat for stat to the in-process engine's
     and across the ranks (whose flags every turn's gather compares), the
     stage layers' launches summed over the processes equal to the
     in-process engine's and each process's replicated launches to its
     replicated part; gloo must refuse a CUDA tensor without host staging;
     `pipeline_procs_resume`: one continuous resume (16 more prompt tokens,
     32 more) against a fresh run on the whole history;
     `pipeline_procs_dryrun`: `python -m flowspec_tpu_torch.multihost_dryrun
     --device cuda` (2 processes x 4 stages, bf16 at hidden 512: the six
     schedules, PP x TP and galaxy across the processes).
Phases 4-6 and 9-14 run each configuration in a process of its own
(`serve_child`,
`python3 chip_smoke.py --serve <tag> <rows.json> <out.json>`, started by
the run with the kernel phase's rows), so no process opens more than a few
profiler sessions. Every line of phases 4-8 carries the card's name and
power limit. The kernel phase also holds the families' shapes: attention
at G 7 (4 KV heads) and G 4 (8 KV heads), head top-k at V 152064 (and a
tie across its strips), int8 at Qwen2-7B's widths (In 3584 and 18944) and
the full-width drafts' (M 10).
Then the `kernels` line (each kernel of the path, with its comparison-only
old entry point under "old") and, last, {"ok": true,
"device": {...}}. Per-shape
details go to chiprun_out/chip_smoke_kernels.jsonl. Any failure raises: no
phase catches an error and still exits 0.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_OPS_PER_S = 989e12          # dense bf16 tensor cores
SEED = 0
PROMPT_LEN, NEW_TOKENS, N_REQUESTS = 64, 128, 2
NEAR_TIE_GAP = 0.05
PROFILE_TRIES = 3                # profiled requests before a short trace fails
# new tokens of a profiled request (128 before the pipeline phase came in:
# parsing a trace took ~75 s for a 128-step fused AR request, the run's time)
PROFILE_TOKENS = 32
HEAD_START = 40                  # flushes queued before a timed loop (~4 ms)
TOLERANCE = "|err| <= 1e-2*|plain| + 1e-2"

# int8 shapes on the 7B and 13B paths: (name, M, In, Out); M = 1 AR step, 9
# draft context, 10 beam level, 64 prefill chunk, 81 tree verify (node_cap
# 96 clamped to total_tokens + 1), 96 the unclamped node cap
INT8_SHAPES = (
    [(f"base_{w}_M{m}", m, i, o) for m in (1, 64, 81, 96)
     for w, i, o in (("wq", 4096, 4096), ("w_gate", 4096, 11008),
                     ("w_down", 11008, 4096))]
    + [(f"draft_{w}_M{m}", m, i, o) for m in (9, 10)
       for w, i, o in (("fc", 8192, 1024), ("wq", 1024, 1024),
                       ("w_gate", 1024, 2816), ("w_down", 2816, 1024),
                       ("w_out", 1024, 4096))]
    + [(f"13b_{w}_M{m}", m, i, o) for m in (1, 64, 81)
       for w, i, o in (("w_gate", 5120, 13824), ("w_down", 13824, 5120))]
    + [(f"13b_draft_{w}_M10", 10, i, o)
       for w, i, o in (("fc", 10240, 1024), ("w_out", 1024, 5120))]
    # Qwen2-7B's int8 base at the AR step, the prefill chunk and the verify
    # (wo has wq's shape, wv wk's, w_up w_gate's; w_down: 296 K tiles), and
    # the full-width int8 drafts of Qwen2-7B and Mixtral-8x7B at M 10
    + [(f"qwen2_{w}_M{m}", m, i, o) for m in (1, 64, 81)
       for w, i, o in (("wq", 3584, 3584), ("wk", 3584, 512),
                       ("w_gate", 3584, 18944), ("w_down", 18944, 3584))]
    + [(f"{fam}_draft_{w}_M10", 10, i, o) for fam, h, kv, inter in (
        ("qwen2", 3584, 512, 18944), ("mixtral", 4096, 1024, 14336))
       for w, i, o in (("fc", 2 * h, h), ("wq", h, h), ("wk", h, kv),
                       ("w_gate", h, inter), ("w_down", inter, h))])
BASE_7B = (("wq", 4096, 4096), ("w_gate", 4096, 11008),
           ("w_down", 11008, 4096))
# packed 4-bit shapes: nf4 on the 7B nf4 path (base at M 1 / 64 / 81, the
# thin draft's five at M 9 / 10); int4 wgmma kernel on 13B attention at
# prefill and verify width; int4 small-M entry on 13B attention at M 1 / 9 /
# 32 and on the 7B w_down (half-In 5504 has no divisor that is a multiple of
# 256, the shape the TPU kernel declines)
NF4_SHAPES = (
    [(f"base_{w}_M{m}", m, i, o) for m in (1, 64, 81) for w, i, o in BASE_7B]
    + [(f"draft_{w}_M{m}", m, i, o) for m in (9, 10)
       for w, i, o in (("fc", 8192, 1024), ("wq", 1024, 1024),
                       ("w_gate", 1024, 2816), ("w_down", 2816, 1024),
                       ("w_out", 1024, 4096))])
# ragged shapes for the three split-K wgmma kernels: Out a multiple of 32 but
# not of 64 (1056) and of 64 but not of 128 (1088), In = 64 (one block), In /
# 64 prime (13, 37: a split count that does not divide), M around every
# instantiated width
RAGGED_SHAPES = [(f"ragged_M{m}_{i}x{o}", m, i, o)
                 for i, o in ((832, 1056), (2368, 1088), (64, 1056),
                              (2368, 4096))
                 for m in (1, 8, 17, 81, 96, 130)]
INT4_SHAPES = [("13b_wq_M64", 64, 5120, 5120), ("13b_wq_M81", 81, 5120, 5120)]
INT4_SMALLM_SHAPES = [("13b_wq_M1", 1, 5120, 5120),
                      ("13b_wq_M9", 9, 5120, 5120),
                      ("13b_wq_M32", 32, 5120, 5120),
                      ("7b_w_down_M1", 1, 11008, 4096)]
# attention: (name, nq, nkv, T, S, n_valid); "late": a verify round past 256
# live rows (prompt 64 + up to 128 committed + 81 tree rows), which the later
# rounds of every request reach
ATTN_SHAPES = [("verify_T81", 32, 32, 81, 512, 64 + 64 + 81),
               ("verify_T81_late", 32, 32, 81, 512, 64 + 128 + 81),
               ("verify_T96", 32, 32, 96, 512, 64 + 64 + 96),
               ("prefill_T64", 32, 32, 64, 512, 64),
               ("ar_T1", 32, 32, 1, 512, 200),
               ("draft_ctx_T9", 8, 8, 9, 512, 150),
               ("beam_T10", 8, 8, 10, 512, 150 + 80),
               ("13b_verify_T81", 40, 40, 81, 512, 64 + 64 + 81),
               ("13b_verify_T81_late", 40, 40, 81, 512, 64 + 128 + 81),
               ("13b_prefill_T64", 40, 40, 64, 512, 64),
               ("13b_ar_T1", 40, 40, 1, 512, 200)] + [
    # Qwen2-7B: 28 query heads on 4 KV heads (G 7: 567 rows a KV head at
    # verify); Mixtral-8x7B: 32 on 8 (G 4); their full-width drafts the same
    (f"{fam}_{name}", nq, nkv, t, 512, n_valid)
    for fam, nq, nkv in (("qwen2", 28, 4), ("mixtral", 32, 8))
    for name, t, n_valid in (("verify_T81", 81, 64 + 64 + 81),
                             ("verify_T81_late", 81, 64 + 128 + 81),
                             ("prefill_T64", 64, 64), ("ar_T1", 1, 200),
                             ("draft_T10", 10, 150 + 80))]
# head top-k: (name, T, H, V), k 10 (Qwen2-7B's V 152064: 1188 strips, 95 KB
# of keys a row, merged from device memory); then untimed checks (name, T,
# H, V, k): the width boundary, 17 strips, k 1, and k 32 (64 KB of keys a
# row: the merge reads them from device memory instead of staging them)
HEAD_SHAPES = [("root_T1", 1, 4096, 32000), ("beam_T10", 10, 4096, 32000),
               ("13b_root_T1", 1, 5120, 32000),
               ("13b_beam_T10", 10, 5120, 32000),
               ("qwen2_root_T1", 1, 3584, 152064),
               ("qwen2_beam_T10", 10, 3584, 152064)]
HEAD_CHECKS = [("T16", 16, 4096, 32000, 10), ("T17", 17, 4096, 32000, 10),
               ("V2176", 10, 4096, 2176, 10), ("k1", 10, 4096, 32000, 1),
               ("k32", 4, 4096, 32000, 32)]
MAIN = {"int8_matmul": "base_w_gate_M81", "tree_attention": "verify_T81",
        "head_topk": "beam_T10", "nf4_matmul": "base_w_gate_M81",
        "int4_matmul": "13b_wq_M81", "int4_matmul_smallm": "13b_wq_M1"}
REPLACES = {
    "int8_matmul": "flowspec_tpu/ops/quant_matmul.py:47",
    "tree_attention": "flowspec_tpu/ops/tree_attention.py:31",
    "head_topk": "flowspec_tpu/ops/head_topk.py:90",
    "nf4_matmul": "flowspec_tpu/ops/quant_matmul.py:118",
    "int4_matmul": "flowspec_tpu/ops/quant_matmul.py:144",
    "int4_matmul_smallm": "flowspec_tpu/ops/quant_matmul.py:203",
}
# the earlier version each redesigned kernel is timed against: an entry
# point of the same library, for comparison only
OLD = {"int8_matmul": "int8_matmul_strip", "nf4_matmul": "nf4_matmul_strip",
       "int4_matmul": "int4_matmul_strip",
       "tree_attention": "tree_attention_simt",
       "head_topk": "head_topk_strip",
       "int4_matmul_smallm": "int4_matmul_splitk"}
BASE_PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# Mixtral-8x7B's 32 layers of bf16 experts (2.90 GB a layer, 92.8 GB) do not
# fit the card's 80 GB: the served Mixtral keeps 8 (16 before the pipeline
# phase came in: the run's time)
MIXTRAL_LAYERS = 8
# the earlier serve phases cut in depth since the pipeline phase came in, to
# keep the run inside its time limit (full width; 7B int8 stays whole)
CUT_LAYERS = {"13b_mixed": 20, "7b_nf4": 16, "qwen2_7b_int8": 14}
CUT_FULL = {"13b_mixed": 40, "7b_nf4": 32, "qwen2_7b_int8": 28}
FAMILY_REQUESTS, FAMILY_NEW_TOKENS = 2, 64
# configurations whose eager request is profiled too (the families profile
# their fused request only: with a random draft a request runs ~64 rounds,
# and an eager profile of that many takes a minute to read)
EAGER_PROFILED = ("7b_int8", "13b_mixed", "7b_nf4")
# configurations served: (tag, model, quant, requests, new tokens), then the
# kernels whose launch count must be > 0 on generate, and on generate_ar
CONFIGS = {
    # 2 requests each (3 before the families' and the batched phases came
    # in: the run's time)
    "7b_int8": ("7b", "int8", N_REQUESTS, NEW_TOKENS),
    "13b_mixed": ("13b", "mixed", N_REQUESTS, NEW_TOKENS),
    "7b_nf4": ("7b", "nf4", N_REQUESTS, NEW_TOKENS),
    "qwen2_7b_int8": ("qwen2", "int8", FAMILY_REQUESTS, FAMILY_NEW_TOKENS),
    "mixtral_8x7b_bf16": ("mixtral", "bf16", FAMILY_REQUESTS,
                          FAMILY_NEW_TOKENS),
}
ON_SPEC = {"7b_int8": ("int8_matmul", "tree_attention", "head_topk"),
           "13b_mixed": ("int8_matmul", "int4_matmul", "tree_attention",
                         "head_topk"),
           "7b_nf4": ("nf4_matmul", "tree_attention", "head_topk"),
           "qwen2_7b_int8": ("int8_matmul", "tree_attention", "head_topk"),
           # the bf16 base launches no matmul kernel; the int8 draft does
           "mixtral_8x7b_bf16": ("int8_matmul", "tree_attention",
                                 "head_topk")}
ON_AR = {"7b_int8": ("int8_matmul", "tree_attention"),
         "13b_mixed": ("int8_matmul", "int4_matmul", "int4_matmul_smallm",
                       "tree_attention"),
         "7b_nf4": ("nf4_matmul", "tree_attention"),
         "qwen2_7b_int8": ("int8_matmul", "tree_attention"),
         "mixtral_8x7b_bf16": ("tree_attention",)}
# the batched phase: 4 lanes of 7B int8 (adapt_tree: 32-node trees a lane),
# max_seq 480 + 32 node rows = 512 base KV rows; serve budgets 32-192
# (different per request); a 192-token shared prefix with suffixes of 16-48
BATCHED_TAG = "batched_7b_int8"
BATCH, BATCH_MAX_SEQ = 4, 480
SERVE_BUDGETS = [32, 160, 64, 192, 48, 96, 128, 80]
PREFIX_LEN, PREFIX_SUFFIXES, PREFIX_NEW = 192, [16, 24, 32, 40, 48, 20, 28,
                                                36], 48
CONV_NEW, CONV_EXTRA = 48, 16
INT8_SHAPES += (
    [(f"base_{w}_M{m}", m, i, o) for m in (128, 256) for w, i, o in BASE_7B]
    + [(f"draft_{w}_M40", 40, i, o)
       for w, i, o in (("fc", 8192, 1024), ("wq", 1024, 1024),
                       ("w_gate", 1024, 2816), ("w_down", 2816, 1024),
                       ("w_out", 1024, 4096))])
NF4_SHAPES += [(f"base_{w}_M{m}", m, i, o) for m in (128, 256)
               for w, i, o in BASE_7B]
INT4_SHAPES += [(f"7b_{w}_M{m}", m, i, o) for m in (128, 256)
                for w, i, o in (("wq", 4096, 4096), ("w_gate", 4096, 11008))]
HEAD_SHAPES += [("lanes4_root_T4", 4, 4096, 32000),
                ("lanes4_beam_T40", 40, 4096, 32000)]
# attention over 4 lanes: (name, lanes, nq, nkv, T, S, n_valid per lane),
# early and late lanes side by side
LANE_ATTN_SHAPES = [
    ("lanes4_verify_T32", 4, 32, 32, 32, 512, [96, 200, 330, 500]),
    ("lanes4_draft_ctx_T10", 4, 8, 8, 10, 768, [70, 190, 300, 460]),
    ("lanes4_beam_T10", 4, 8, 8, 10, 768, [150, 270, 380, 600])]
# the stream phase: the batched pair served by serve_stream, a static engine
# (4 lanes, 32-node trees) beside a dynamic one (dynamic_tree and
# dynamic_batch: 81 / 48 / 32 nodes for 1 / 2-3 / 4 busy lanes, widths 1, 2,
# 4); max_seq 431 = 512 - 81, so that both allocate 512 base KV rows (the
# dynamic engine's for the full tree's 81-row verify chunk); 16 requests of
# 64-token prompts, budgets 32-192, Poisson arrivals at 3 requests/s; a
# preemption run (4 long, then 4 short from 0.3 s on) and a cold 192-token
# prefix built beside serving (8 requests 0.05 s apart)
STREAM_TAG = "stream_7b_int8"
STREAM_MAX_SEQ = 512 - 81
STREAM_REQUESTS, STREAM_RATE, STREAM_K = 16, 3.0, 8
PREEMPT_LONG, PREEMPT_SHORT, PREEMPT_FACTOR = 192, 16, 2.0
OVERLAP_REQUESTS, OVERLAP_NEW, OVERLAP_GAP = 8, 64, 0.05
# the kernels at the shapes the dynamic modes give them: verify M = lanes x
# nodes (1 x 81, 2 x 48, 2 x 81, 4 x 48, 4 x 81; 4 x 32 = 128 above), the
# draft's M at 2 lanes, head T at 2 lanes, attention over 1, 2 and 4 lanes
INT8_SHAPES += (
    [(f"base_{w}_M{m}", m, i, o) for m in (162, 192, 324)
     for w, i, o in BASE_7B]
    + [(f"draft_{w}_M20", 20, i, o)
       for w, i, o in (("fc", 8192, 1024), ("wq", 1024, 1024),
                       ("w_gate", 1024, 2816), ("w_down", 2816, 1024),
                       ("w_out", 1024, 4096))])
HEAD_SHAPES += [("lanes2_root_T2", 2, 4096, 32000),
                ("lanes2_beam_T20", 20, 4096, 32000)]
LANE_ATTN_SHAPES += [
    ("lanes1_verify_T81", 1, 32, 32, 81, 512, [330]),
    ("lanes2_verify_T48", 2, 32, 32, 48, 512, [150, 400]),
    ("lanes2_verify_T81", 2, 32, 32, 81, 512, [150, 400]),
    ("lanes4_verify_T48", 4, 32, 32, 48, 512, [96, 200, 330, 460]),
    ("lanes4_verify_T81", 4, 32, 32, 81, 512, [96, 200, 330, 430]),
    ("lanes2_beam_T10", 2, 8, 8, 10, 768, [270, 600])]
# the pipeline phase: the 7B int8 pair through `PipelineEngine` at the JAX
# TreeConfig defaults (81-node trees in chunks of 16 over 4 stages x 8 layers,
# node_cap 192, depth_cap 24) with score_temperature 0.2, max_seq 216 (768
# base and draft KV rows); every schedule through `generate` on the serve
# prompts, continuous also through `generate_fused` and a resume; the kernels
# at its shapes: a stage's chunk (c_buf 18 rows; 192 for serial) over 768
# rows, int8 at M 18 (M 192 above)
PIPE_TAG = "pipeline_7b_int8"
PIPE_MAX_SEQ = 216
PIPE_SCHEDULES = ("continuous", "pruned", "naive", "serial", "pipedec", "ar")
PIPE_RESUME = (64, 16, 32)        # first turn's tokens, extra prompt, second
PIPE_PROFILE_TOKENS = 16
INT8_SHAPES += [(f"base_{w}_M18", 18, i, o) for w, i, o in BASE_7B]
ATTN_SHAPES += [("pipe_chunk_T18", 32, 32, 18, 768, 128 + 48 + 18),
                ("pipe_serial_T192", 32, 32, 192, 768, 128 + 192)]
# the stage-process phase: the same pair and tree through `PipelineEngine`
# on a distributed stage_mesh(4): 4 stage processes of 8 layers each on the
# one card, talking over gloo through pinned host buffers (NCCL refuses two
# ranks on one device), continuous and pruned on the serve prompts (2 x 64
# tokens: the tokens cut, not the width or the depth) beside the in-process
# engine; one continuous resume; `multihost_dryrun --device cuda` (2
# processes x 4 stages at its small bf16 shape). No new kernel shape: a
# stage process runs the pipeline phase's shapes.
PROCS_TAG = "pipeline_procs"
PROCS = 4
PROCS_SCHEDULES = ("continuous", "pruned")
PROCS_NEW = 64
PROCS_RESUME = (16, 32)           # extra prompt tokens, tokens after them
PROCS_TIMEOUT = 600               # seconds: the stage processes, the dry run
PROCS_TRANSPORT = ("gloo through pinned host buffers (init_multihost "
                   "host_staging=True)")
# the tensor-parallel phase: the 7B int8 pair through `TPEngine` at tp 2 and
# 4, in-process on the one card, 2 prompts x 64 tokens (the tokens cut, not
# the width or the depth); galaxy at tp 2 on a bf16 7B-width base of 8
# layers with an 80-node tree (tp divides the verify's 80 rows); PP x TP on
# stage_tp_mesh(4, 2), pruned, 2 x 32 tokens; the kernels at shard width
TP_TAG = "tp_7b_int8"
TP_SIZES = (2, 4)
TP_NEW_TOKENS = 64
GALAXY_LAYERS, GALAXY_NODES, GALAXY_NEW = 8, 80, 32
TP_PIPE_NEW = 32
DRAFT_PROJ = ("fc_w", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "w_out")
# the evaluation phase: the 7B int8 pair (the random base from a generator
# seeded SEED, as make_engine's; the committed thin draft in int8) through
# the port's sweep CLI and serving eval on data/mt_bench (templated prompts
# of 200-253 bytes, two turns each; the byte tokenizer caps a prompt at 512
# tokens, so max_seq 640 holds any turn 2 with its 64 new tokens); the
# sweep's tree at depth 8, score temperature 0.2 (81 nodes)
EVAL_TAG = "eval"
EVAL_DATA = "data/mt_bench/question.jsonl"
EVAL_NEW, EVAL_MAX_SEQ = 64, 640
EVAL_QUESTIONS, EVAL_SERVE_QUESTIONS, EVAL_LANES = 4, 8, 4
THIN_7B = "checkpoints/draft_7b_thin_fp16.npz"


def tp_base_widths(tp):
    """(name, In, Out) of the 7B base's shard products at tp (wk / wv
    have wq's shape, w_up w_gate's)."""
    return (("wq", 4096, 4096 // tp), ("wo", 4096 // tp, 4096),
            ("w_gate", 4096, 11008 // tp), ("w_down", 11008 // tp, 4096))


def tp_draft_widths(tp):
    """The thin 7B draft's shard products at tp (w_out is replicated)."""
    return (("fc", 8192, 1024 // tp), ("wq", 1024, 1024 // tp),
            ("wo", 1024 // tp, 1024), ("w_gate", 1024, 2816 // tp),
            ("w_down", 2816 // tp, 1024))


INT8_SHAPES += (
    [(f"tp{tp}_base_{w}_M{m}", m, i, o) for tp in TP_SIZES
     for m in (64, 81) for w, i, o in tp_base_widths(tp)]
    + [(f"tp2_base_{w}_M18", 18, i, o) for w, i, o in tp_base_widths(2)]
    + [(f"tp{tp}_draft_{w}_M{m}", m, i, o) for tp in TP_SIZES
       for m in (9, 10) for w, i, o in tp_draft_widths(tp)])
ATTN_SHAPES += (
    [(f"tp{tp}_verify_T81", 32 // tp, 32 // tp, 81, 512, 64 + 64 + 81)
     for tp in TP_SIZES]
    + [(f"tp{tp}_draft_ctx_T9", 8 // tp, 8 // tp, 9, 512, 150)
       for tp in TP_SIZES]
    + [(f"tp{tp}_beam_T10", 8 // tp, 8 // tp, 10, 512, 150 + 80)
       for tp in TP_SIZES]
    + [("tp2_galaxy_T80", 16, 16, 80, 512, 64 + 32 + 80),
       ("tp2_pipe_chunk_T18", 16, 16, 18, 768, 128 + 48 + 18)])
# attention at the eval phase's shapes: max_seq 640 gives the base 768 KV
# rows (640 + 81 nodes) and the thin draft 1024 (640 + 14 levels x top-k
# 10); the verify (T 81), the base's and the draft's prefill chunks (T 64)
# and the draft's context and beam passes (T 10), one lane and 4; n_valid
# the least and most the path reached (turn 1's first round, turn 2's last).
# The phase records the shapes its engines give the kernel and fails on one
# that no row checked. The demo's child (max_seq 1152: 1280 rows for both
# models; a 32-token prompt, 64 new) is out of the recorder's reach: its
# rows are the shapes the same tree and max_seq give the demo on the CPU
EVAL_ATTN_SHAPES = [("eval_verify_T81", 32, 32, 81, 768, 541),
                    ("eval_prefill_T64", 32, 32, 64, 768, 448),
                    ("eval_draft_prefill_T64", 8, 8, 64, 1024, 448),
                    ("eval_draft_T10", 8, 8, 10, 1024, 226),
                    ("eval_draft_T10_late", 8, 8, 10, 1024, 540)]
EVAL_LANE_ATTN_SHAPES = [
    ("eval_lanes4_verify_T81", 4, 32, 32, 81, 768, [242, 330, 450, 554]),
    ("eval_lanes4_draft_T10", 4, 8, 8, 10, 1024, [171, 300, 420, 553]),
    ("eval_lanes4_draft_prefill_T64", 4, 8, 8, 64, 1024,
     [192, 300, 420, 536])]
DEMO_ATTN_SHAPES = [("demo_verify_T81", 32, 32, 81, 1280, 177),
                    ("demo_prefill_T64", 32, 32, 64, 1280, 64),
                    ("demo_draft_prefill_T64", 8, 8, 64, 1280, 64),
                    ("demo_draft_T10", 8, 8, 10, 1280, 155),
                    ("demo_draft_ctx_T8", 8, 8, 8, 1280, 102)]
ATTN_SHAPES += EVAL_ATTN_SHAPES + DEMO_ATTN_SHAPES
LANE_ATTN_SHAPES += EVAL_LANE_ATTN_SHAPES
# each configuration's measured kernel rows: attention at the verify, the
# draft's context pass, a beam level and the AR step; the head at the root
# and a beam level
_LLAMA_ROWS = {"verify": "verify_T81", "ctx": "draft_ctx_T9",
               "beam": "beam_T10", "ar": "ar_T1", "root": "root_T1",
               "head": "beam_T10"}
ROWS = {"7b_int8": _LLAMA_ROWS, "7b_nf4": _LLAMA_ROWS,
        "13b_mixed": {**_LLAMA_ROWS, "verify": "13b_verify_T81",
                      "ar": "13b_ar_T1", "root": "13b_root_T1",
                      "head": "13b_beam_T10"},
        "qwen2_7b_int8": {"verify": "qwen2_verify_T81",
                          "ctx": "qwen2_draft_T10", "beam": "qwen2_draft_T10",
                          "ar": "qwen2_ar_T1", "root": "qwen2_root_T1",
                          "head": "qwen2_beam_T10"},
        "mixtral_8x7b_bf16": {**_LLAMA_ROWS, "verify": "mixtral_verify_T81",
                              "ctx": "mixtral_draft_T10",
                              "beam": "mixtral_draft_T10",
                              "ar": "mixtral_ar_T1"}}
# what each configuration serves, for its lines
DESCRIBE = {
    "qwen2_7b_int8": {
        "model": "ModelConfig.qwen2_7b() (Qwen/Qwen2-7B config.json) int8, "
                 "random, seeded; qkv biases N(0, 0.1)",
        "draft": "init_eagle_params full width (int8)", "reduced": None},
    "mixtral_8x7b_bf16": {
        "model": "ModelConfig.mixtral_8x7b() (mistralai/Mixtral-8x7B-v0.1 "
                 "config.json) bf16, random, seeded",
        "draft": "init_eagle_params full width (int8)",
        "reduced": f"32 -> {MIXTRAL_LAYERS} layers: 32 layers of bf16 "
                   "experts are 92.8 GB, more than the card's 80 GB; 8, "
                   "not 16, for the run's time since the pipeline phase"}}


def emit(obj) -> None:
    """Print one JSON line; a phase line carries the wall clock at its
    emission (`clock_s`, seconds since the epoch), so that the phases'
    durations read off the output."""
    if "phase" in obj:
        obj = {**obj, "clock_s": round(time.time(), 3)}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """From an `nvcc -Xptxas -v` log: one line per kernel (a short name,
    registers, spills) and every warning."""
    out, entry, spills = [], "", ""
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1][:48]
        elif "spill" in ln:
            spills = ln
        elif "Used" in ln and "registers" in ln:
            out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}; {spills}")
        elif "warning" in ln.lower():
            out.append(ln)
    return out


def flush_l2(buf) -> None:
    """Push everything out of the 50 MB L2 by reading `buf` (256 MB). The
    lines left behind are clean, as the previous layer's weights are on the
    decode path; zeroing the buffer instead would leave the L2 full of dirty
    lines, whose write-back then competes with the timed kernel's reads."""
    import torch
    buf.view(torch.int32).sum()


def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each launch;
    `flush` (a large buffer) is read before each (`flush_l2`) so weights and
    KV rows come from HBM, not L2, as they do on the decode path, where a
    whole layer's weights pass between two calls. A few milliseconds of
    device work are queued first, so the host runs ahead of the device for
    the whole loop and an event pair never spans the host's time to issue
    the call."""
    import torch
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for _ in range(HEAD_START):
        flush_l2(flush)
    for s, e in ev:
        flush_l2(flush)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmul_bound(kind: str, m: int, n_in: int, n_out: int):
    """Bound of one dequant-matmul: weights, scales, x and y each moved
    once; 2*M*In*Out operations at the bf16 tensor-core rate."""
    if kind == "int8":                    # else packed 4-bit
        n_bytes = n_in * n_out + n_out * 4
    else:
        n_bytes = n_in * n_out // 2 + n_in // 64 * n_out * 4
    return bound_ms(n_bytes + m * (n_in + n_out) * 2, 2.0 * m * n_in * n_out)


def _matmul_row(kernel, fn, old, plain, x, q, s, shape, flush, library,
                counter=None):
    """One dequant-matmul at one shape: against its plain version, and for a
    redesigned kernel also against its old version, with equal bits on two
    launches; timed when `flush` is given. `counter` is the wrapper whose
    count `fn` raises (default `fn`). Raises on a disagreement."""
    import torch
    name, m, n_in, n_out = shape
    counter = counter or fn
    before = counter.launches
    got = fn(x, q, s)
    if counter.launches != before + 1:
        raise AssertionError(f"{kernel} did not launch at {name}")
    want = plain(x, q, s)
    torch.cuda.synchronize()

    def close(a, b):
        # one bf16 rounding of the same f32 sum in another order: <= 1 ulp
        err = (a.float() - b.float()).abs()
        return bool((err <= 1e-2 * b.float().abs() + 1e-2).all()), err

    ok, err = close(got, want)
    b, by = matmul_bound("int8" if kernel == "int8_matmul" else "packed4", m,
                         n_in, n_out)
    row = {"kernel": kernel, "shape": name, "M": m, "In": n_in, "Out": n_out,
           "max_abs_err": float(err.max()), "tolerance": TOLERANCE, "ok": ok,
           "bound_ms": b, "bound_by": by}
    if old is not None:
        ok_old, err_old = close(got, old(x, q, s))
        row["vs_old_max_abs_err"] = float(err_old.max())
        row["equal_bits"] = bool(torch.equal(got, fn(x, q, s)))
        ok = row["ok"] = ok and ok_old and row["equal_bits"]
    if flush is not None:
        if old is not None:
            t = [time_ms(lambda: f(x, q, s), flush)
                 for f in (fn, old, old, fn)]
            row["ms"], row["old_ms"] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            row["runs_ms"] = t
        else:
            row["ms"] = time_ms(lambda: fn(x, q, s), flush)
        row["plain_ms"] = time_ms(lambda: plain(x, q, s), flush, iters=5)
        row["library_ms"] = (None if library is None
                             else time_ms(library, flush, iters=10))
    if not ok:
        raise AssertionError(f"{kernel} disagrees at {name}: {row}")
    return row


def check_int8(dev, gen, flush, details):
    import torch
    from flowspec_tpu_torch.ops import quant_matmul as qm
    rows = {}
    for shape in INT8_SHAPES + RAGGED_SHAPES:
        name, m, n_in, n_out = shape
        x = torch.randn((1, m, n_in), generator=gen, device=dev).to(
            torch.bfloat16)
        q = torch.randint(-127, 128, (n_in, n_out), generator=gen,
                          device=dev).to(torch.int8)
        s = torch.full((n_out,), n_in ** -0.5 / 127.0, device=dev)
        timed = shape not in RAGGED_SHAPES
        row = _matmul_row(
            "int8_matmul", qm.int8_matmul, qm.int8_matmul_strip,
            qm.int8_matmul_plain, x, q, s, shape, flush if timed else None,
            lambda: (x @ q.to(torch.bfloat16)) * s)
        row["plan"] = qm.matmul_plan(m, n_in, n_out, "int8")._asdict()
        details.append(row)
        if timed:
            rows[name] = row
    return rows


def check_packed4(kernel, shapes, dev, gen, flush, details):
    """One of the packed 4-bit kernels (`nf4_matmul`, `int4_matmul`,
    `int4_matmul_smallm`) at `shapes` against its plain version and its old
    version; the two wide ones also at the ragged shapes (int4 through
    `int4_matmul_wide`, its wgmma kernel at any M)."""
    import torch
    from flowspec_tpu_torch.ops import quant_matmul as qm
    fn = getattr(qm, kernel)
    nf4 = kernel == "nf4_matmul"
    fmt = "nf4" if nf4 else "int4"
    plain = qm.nf4_matmul_plain if nf4 else qm.int4_matmul_plain
    old = getattr(qm, OLD[kernel])
    ragged = RAGGED_SHAPES if kernel != "int4_matmul_smallm" else []
    rows = {}
    for shape in list(shapes) + ragged:
        name, m, n_in, n_out = shape
        x = torch.randn((1, m, n_in), generator=gen, device=dev).to(
            torch.bfloat16)
        q = torch.randint(0, 256, (n_in // 2, n_out), generator=gen,
                          device=dev).to(torch.uint8)
        s = torch.full((n_in // 64, n_out),
                       n_in ** -0.5 / (1.0 if nf4 else 7.0), device=dev)
        timed = shape not in RAGGED_SHAPES
        call = (qm.int4_matmul_wide if kernel == "int4_matmul"
                and m <= qm.SMALL_M else fn)
        row = _matmul_row(kernel, call, old, plain, x, q, s, shape,
                          flush if timed else None, None, counter=fn)
        row["plan"] = qm.matmul_plan(m, n_in, n_out, fmt)._asdict()
        if kernel == "int4_matmul_smallm":
            row["old_ksplit"] = qm.split_k(n_in, n_out)
        if timed:
            w_bf16 = qm._decode4_bf16(q, s, nf4)
            row["bf16_matmul_ms"] = time_ms(lambda: x @ w_bf16, flush,
                                            iters=10)
        details.append(row)
        if timed:
            rows[name] = row
    return rows


def attention_inputs(gen, dev, nq, nkv, t, s_max, n_valid, d=128):
    """q, k, v (bf16) and the (T, S) f32 bias of one ATTN_SHAPES row:
    context [0, n_valid - t) visible, a random tree mask (diagonal always
    live) over the last t live rows, -1e9 past n_valid."""
    import torch
    q = torch.randn((1, nq, t, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((1, nkv, s_max, d), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((1, nkv, s_max, d), generator=gen, device=dev).to(
        torch.bfloat16)
    ctx = n_valid - t
    tree = (torch.rand((t, t), generator=gen, device=dev) < 0.3).tril()
    tree |= torch.eye(t, dtype=torch.bool, device=dev)
    bias = torch.full((t, s_max), -1e9, device=dev)
    bias[:, :ctx] = 0.0
    bias[:, ctx:n_valid] = torch.where(tree, 0.0, -1e9)
    return q, k, v, bias


def check_attention(dev, gen, flush, details):
    """Tree attention at every ATTN_SHAPES row: the kernel against its plain
    version and its old version (`tree_attention_simt`), equal bits on two
    launches; new and old timed in turns (new, old, old, new), plain and
    SDPA (over the KV rows the kernel reads, the same function) timed the
    same way, all with the L2 flushed before each launch."""
    import torch
    import torch.nn.functional as F
    from flowspec_tpu_torch.ops.tree_attention import (
        attention_plan, kernel_keys, live_keys, tree_attention,
        tree_attention_plain, tree_attention_simt)
    rows = {}
    d = 128
    for name, nq, nkv, t, s_max, n_valid in ATTN_SHAPES:
        q, k, v, bias = attention_inputs(gen, dev, nq, nkv, t, s_max,
                                         n_valid, d)
        n_keys = live_keys(s_max, n_valid)
        n_read = kernel_keys(s_max, n_valid)
        nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        before = tree_attention.launches
        got = tree_attention(q, k, v, bias, nv)       # the serving path's form
        again = tree_attention(q, k, v, bias, nv)
        host = tree_attention(q, k, v, bias, n_valid)
        if tree_attention.launches != before + 3:
            raise AssertionError(f"tree_attention did not launch at {name}")
        old = tree_attention_simt(q, k, v, bias, n_valid)
        want = tree_attention_plain(q, k, v, bias, n_keys)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        err_old = float((got.float() - old.float()).abs().max())
        equal = bool(torch.equal(got, again))
        equal_host = bool(torch.equal(got, host))
        ok = err <= 2e-2 and err_old <= 2e-2 and equal and equal_host
        b, by = bound_ms(
            2 * nkv * n_valid * d * 2 + 2 * nq * t * d * 2 + t * n_valid * 4,
            4.0 * nq * t * n_valid * d)
        kr = k[:, :, :n_read].repeat_interleave(nq // nkv, dim=1)
        vr = v[:, :, :n_read].repeat_interleave(nq // nkv, dim=1)
        mask = bias[:, :n_read].to(torch.bfloat16).contiguous()
        runs = [time_ms(lambda: f(q, k, v, bias, a), flush)
                for f, a in ((tree_attention, nv), (tree_attention_simt,
                                                    n_valid),
                             (tree_attention_simt, n_valid),
                             (tree_attention, nv))]
        row = {"kernel": "tree_attention", "shape": name, "nq": nq,
               "nkv": nkv, "T": t, "S": s_max, "D": d, "n_valid": n_valid,
               "n_keys_read": n_read, "old_n_keys_read": n_keys,
               # the grid for the allocation, n_valid read on the card
               # (empty splits past the live tiles), beside the grid sized
               # to the live tiles from a host n_valid: equal bits
               "plan": attention_plan(nkv, nq // nkv, t, s_max)._asdict(),
               "host_n_valid_plan": attention_plan(
                   nkv, nq // nkv, t, n_read, alloc_keys=s_max)._asdict(),
               "host_n_valid_ms": time_ms(
                   lambda: tree_attention(q, k, v, bias, n_valid), flush),
               "max_abs_err": err, "vs_old_max_abs_err": err_old,
               "equal_bits": equal, "equal_bits_host_n_valid": equal_host,
               "tolerance": "2e-2 abs (bf16 outputs)", "ok": ok,
               "ms": (runs[0] + runs[3]) / 2,
               "old_ms": (runs[1] + runs[2]) / 2,
               "runs_ms": runs,
               "plain_ms": time_ms(
                   lambda: tree_attention_plain(q, k, v, bias, n_keys), flush,
                   iters=5),
               "library_ms": time_ms(
                   lambda: F.scaled_dot_product_attention(
                       q, kr, vr, attn_mask=mask), flush, iters=10),
               "bound_ms": b, "bound_by": by}
        details.append(row)
        rows[name] = row
        if not ok:
            raise AssertionError(f"tree_attention disagrees at {name}: {row}")
    return rows


def check_attention_lanes(dev, gen, flush, details):
    """Tree attention over the lanes of LANE_ATTN_SHAPES: one launch with a
    (B, T, S) bias and a (B,) device n_valid against plain lane by lane,
    lane b bit-equal to a one-lane launch of lane b, equal bits on two
    launches; timed beside plain and SDPA (over the most rows a lane
    reads, each lane's mask), bound over every lane's live rows. The old
    kernel, `tree_attention_simt`, takes one lane (it is for comparison
    only): these rows time the four one-lane launches of the new kernel
    instead (`one_lane_launches_ms`)."""
    import torch
    import torch.nn.functional as F
    from flowspec_tpu_torch.ops.tree_attention import (
        attention_plan, kernel_keys, live_keys, tree_attention,
        tree_attention_plain)
    rows = {}
    d = 128
    for name, b, nq, nkv, t, s_max, n_valid in LANE_ATTN_SHAPES:
        parts = [attention_inputs(gen, dev, nq, nkv, t, s_max, n, d)
                 for n in n_valid]
        q, k, v = (torch.cat([p[i] for p in parts]) for i in range(3))
        bias = torch.stack([p[3] for p in parts])
        nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        before = tree_attention.launches
        got = tree_attention(q, k, v, bias, nv)
        again = tree_attention(q, k, v, bias, nv)
        ones = [tree_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], bias[i],
                               nv[i:i + 1]) for i in range(b)]
        if tree_attention.launches != before + 2 + b:
            raise AssertionError(f"tree_attention did not launch at {name}")
        want = [tree_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                     bias[i], live_keys(s_max, n))
                for i, n in enumerate(n_valid)]
        torch.cuda.synchronize()
        err = max(float((got[i:i + 1].float() - w.float()).abs().max())
                  for i, w in enumerate(want))
        lane_bits = [bool(torch.equal(got[i:i + 1], o))
                     for i, o in enumerate(ones)]
        equal = bool(torch.equal(got, again))
        ok = err <= 2e-2 and equal and all(lane_bits)
        n_read = max(kernel_keys(s_max, n) for n in n_valid)
        b_ms, by = bound_ms(
            sum(2 * nkv * n * d * 2 + t * n * 4 for n in n_valid)
            + b * 2 * nq * t * d * 2, sum(4.0 * nq * t * n * d
                                          for n in n_valid))
        kr = k[:, :, :n_read].repeat_interleave(nq // nkv, dim=1)
        vr = v[:, :, :n_read].repeat_interleave(nq // nkv, dim=1)
        mask = bias[:, None, :, :n_read].to(torch.bfloat16).contiguous()
        row = {"kernel": "tree_attention", "shape": name, "lanes": b,
               "nq": nq, "nkv": nkv, "T": t, "S": s_max, "D": d,
               "n_valid": n_valid,
               "plan": attention_plan(nkv, nq // nkv, t, s_max,
                                      lanes=b)._asdict(),
               "max_abs_err": err, "equal_bits": equal,
               "lane_equal_bits_to_one_lane_launch": lane_bits,
               "tolerance": "2e-2 abs (bf16 outputs)", "ok": ok,
               "ms": time_ms(lambda: tree_attention(q, k, v, bias, nv),
                             flush),
               "one_lane_launches_ms": time_ms(lambda: [tree_attention(
                   q[i:i + 1], k[i:i + 1], v[i:i + 1], bias[i], nv[i:i + 1])
                   for i in range(b)], flush),
               "plain_ms": time_ms(
                   lambda: tree_attention_plain(q, k, v, bias, nv.cpu()),
                   flush, iters=5),
               "library_ms": time_ms(
                   lambda: F.scaled_dot_product_attention(
                       q, kr, vr, attn_mask=mask), flush, iters=10),
               "bound_ms": b_ms, "bound_by": by}
        details.append(row)
        rows[name] = row
        if not ok:
            raise AssertionError(f"tree_attention disagrees at {name}: {row}")
    return rows


def _head_row(name, x, q, s, k, flush):
    """Head top-k at one shape: the kernel against its plain version (the
    log-probs, and the plain log-probs of the kernel's tokens) and against
    its old version, equal bits on two launches; timed in turns with the old
    version, beside plain and two PyTorch yardsticks, when `flush` is
    given. Raises on a disagreement."""
    import torch
    from flowspec_tpu_torch.ops.head_topk import (
        head_logits, head_topk, head_topk_int8, head_topk_plain,
        head_topk_strip)
    from flowspec_tpu_torch.ops.quant import Int8Tensor
    t, h = x.shape
    v = q.shape[1]
    before = head_topk.launches, head_topk_strip.launches
    lp, tok = head_topk_int8(x, q, s, k)
    lp2, tok2 = head_topk_int8(x, q, s, k)
    old_lp, _ = head_topk_strip(x, q, s, k)
    want_lp, _ = head_topk_plain(x, q, s, k)
    torch.cuda.synchronize()
    if (head_topk.launches, head_topk_strip.launches) != (before[0] + 2,
                                                          before[1] + 1):
        raise AssertionError(f"head_topk did not launch at {name}")
    # tokens agree where the plain log-probs of the kernel's tokens are the
    # plain top-k values (a kernel pick differing only at an f32
    # summation-order near-tie is still a correct top-k)
    logits = head_logits(x, Int8Tensor(q=q, scale=s))
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    lp_of_tok = (logits.gather(1, tok.long()) - lse)
    err = float(max((lp - want_lp).abs().max(),
                    (lp_of_tok - want_lp).abs().max()))
    err_old = float((lp - old_lp).abs().max())
    equal = bool(torch.equal(lp, lp2) and torch.equal(tok, tok2))
    ok = (err <= 1e-3 and err_old <= 1e-3 and equal
          and bool((tok[:, :-1] != tok[:, 1:]).all()))
    b, by = bound_ms(h * v + v * 4 + t * h * 2 + t * k * 8, 2.0 * t * h * v)
    row = {"kernel": "head_topk", "shape": name, "T": t, "H": h, "V": v,
           "k": k, "max_abs_err": err, "vs_old_max_abs_err": err_old,
           "equal_bits": equal,
           "tolerance": "1e-3 abs on log-probs (f32 sums of H terms)",
           "ok": ok, "bound_ms": b, "bound_by": by}
    if flush is not None:
        runs = [time_ms(lambda: f(x, q, s, k), flush)
                for f in (head_topk_int8, head_topk_strip, head_topk_strip,
                          head_topk_int8)]
        w_bf16 = q.to(torch.bfloat16)
        row.update({
            "ms": (runs[0] + runs[3]) / 2, "old_ms": (runs[1] + runs[2]) / 2,
            "runs_ms": runs,
            "plain_ms": time_ms(lambda: head_topk_plain(x, q, s, k), flush,
                                iters=5),
            "library_ms": time_ms(lambda: torch.topk(torch.log_softmax(
                (x @ q.to(torch.bfloat16)).float() * s, dim=-1), k), flush,
                iters=10),
            "bf16_matmul_ms": time_ms(lambda: torch.topk(torch.log_softmax(
                (x @ w_bf16).float() * s, dim=-1), k), flush, iters=10)})
    if not ok:
        raise AssertionError(f"head_topk disagrees at {name}: {row}")
    return row


def _head_tie(x, q, s, dup):
    """Column `dup` made a copy of row 0's best column: the two equal
    logits must come out lowest token first, as the plain version has
    them, from the kernel and from its old version."""
    import torch
    from flowspec_tpu_torch.ops.head_topk import (
        head_logits, head_topk_int8, head_topk_plain, head_topk_strip)
    from flowspec_tpu_torch.ops.quant import Int8Tensor
    best = int(head_logits(x, Int8Tensor(q=q, scale=s))[0].argmax())
    dup = dup(best)
    q[:, dup] = q[:, best]
    s[dup] = s[best]
    want = sorted([best, dup])
    for fn in (head_topk_int8, head_topk_strip):
        _, tok = fn(x, q, s, 10)
        _, want_tok = head_topk_plain(x, q, s, 10)
        torch.cuda.synchronize()
        if not torch.equal(tok, want_tok) or tok[0, :2].tolist() != want:
            raise AssertionError(f"{fn.__name__} tie order: {tok} vs "
                                 f"{want_tok}, want {want} first")
    return {"best": best, "dup": dup}


def check_head(dev, gen, flush, details):
    """Head top-k at every HEAD_SHAPES row (timed) and HEAD_CHECKS row
    (untimed), then the ties (inside a strip, across strips at V 32000 and
    at Qwen2's V 152064)."""
    import torch

    def operands(t, h, v):
        q = torch.randint(-127, 128, (h, v), generator=gen,
                          device=dev).to(torch.int8)
        s = torch.full((v,), h ** -0.5 / 127.0, device=dev)
        x = (torch.randn((t, h), generator=gen, device=dev) * 5.0).to(
            torch.bfloat16)
        return x, q, s

    rows = {}
    for name, t, h, v in HEAD_SHAPES:
        x, q, s = operands(t, h, v)
        rows[name] = _head_row(name, x, q, s, 10, flush)
        details.append(rows[name])
    for name, t, h, v, k in HEAD_CHECKS:
        x, q, s = operands(t, h, v)
        details.append(_head_row(name, x, q, s, k, None))
    ties = {"inside_strip": _head_tie(
                *operands(1, 4096, 32000),
                lambda b: b - b % 128 + (b % 128 + 37) % 128),
            "across_strips": _head_tie(
                *operands(1, 4096, 32000), lambda b: (b + 128 * 97) % 32000),
            "across_strips_V152064": _head_tie(
                *operands(1, 3584, 152064),
                lambda b: (b + 128 * 601) % 152064)}
    details.append({"kernel": "head_topk", "shape": "ties", **ties,
                    "ok": True})
    return rows


def engine_config(mc, new_tokens: int = NEW_TOKENS):
    """bench.py's trained-draft tree: depth 8, score_temperature 0.2,
    node_cap 96; max_seq = prompt + 128 + 24 (bench.py:347)."""
    from flowspec_tpu_torch.config import (
        EngineConfig, SamplingConfig, TreeConfig)
    tc = TreeConfig(node_cap=96, leaf_cap=96, depth=8, depth_cap=16,
                    score_temperature=0.2)
    return EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                        max_new_tokens=new_tokens,
                        max_seq_len=PROMPT_LEN + NEW_TOKENS + 24)


def make_engine(dev, model: str = "7b", quant: str = "int8",
                n_requests: int = N_REQUESTS, new_tokens: int = NEW_TOKENS,
                layers: int | None = None):
    """(engine, prompts, seconds to build it), at full width, the base
    random from a seeded generator: LLaMA `model` ("7b", "13b") of kind
    `quant` with the committed thin draft of that scale quantized the same
    way ("mixed" keeps the draft int8); "qwen2" (Qwen2-7B, int8, its qkv
    biases N(0, 0.1) so that the bias add runs) and "mixtral"
    (Mixtral-8x7B in bf16, cut to MIXTRAL_LAYERS layers) with a random
    full-width draft in int8, so the beam head is int8 too. `layers` cuts
    a LLaMA or Qwen2 base to that depth (full by default)."""
    import dataclasses
    import torch
    from flowspec_tpu_torch.config import ModelConfig
    from flowspec_tpu_torch.draft.eagle import (
        init_eagle_params, load_thin_draft, quantize_eagle_params)
    from flowspec_tpu_torch.models.llama import random_llama_params
    from flowspec_tpu_torch.models.mixtral import random_mixtral_params
    from flowspec_tpu_torch.runtime import SpecEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    if model == "mixtral":
        mc = dataclasses.replace(ModelConfig.mixtral_8x7b(),
                                 num_hidden_layers=MIXTRAL_LAYERS)
        params = random_mixtral_params(mc, gen, dev)
    else:
        mc = {"7b": ModelConfig.llama_7b, "13b": ModelConfig.llama_13b,
              "qwen2": ModelConfig.qwen2_7b}[model]()
        if layers:
            mc = dataclasses.replace(mc, num_hidden_layers=layers)
        params = random_llama_params(mc, gen, dev, quant)
    if model == "qwen2":
        params = dataclasses.replace(params, layers=dataclasses.replace(
            params.layers, **{f: torch.empty_like(
                getattr(params.layers, f)).normal_(0.0, 0.1, generator=gen)
                for f in ("bq", "bk", "bv")}))
    if model in ("7b", "13b"):
        draft = quantize_eagle_params(load_thin_draft(
            str(ROOT / "checkpoints" / f"draft_{model}_thin_fp16.npz"),
            params.embed), quant)
    else:
        draft = quantize_eagle_params(
            init_eagle_params(gen, mc, embed=params.embed), "int8")
    eng = SpecEngine(params, draft, engine_config(mc, new_tokens))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(3, mc.vocab_size, (PROMPT_LEN,),
                             generator=rng).tolist()
               for _ in range(n_requests)]
    return eng, prompts, build_s


def launch_counts():
    """The wrapper that carries each kernel's launch count, the
    comparison-only entry points included (they must count 0 on a serve
    path)."""
    from flowspec_tpu_torch.ops import counted_wrappers
    return counted_wrappers()


def _matmul_kernel(w, m):
    """The kernel a product of weight `w` at M = m launches (None for a
    plain weight)."""
    from flowspec_tpu_torch.ops.quant import Int4Tensor, Int8Tensor, NF4Tensor
    from flowspec_tpu_torch.ops.quant_matmul import SMALL_M
    if type(w) is Int4Tensor:
        return "int4_matmul_smallm" if m <= SMALL_M else "int4_matmul"
    return {Int8Tensor: "int8_matmul", NF4Tensor: "nf4_matmul"}.get(type(w))


def expected_per_round(eng) -> dict:
    """Launches per speculative round that the code implies: a base verify
    pass (7 projections and one attention per layer, node_cap rows), the
    draft context and one pass per tree level (9 projections and one
    attention each at top_k rows, one head top-k per level)."""
    tree = eng.cfg.tree
    n_layers = eng.cfg.model.num_hidden_layers
    passes = tree.depth + 1
    out = {"tree_attention": n_layers + passes, "head_topk": passes}
    for w, m, n in ([(getattr(eng.params.layers, f), tree.node_cap, n_layers)
                     for f in BASE_PROJ]
                    + [(getattr(eng.draft, f), tree.top_k, passes) for f in
                       ("fc_w", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                        "w_down", "w_out")]):     # w_out: None unless thin
        kernel = _matmul_kernel(w, m)   # plain weights launch no kernel
        if kernel is not None:
            out[kernel] = out.get(kernel, 0) + n
    return out


def _sums(items, per_unit, what) -> dict:
    """{kernel: {"launches", "ms", "bound_ms", "old_ms"}} over `items`
    (kernel, measured row, launches); the launches must add up, kernel by
    kernel, to `per_unit`, as the serve path counted them."""
    out = {}
    for kernel, row, n in items:
        o = out.setdefault(kernel, {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
        o["launches"] += n
        o["ms"] += n * row["ms"]
        o["bound_ms"] += n * row["bound_ms"]
        if "old_ms" in row:
            o["old_ms"] = o.get("old_ms", 0.0) + n * row["old_ms"]
    counted = {k: o["launches"] for k, o in out.items()}
    if counted != {k: n for k, n in per_unit.items() if n}:
        raise AssertionError(f"{what} spreads {counted} launches over its "
                             f"shapes, the serve path counted {per_unit}")
    return out


def _matmul_items(kernel_rows, items, w, m, launches):
    """Append (kernel, row, launches) for weight `w` at M = m; a plain
    weight launches nothing; a shape without a measured row raises."""
    kernel = _matmul_kernel(w, m)
    if kernel is None:
        return
    n_in = w.q.shape[-2] * (1 if kernel == "int8_matmul" else 2)
    key = (m, n_in, w.q.shape[-1])
    for row in kernel_rows[kernel].values():
        if (row["M"], row["In"], row["Out"]) == key:
            items.append((kernel, row, launches))
            return
    raise AssertionError(f"no measured {kernel} row at (M, In, Out) = {key}")


def round_sums(tag, eng, kernel_rows, per_round) -> dict:
    """Per kernel, one speculative round of `eng` as the sum over its shapes
    of launches x the measured row: {kernel: {"launches", "ms", "bound_ms",
    "old_ms" (its old version's ms)}}. A base verify pass runs the 7
    projections and one attention per layer at node_cap rows; the draft
    runs depth + 1 passes (the context pass, then one per tree level) of 9
    projections, one attention and one head top-k at top_k rows (the root's
    head call has one row). The launches spread over the shapes here must
    add up, kernel by kernel, to `per_round`, the launches per round counted
    on the serve path; a shape without a measured row raises."""
    tree, mc = eng.cfg.tree, eng.cfg.model
    n_layers, depth = mc.num_hidden_layers, tree.depth
    rows = ROWS[tag]
    items = []                                   # (kernel, row, launches)
    for f in BASE_PROJ:
        _matmul_items(kernel_rows, items, getattr(eng.params.layers, f),
                      tree.node_cap, n_layers)
    for f in ("fc_w", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "w_out"):
        _matmul_items(kernel_rows, items, getattr(eng.draft, f), tree.top_k,
                      depth + 1)
    attn, head = kernel_rows["tree_attention"], kernel_rows["head_topk"]
    items += [("tree_attention", attn[rows["verify"]], n_layers),
              ("tree_attention", attn[rows["ctx"]], 1),
              ("tree_attention", attn[rows["beam"]], depth),
              ("head_topk", head[rows["root"]], 1),
              ("head_topk", head[rows["head"]], depth)]
    return _sums(items, per_round, "round_sums")


def expected_per_ar_step(eng) -> dict:
    """Launches per autoregressive step that the code implies: one base pass
    at M 1 (7 projections and one attention per layer)."""
    n_layers = eng.cfg.model.num_hidden_layers
    out = {"tree_attention": n_layers}
    for f in BASE_PROJ:
        kernel = _matmul_kernel(getattr(eng.params.layers, f), 1)
        if kernel is not None:
            out[kernel] = out.get(kernel, 0) + n_layers
    return out


def ar_step_sums(tag, eng, kernel_rows, per_step) -> dict:
    """`round_sums` for one autoregressive step: the base pass at M 1."""
    mc = eng.cfg.model
    items = []
    for f in BASE_PROJ:
        _matmul_items(kernel_rows, items, getattr(eng.params.layers, f), 1,
                      mc.num_hidden_layers)
    items.append(("tree_attention", kernel_rows["tree_attention"][
        ROWS[tag]["ar"]], mc.num_hidden_layers))
    return _sums(items, per_step, "ar_step_sums")


def launches_per_round(tag, launches, prefill, n_requests, rounds, expected):
    """Launches per speculative round as the serve path counted them: the
    run's count less one prefill a request, over its rounds. Raises unless
    that is a whole number and equals `expected` for every kernel."""
    per_round = {}
    for n, total in launches.items():
        in_rounds = total - n_requests * prefill[n]
        if in_rounds % rounds or in_rounds // rounds != expected.get(n, 0):
            raise AssertionError(
                f"{tag}: {n} launched {total} times over {n_requests} "
                f"prefills of {prefill[n]} and {rounds} rounds; expected "
                f"{expected.get(n, 0)} a round")
        per_round[n] = in_rounds // rounds
    return per_round


def serve_turn(fn, prompts, new_tokens):
    """Serve `prompts` one after another through `fn` (generate's
    signature): (outputs past the prompt, seconds a request, rounds, new
    tokens, stats of each request)."""
    import torch
    outs, req_s, rounds, new, stats_all = [], [], 0, 0, []
    for p in prompts:
        t0 = time.perf_counter()
        out, stats = fn(p, max_new_tokens=new_tokens, eos_token_id=-1)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t0)
        outs.append(out[len(p):])
        rounds += stats.get("rounds", stats["new_tokens"])
        new += stats["new_tokens"]
        stats_all.append(stats)
    return outs, req_s, rounds, new, stats_all


def zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def counts(counters) -> dict:
    return {n: fn.launches for n, fn in counters.items()}


GEMM_KEYS = ("gemm", "sm90_xmma", "nvjet", "cutlass")


def family(name: str, moe=frozenset()) -> str:
    """The kernel family of a device kernel's name in a profiler trace: this
    port's six CUDA kernels, the split-K reduce pass of int8 / nf4 / int4
    as `matmul_reduce`, the head's merge pass as `head_select`, the GEMMs
    named in `moe` (Mixtral's expert products, `moe_gemm_names`) as
    `moe_experts`, the other cuBLAS GEMMs (the lm_head, a bf16 base's
    projections), sort/top-k, everything else. The wgmma int4 kernel runs
    under both `int4_matmul` and `int4_matmul_smallm` and counts as
    `int4_matmul`."""
    if name in moe:
        return "moe_experts"
    n = name.lower()
    for key, fam in (("qmm_kernel<0", "int8_matmul"),
                     ("qmm_kernel<1", "nf4_matmul"),
                     ("qmm_kernel<2", "int4_matmul"),
                     ("qmm_reduce", "matmul_reduce"),
                     ("int8_matmul_kernel", "int8_matmul_strip"),
                     ("p4_matmul_kernel<true", "nf4_matmul_strip"),
                     ("p4_matmul_kernel<false", "int4_matmul_strip"),
                     ("int4_splitk", "int4_matmul_splitk"),
                     ("tree_attention_simt", "tree_attention_simt"),
                     ("tree_attention_mma", "tree_attention"),
                     ("head_wgmma_kernel", "head_topk"),
                     ("head_select_kernel", "head_select"),
                     ("head_partial_kernel", "head_topk_strip"),
                     ("head_merge_kernel", "head_topk_strip"),
                     ("gemm", "cublas_gemm"), ("sm90_xmma", "cublas_gemm"),
                     ("nvjet", "cublas_gemm"),
                     ("cutlass", "cublas_gemm"), ("sort", "sort_topk"),
                     ("topk", "sort_topk"), ("radix", "sort_topk")):
        if key in n:
            return fam
    return "other"


def moe_gemm_names(eng) -> tuple:
    """(the GEMM kernels of Mixtral's expert products, the GEMM kernels
    they share with the other bf16 products): names of the GEMMs one
    layer's `moe_block` launches at the round's row counts (AR step,
    prefill chunk, verify) under the profiler, less those of the layer's
    attention projections, its router and the lm_head at the same rows. A
    shared name stays in the cuBLAS family, so the MoE family is never
    overstated. A trace without a GEMM, which each of these calls
    launches, fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from flowspec_tpu_torch.models.llama import lm_head_logits
    from flowspec_tpu_torch.models.mixtral import moe_block
    from flowspec_tpu_torch.ops.quant import matmul_f32_out, qmatmul
    mc = eng.cfg.model
    lp = eng.params.layers.layer(0)

    def gemms(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and any(k in ev.name.lower() for k in GEMM_KEYS)}
        if not names:
            raise AssertionError("moe_gemm_names: no GEMM kernel in the "
                                 "trace")
        return names

    xs = [torch.randn((1, t, mc.hidden_size), device=eng.device).to(
        torch.bfloat16) for t in (1, PROMPT_LEN, eng.cfg.tree.node_cap)]
    moe = gemms(lambda: [moe_block(x, lp, mc) for x in xs])
    dense = gemms(lambda: [([qmatmul(x, w) for w in (lp.wq, lp.wk, lp.wo)],
                            matmul_f32_out(x, lp.router),
                            lm_head_logits(eng.params, x)) for x in xs])
    if not moe - dense:
        raise AssertionError("moe_gemm_names: every GEMM kernel of the "
                             f"expert products is a dense one's: {moe}")
    return frozenset(moe - dense), sorted(moe & dense)


def profile_request(fn, prompt, new_tokens, moe=frozenset()) -> dict:
    """One request through `fn` under torch.profiler, device activity only
    (every number below is read from the kernels; recording the CPU ops as
    well, as before the pipeline phase came in, tripled the events to parse
    and the host's overhead in the wall): wall time, device kernel time and
    the device's idle share of the wall time, and per round (per step for a
    request without rounds) the kernels and the device ms of each family
    (`moe`: the MoE GEMMs' names), and of the ten costliest "other" ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = fn(prompt, max_new_tokens=new_tokens, eos_token_id=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rounds = stats.get("rounds", stats["new_tokens"])
    ms, n, other, busy, kernels = {}, {}, {}, 0.0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = ev.time_range.elapsed_us() / 1e6
        fam = family(ev.name, moe)
        ms[fam] = ms.get(fam, 0.0) + dt * 1e3 / rounds
        n[fam] = n.get(fam, 0) + 1
        if fam == "other":
            o = other.setdefault(ev.name[:80], [0.0, 0])
            o[0] += dt * 1e3 / rounds
            o[1] += 1
        busy += dt
        kernels += 1
    return {"wall_s": wall, "rounds": rounds,
            "wall_ms_per_round": wall * 1e3 / rounds,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "device_kernels": kernels, "kernels_per_round": kernels / rounds,
            "device_ms_per_round_by_family": ms, "kernels_by_family": n,
            "kernels_per_round_by_family": {f: c / rounds
                                            for f, c in n.items()},
            # the ten costliest kernels of "other": [ms a round, launches]
            "other_top": dict(sorted(other.items(),
                                     key=lambda kv: -kv[1][0])[:10])}


def graphs_of(eng, kind):
    return [g for k, g in eng._graphs.items() if k[0] == kind]


def check_graph_launches(tag, eng, kind, expected):
    """Every captured graph of `kind` must launch per replay what the code
    implies for one round (one AR step), kernel by kernel."""
    for g in graphs_of(eng, kind):
        if g.launches != {k: n for k, n in expected.items() if n}:
            raise AssertionError(f"{tag}: a {kind} graph launches "
                                 f"{g.launches} a replay, expected {expected}")


def confirmed_profile(tag, fn, prompt, new_tokens, per_round, prefill,
                      moe=frozenset()) -> dict:
    """`profile_request` through `fn`, its trace held to the wrappers'
    counts: each kernel family's kernels equal one prefill and `per_round`
    a round (the wgmma int4 kernel of both int4 entry points is one
    family). The profiler can lose activity records: the same replayed
    request has come back short by part of one AR step's kernels, and by a
    whole replay's, with the counts unchanged and the stream right. So a
    trace that shows fewer kernels than were counted (never more) is taken
    again, up to PROFILE_TRIES requests, and the run fails unless one shows
    every counted kernel; the confirmed profile lists the short traces
    under "short_traces"."""
    short = []
    for _ in range(PROFILE_TRIES):
        prof = profile_request(fn, prompt, new_tokens, moe)
        want = {k: prefill.get(k, 0) + prof["rounds"] * n
                for k, n in per_round.items()}
        want["int4_matmul"] = (want.get("int4_matmul", 0)
                               + want.pop("int4_matmul_smallm", 0))
        seen = prof["kernels_by_family"]
        bad = {k: (seen.get(k, 0), n) for k, n in want.items()
               if n and seen.get(k, 0) != n}
        if not bad:
            prof["short_traces"] = short
            return prof
        short.append(bad)
        if any(s > n for s, n in bad.values()):
            break
    raise AssertionError(f"{tag}: profiler kernels vs counted launches "
                         f"(seen, counted): {short}")


def divergences(eng, prompts, spec_out, ar_out):
    """Spec against AR, request by request: the match fraction and, at the
    first differing position i, the base model's top-2 gap after the AR
    prefix (a fresh prefill); for an MoE base also a second witness, the
    logits after the same prefix from `verify_width_logits`: how far the
    spec token and the AR token at i lie below their maximum."""
    from flowspec_tpu_torch.models.mixtral import MixtralParams
    matches, faults = [], []
    for p, spec, ar in zip(prompts, spec_out, ar_out):
        same = [a == b for a, b in zip(spec, ar)]
        matches.append(sum(same) / len(same))
        if not all(same):
            i = same.index(False)
            fault = {"position": i, "top2_gap": top2_gap(eng, p + ar[:i])}
            if isinstance(eng.params, MixtralParams):
                w = verify_width_logits(eng, p, ar[:i])
                top = float(w.max())
                fault["verify_width"] = {
                    "spec_below_max": top - float(w[spec[i]]),
                    "ar_below_max": top - float(w[ar[i]])}
            faults.append(fault)
    return matches, faults


def verify_width_logits(eng, prompt, tokens):
    """The base model's logits after `prompt` + `tokens` (f32, (V,)): the
    prompt prefilled in `prefill_chunk` chunks as both decode paths do,
    then `tokens` in chunks of the verify's `node_cap` rows, zero-padded,
    so that every product runs at the row count of the verify that chose
    the spec token (the AR step runs one row)."""
    import torch
    from flowspec_tpu_torch.runtime.engine import _prefill_chunk
    state, logits = eng._prefill_chunks(eng.init_state(), prompt)
    n = eng.cfg.tree.node_cap
    for c in range(0, len(tokens), n):
        chunk = tokens[c:c + n]
        toks = torch.zeros((n,), dtype=torch.int32)
        toks[:len(chunk)] = torch.tensor(chunk, dtype=torch.int32)
        toks = toks.to(eng.device)
        state, logits = _prefill_chunk(state, eng.params, eng.draft, toks,
                                       toks, len(chunk), cfg=eng.cfg.model,
                                       fwd=eng.forward_fn)
    return logits.float()


def check_lossless(tag, faults):
    """Spec may differ from AR only at a near-tie: a first divergence whose
    AR top-2 logit gap is below NEAR_TIE_GAP, or, for an MoE base, one at
    which the verify-width forward (`verify_width_logits`) sides with the
    spec token, within NEAR_TIE_GAP of its maximum (rounding that differs
    with the forward's row count can flip a router near-tie, and a flipped
    expert set moves that token's hidden state by more than a logit
    near-tie)."""
    def excused(f):
        return (f["top2_gap"] < NEAR_TIE_GAP
                or f.get("verify_width", {}).get("spec_below_max",
                                                 NEAR_TIE_GAP) < NEAR_TIE_GAP)
    real = [f for f in faults if not excused(f)]
    if real:
        raise AssertionError(f"{tag}: spec diverges from AR off a near-tie: "
                             f"{real}")


def serve_config(tag, dev, counters, kernel_rows, smi):
    """Drive one configuration through SpecEngine.generate and
    generate_fused in turns (eager, fused, fused, eager), then generate_ar
    and generate_ar_fused, with the launch counts zeroed before and read
    after each turn; emit its serve, fused, lossless and fused_ar lines;
    return its launches {kernel: count} over the turns, its `round_sums`,
    its `ar_step_sums` and the two profiled rounds' device ms by family.
    One prefill is counted on its own first, so that a turn's count splits
    into prefills and rounds. Raises if a kernel of its path never launched,
    if the launches per round (per replay) are not the expected ones, if
    the fused stream differs from the eager one, or if spec diverges from
    AR off a near-tie."""
    import torch
    from flowspec_tpu_torch.models.mixtral import MixtralParams
    model, quant, n_requests, new_tokens = CONFIGS[tag]
    suffix = "" if tag == "7b_int8" else "_" + tag
    layers = CUT_LAYERS.get(tag)
    eng, prompts, params_s = make_engine(dev, model, quant, n_requests,
                                         new_tokens, layers)
    draft_kind = "int8" if quant == "mixed" else quant
    about = DESCRIBE.get(tag, {
        "model": f"llama_{model} {quant} (random, seeded)",
        "draft": f"checkpoints/draft_{model}_thin_fp16.npz ({draft_kind})",
        "reduced": None})
    if layers:
        about = {**about, "reduced": f"{CUT_FULL[tag]} -> {layers} layers: "
                 "the run's time limit, since the pipeline phase"}
    # Mixtral's expert products are cuBLAS GEMMs, told apart by name
    moe, moe_shared = (moe_gemm_names(eng)
                       if isinstance(eng.params, MixtralParams)
                       else (frozenset(), []))
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    eng.prefill(eng.init_state(), prompts[0])    # every prompt has one length
    torch.cuda.synchronize()
    prefill = counts(counters)
    expected = expected_per_round(eng)

    # turn 1: eager
    zero(counters)
    spec_out, req_s, rounds, new, _ = serve_turn(eng.generate, prompts,
                                                 new_tokens)
    launches = counts(counters)
    per_round = launches_per_round(tag, launches, prefill, len(prompts),
                                   rounds, expected)
    eager_mem = torch.cuda.max_memory_allocated()
    emit({"phase": "serve" + suffix, "card": smi, **about,
          "beam_head": type(eng.beam_head).__name__,
          "requests": len(prompts), "prompt_len": PROMPT_LEN,
          "new_tokens": new, "rounds": rounds,
          "accept_per_round": new / rounds, "tok_s": new / sum(req_s),
          "request_s": req_s, "param_build_s": params_s,
          "max_memory_allocated": eager_mem,
          "launches": launches, "prefill_launches": prefill,
          "launches_per_round": per_round,
          "round_ms": (sums := round_sums(tag, eng, kernel_rows,
                                          per_round))})
    missing = [n for n in ON_SPEC[tag] if launches[n] == 0]
    if missing:
        raise AssertionError(f"{tag}: generate never launched {missing}")

    # turns 2 and 3: fused (the first captures one graph), turn 4: eager
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f1_out, f1_s, f1_rounds, f1_new, f1_stats = serve_turn(
        eng.generate_fused, prompts, new_tokens)
    first_turn_s = time.perf_counter() - t0
    capture_s = sum(g.capture_s for g in graphs_of(eng, "spec"))
    zero(counters)
    f_out, f_s, f_rounds, f_new, f_stats = serve_turn(
        eng.generate_fused, prompts, new_tokens)
    f_launches = counts(counters)
    fused_mem = torch.cuda.max_memory_allocated()
    e2_out, e2_s, _, e2_new, _ = serve_turn(eng.generate, prompts, new_tokens)
    check_graph_launches(tag, eng, "spec", expected)
    f_per_round = launches_per_round(tag + " fused", f_launches, prefill,
                                     len(prompts), f_rounds, expected)
    missing = [n for n in ON_SPEC[tag] if f_launches[n] == 0]
    if missing:
        raise AssertionError(f"{tag}: generate_fused never launched "
                             f"{missing}")
    if not (f_out == spec_out == f1_out == e2_out and f_rounds == rounds
            and f1_rounds == rounds):
        raise AssertionError(f"{tag}: the fused stream differs from the "
                             "eager one")
    if any(st["kv_buckets_used"] != 1 for st in f_stats):
        raise AssertionError(f"{tag}: buckets engaged without kv_buckets")
    prof_eager = (profile_request(eng.generate, prompts[0], PROFILE_TOKENS,
                                  moe)
                  if tag in EAGER_PROFILED else None)
    prof_fused = confirmed_profile(tag + " fused", eng.generate_fused,
                                   prompts[0], PROFILE_TOKENS, f_per_round,
                                   prefill, moe)
    eager_tok_s = [new / sum(req_s), e2_new / sum(e2_s)]
    emit({"phase": "fused" + suffix, "card": smi,
          "turns": ["eager", "fused", "fused", "eager"],
          "turn_tok_s": [eager_tok_s[0], f1_new / first_turn_s,
                         f_new / sum(f_s), eager_tok_s[1]],
          "eager_tok_s": statistics.mean(eager_tok_s),
          "fused_tok_s": f_new / sum(f_s), "fused_request_s": f_s,
          "first_fused_turn_s": first_turn_s, "graph_capture_s": capture_s,
          "graphs": len(graphs_of(eng, "spec")),
          "rounds": f_rounds, "accept_per_round": f_new / f_rounds,
          "equal_to_eager": True,
          "launches": f_launches, "launches_per_replay": f_per_round,
          "expected_per_round": expected,
          "eager_device_idle_share": (prof_eager or {}).get(
              "device_idle_share"),
          "fused_device_idle_share": prof_fused["device_idle_share"],
          "eager_profile": prof_eager, "fused_profile": prof_fused,
          "moe_gemm_kernels": sorted(moe),
          "moe_gemm_kernels_shared_with_dense": moe_shared,
          "max_memory_allocated": fused_mem,
          "eager_max_memory_allocated": eager_mem})

    # lossless: greedy spec == greedy AR except at near-ties; AR eager then
    # fused twice (the first captures)
    zero(counters)
    ar_out, ar_s, _, ar_new, _ = serve_turn(eng.generate_ar, prompts,
                                            new_tokens)
    ar_launches = counts(counters)
    # generate_ar runs one base step per new token, after its prefill
    per_step = launches_per_round(tag + " AR", ar_launches, prefill,
                                  len(prompts), len(prompts) * new_tokens,
                                  expected_per_ar_step(eng))
    matches, faults = divergences(eng, prompts, spec_out, ar_out)
    emit({"phase": "lossless" + suffix, "card": smi,
          "match_fraction": matches,
          "first_divergences": faults, "ar_tok_s": ar_new / sum(ar_s),
          "ar_request_s": ar_s, "near_tie_gap": NEAR_TIE_GAP,
          "ar_launches": ar_launches, "ar_launches_per_step": per_step,
          "ar_step_ms": (ar_sums := ar_step_sums(tag, eng, kernel_rows,
                                                 per_step))})
    missing = [n for n in ON_AR[tag] if ar_launches[n] == 0]
    if missing:
        raise AssertionError(f"{tag}: generate_ar never launched {missing}")
    check_lossless(tag, faults)
    serve_turn(eng.generate_ar_fused, prompts[:1], new_tokens)
    capture_ar_s = sum(g.capture_s for g in graphs_of(eng, "ar"))
    zero(counters)
    far_out, far_s, _, far_new, _ = serve_turn(eng.generate_ar_fused,
                                               prompts, new_tokens)
    far_launches = counts(counters)
    check_graph_launches(tag + " AR", eng, "ar", expected_per_ar_step(eng))
    # both AR loops run one step a token (the last one's is not read)
    far_steps = launches_per_round(
        tag + " fused AR", far_launches, prefill, len(prompts),
        len(prompts) * new_tokens, expected_per_ar_step(eng))
    missing = [n for n in ON_AR[tag] if far_launches[n] == 0]
    if missing:
        raise AssertionError(f"{tag}: generate_ar_fused never launched "
                             f"{missing}")
    if far_out != ar_out:
        raise AssertionError(f"{tag}: the fused AR stream differs from the "
                             "eager one")
    # one AR step a token: the profile's "rounds" are its new tokens
    prof_ar = confirmed_profile(tag + " fused AR", eng.generate_ar_fused,
                                prompts[0], PROFILE_TOKENS, far_steps,
                                prefill, moe)
    emit({"phase": "fused_ar" + suffix, "card": smi,
          "ar_tok_s": ar_new / sum(ar_s),
          "fused_ar_tok_s": far_new / sum(far_s),
          "fused_ar_request_s": far_s, "graph_capture_s": capture_ar_s,
          "equal_to_eager": True, "launches": far_launches,
          "launches_per_replay": far_steps,
          "fused_ar_device_idle_share": prof_ar["device_idle_share"],
          "fused_ar_profile": prof_ar})
    return ({n: launches[n] + f_launches[n] + ar_launches[n]
             + far_launches[n] for n in counters}, sums, ar_sums,
            {"eager": (prof_eager or {}).get(
                "device_ms_per_round_by_family", {}),
             "fused": prof_fused["device_ms_per_round_by_family"]},
            (eng, prompts, ar_out))


def bucket_and_force_runs(eng, prompts, ar_out, smi):
    """At 7B int8: generate_fused with kv_buckets=(128,) (max_seq_len 216:
    buckets 128 -> 216, base KV 256 -> 512 rows, two graphs), lossless
    against AR under the near-tie rule, and a shorter request that reuses
    those graphs; and force_accept=3, whose accepted
    tokens a round must reach 2.5."""
    import dataclasses
    from flowspec_tpu_torch.runtime import SpecEngine
    new_tokens = CONFIGS["7b_int8"][3]
    beng = SpecEngine(eng.params, eng.draft,
                      dataclasses.replace(eng.cfg, kv_buckets=(128,)))
    b_out, b_s, b_rounds, b_new, b_stats = serve_turn(
        beng.generate_fused, prompts, new_tokens)
    used = [st["kv_buckets_used"] for st in b_stats]
    rows = sorted(k[1] for k in beng._graphs if k[0] == "spec")
    matches, faults = divergences(eng, prompts, b_out, ar_out)
    # graphs are keyed by bucket alone: another length captures none
    n_graphs = len(beng._graphs)
    serve_turn(beng.generate_fused, prompts[:1], new_tokens // 2)
    emit({"phase": "buckets", "card": smi, "kv_buckets": [128],
          "max_seq_len": eng.cfg.max_seq_len,
          "plan": beng._plan_buckets(PROMPT_LEN, new_tokens),
          "base_rows_of_graphs": rows, "kv_buckets_used": used,
          "graphs": n_graphs,
          "graphs_after_a_shorter_request": len(beng._graphs),
          "tok_s": b_new / sum(b_s), "request_s": b_s, "rounds": b_rounds,
          "graph_capture_s": sum(g.capture_s for g in beng._graphs.values()),
          "match_fraction": matches, "first_divergences": faults,
          "near_tie_gap": NEAR_TIE_GAP})
    if used != [2] * len(prompts) or rows != [256, 512]:
        raise AssertionError(f"buckets: {used} buckets used, graphs of "
                             f"{rows} rows")
    if len(beng._graphs) != n_graphs:
        raise AssertionError("buckets: a shorter request captured another "
                             "graph")
    check_lossless("7b_int8 buckets", faults)
    del beng
    feng = SpecEngine(eng.params, eng.draft,
                      dataclasses.replace(eng.cfg, force_accept=3))
    _, f_s, f_rounds, f_new, _ = serve_turn(feng.generate_fused, prompts[:1],
                                            new_tokens)
    emit({"phase": "force_accept", "card": smi, "force_accept": 3,
          "accept_per_round": f_new / f_rounds, "rounds": f_rounds,
          "tok_s": f_new / sum(f_s)})
    if f_new / f_rounds < 2.5:
        raise AssertionError(f"force_accept=3: {f_new / f_rounds} a round")


def make_batched_engine(dev):
    """(BatchedSpecEngine over BATCH lanes, its 4 prompts, build seconds):
    7B int8 at full width and depth and the committed thin draft in int8,
    as `make_engine` builds them, max_seq_len BATCH_MAX_SEQ, adapt_tree on
    (32-node trees a lane)."""
    import dataclasses
    from flowspec_tpu_torch.runtime import BatchedSpecEngine
    eng, prompts, build_s = make_engine(dev, "7b", "int8", BATCH, NEW_TOKENS)
    beng = BatchedSpecEngine(
        eng.params, eng.draft,
        dataclasses.replace(eng.cfg, max_seq_len=BATCH_MAX_SEQ),
        batch_size=BATCH)
    return beng, prompts, build_s


def batch_turn(fn, prompts, new_tokens, **kw):
    """One batched call: (outputs past the prompts, seconds, stats)."""
    import torch
    t0 = time.perf_counter()
    outs, stats = fn(prompts, max_new_tokens=new_tokens, eos_token_id=-1,
                     **kw)
    torch.cuda.synchronize()
    return ([o[len(p):] for o, p in zip(outs, prompts)],
            time.perf_counter() - t0, stats)


def random_prompts(vocab, lengths, seed):
    import torch
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(3, vocab, (n,), generator=rng).tolist()
            for n in lengths]


def batched_config(dev, counters, smi):
    """The batched phase (module docstring, 9) in its own process: returns
    its launches over the counted turns and the profiled fused batch
    request's device ms a round by family. Raises if fused lanes differ
    from eager ones, if a lane or a served request leaves its AR stream
    (or a lane its solo stream, or a prefixed stream the prefix-less one)
    off a near-tie, if a batched round or replay launches other than one
    lane's round, if the prefix saves no rounds, if a conversation does not
    resume, or if a second serve captures a graph."""
    import torch
    from flowspec_tpu_torch.runtime import ConversationStore
    beng, prompts, params_s = make_batched_engine(dev)
    mc = beng.cfg.model
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    beng.prefill(beng.init_state(), prompts[0])
    torch.cuda.synchronize()
    prefill = counts(counters)
    expected = expected_per_round(beng)
    b = len(prompts)
    total = {n: 0 for n in counters}

    def add(c):
        for n in total:
            total[n] += c[n]

    # eager, fused (captures), then B 4 / B 1 fused in turns, then eager
    zero(counters)
    e_out, e_s, e_stats = batch_turn(beng.generate_batch, prompts,
                                     NEW_TOKENS)
    e_launches = counts(counters)
    add(e_launches)
    per_round = launches_per_round("batched", e_launches, prefill, b,
                                   e_stats["rounds"], expected)
    t0 = time.perf_counter()
    f1_out, _, f1_stats = batch_turn(beng.generate_batch_fused, prompts,
                                     NEW_TOKENS)
    first_fused_s = time.perf_counter() - t0
    serve_turn(beng.generate_fused, prompts[:1], NEW_TOKENS)  # B 1 capture
    capture_s = sum(g.capture_s for g in graphs_of(beng, "lanes"))
    zero(counters)
    f_out, f_s, f_stats = batch_turn(beng.generate_batch_fused, prompts,
                                     NEW_TOKENS)
    f_launches = counts(counters)
    add(f_launches)
    solo_out, solo_s, _, solo_new, _ = serve_turn(beng.generate_fused,
                                                  prompts, NEW_TOKENS)
    _, solo2_s, _, solo2_new, _ = serve_turn(beng.generate_fused, prompts,
                                             NEW_TOKENS)
    f2_out, f2_s, _ = batch_turn(beng.generate_batch_fused, prompts,
                                 NEW_TOKENS)
    e2_out, e2_s, _ = batch_turn(beng.generate_batch, prompts, NEW_TOKENS)
    check_graph_launches("batched", beng, "lanes", expected)
    f_per_round = launches_per_round("batched fused", f_launches, prefill,
                                     b, f_stats["rounds"], expected)
    if not (f_out == e_out == f1_out == f2_out == e2_out
            and f_stats["rounds"] == e_stats["rounds"]
            == f1_stats["rounds"]):
        raise AssertionError("batched: fused lanes differ from eager ones")
    new = e_stats["new_tokens"]
    batch_mem = torch.cuda.max_memory_allocated()
    emit({"phase": "batched", "card": smi,
          "model": "llama_7b int8 (random, seeded)",
          "draft": "checkpoints/draft_7b_thin_fp16.npz (int8)",
          "reduced": None, "lanes": b, "tree": {
              "total_tokens": beng.cfg.tree.total_tokens,
              "node_cap": beng.cfg.tree.node_cap,
              "depth_cap": beng.cfg.tree.depth_cap},
          "max_seq_len": beng.cfg.max_seq_len,
          "base_kv_rows": beng.base_kv_len, "prompt_len": PROMPT_LEN,
          "new_tokens": new, "rounds": e_stats["rounds"],
          "accept_per_lane_round": new / (e_stats["rounds"] * b),
          "turns": ["eager", "fused", "B1 fused", "B1 fused", "fused",
                    "eager"],
          "eager_tok_s": [new / e_s, new / e2_s],
          "fused_tok_s": [new / f_s, new / f2_s],
          "b1_fused_tok_s": [solo_new / sum(solo_s),
                             solo2_new / sum(solo2_s)],
          "first_fused_s": first_fused_s, "graph_capture_s": capture_s,
          "equal_to_eager": True, "param_build_s": params_s,
          "launches": e_launches, "prefill_launches": prefill,
          "launches_per_round": per_round,
          "fused_launches_per_replay": f_per_round,
          "expected_per_round": expected,
          "max_memory_allocated": batch_mem})

    # lossless: every lane against its AR stream and its solo stream
    ar_out, ar_s, _, ar_new, _ = serve_turn(beng.generate_ar_fused, prompts,
                                            NEW_TOKENS)
    matches, faults = divergences(beng, prompts, e_out, ar_out)
    s_matches, s_faults = divergences(beng, prompts, e_out, solo_out)
    emit({"phase": "batched_lossless", "card": smi,
          "match_fraction_vs_ar": matches, "first_divergences_vs_ar": faults,
          "match_fraction_vs_solo": s_matches,
          "first_divergences_vs_solo": s_faults,
          "lanes_off_their_solo_stream": len(s_faults),
          "near_tie_gap": NEAR_TIE_GAP, "ar_tok_s": ar_new / sum(ar_s)})
    check_lossless("batched vs AR", faults)
    check_lossless("batched vs solo", s_faults)

    # serve: 8 requests, different budgets, fifo then lpt
    sprompts = random_prompts(mc.vocab_size, [PROMPT_LEN] * 8, SEED + 1)
    s_ar = [beng.generate_ar_fused(p, max_new_tokens=m, eos_token_id=-1)[0][
        len(p):] for p, m in zip(sprompts, SERVE_BUDGETS)]
    beng.serve(sprompts[:2], max_new_tokens=4, eos_token_id=-1)  # capture
    serve_graphs = dict(beng._graphs)
    serve_lines = {}
    for policy in ("fifo", "lpt"):
        zero(counters)
        out, sec, st = batch_turn(beng.serve, sprompts, SERVE_BUDGETS,
                                  queue_order=policy)
        launches = counts(counters)
        add(launches)
        if any(launches[n] != st["rounds"] * expected.get(n, 0)
               for n in launches):
            raise AssertionError(f"batched serve {policy}: {launches} over "
                                 f"{st['rounds']} rounds, expected "
                                 f"{expected} a round")
        m, fl = divergences(beng, sprompts, out, s_ar)
        check_lossless(f"batched serve {policy}", fl)
        serve_lines[policy] = {
            "tok_s": st["new_tokens"] / sec, "seconds": sec,
            "rounds": st["rounds"], "per_request": st["per_request"],
            "latency_rounds": st["latency_rounds"],
            "admit_rounds": st["admit_rounds"],
            "slot_utilization": st["slot_utilization"],
            "accept_per_round": st["accept_per_round"],
            "match_fraction_vs_ar": m, "first_divergences_vs_ar": fl}
    check_graph_launches("batched serve", beng, "serve", expected)
    if beng._graphs != serve_graphs:
        raise AssertionError("batched serve: a second serve captured a "
                             "graph")
    emit({"phase": "batched_serve", "card": smi, "requests": 8,
          "budgets": SERVE_BUDGETS, "prompt_len": PROMPT_LEN,
          "serve_graphs": len(graphs_of(beng, "serve")),
          "serve_capture_s": sum(g.capture_s
                                 for g in graphs_of(beng, "serve")),
          **serve_lines})

    # shared prefix: 192 tokens, 8 suffixes of 16-48
    prefix = random_prompts(mc.vocab_size, [PREFIX_LEN], SEED + 2)[0]
    pprompts = [prefix + sfx for sfx in random_prompts(
        mc.vocab_size, PREFIX_SUFFIXES, SEED + 3)]
    plain, plain_s, plain_st = batch_turn(beng.serve, pprompts, PREFIX_NEW)
    t0 = time.perf_counter()
    beng._prefix_template(prefix, SEED)
    template_s = time.perf_counter() - t0
    zero(counters)
    pre, pre_s, pre_st = batch_turn(beng.serve, pprompts, PREFIX_NEW,
                                    shared_prefix=prefix)
    add(counts(counters))
    m, fl = divergences(beng, pprompts, pre, plain)
    emit({"phase": "batched_prefix", "card": smi, "prefix_len": PREFIX_LEN,
          "suffix_lens": PREFIX_SUFFIXES, "new_tokens": PREFIX_NEW,
          "rounds_without_prefix": plain_st["rounds"],
          "rounds_with_prefix": pre_st["rounds"],
          "tok_s_without_prefix": plain_st["new_tokens"] / plain_s,
          "tok_s_with_prefix": pre_st["new_tokens"] / pre_s,
          "template_s": template_s,
          "latency_rounds_without_prefix": plain_st["latency_rounds"],
          "latency_rounds_with_prefix": pre_st["latency_rounds"],
          "match_fraction_vs_prefixless": m,
          "first_divergences_vs_prefixless": fl})
    check_lossless("batched prefix", fl)
    if pre_st["rounds"] >= plain_st["rounds"]:
        raise AssertionError("batched prefix: no rounds saved")

    # two conversations, two turns through a ConversationStore
    store = ConversationStore()
    ids = ["a", "b"]
    t1 = prompts[:2]
    o1, _, st1 = batch_turn(beng.serve, t1, CONV_NEW, conversations=store,
                            conversation_ids=ids, rounds_per_dispatch=16)
    extras = random_prompts(mc.vocab_size, [CONV_EXTRA] * 2, SEED + 4)
    t2 = [p + o + x for p, o, x in zip(t1, o1, extras)]
    o2, _, st2 = batch_turn(beng.serve, t2, CONV_NEW, conversations=store,
                            conversation_ids=ids, rounds_per_dispatch=16)
    refs, how = [], []
    for p, o, x, full in zip(t1, o1, extras, t2):
        hist, _, state = beng.generate(p, max_new_tokens=CONV_NEW,
                                       eos_token_id=-1, return_state=True)
        if hist == p + o:
            ref, _ = beng.resume_and_generate(state, hist, x,
                                              max_new_tokens=CONV_NEW,
                                              eos_token_id=-1)
            how.append("resume_and_generate")
        else:             # turn 1 left the solo stream at a near-tie
            ref, _ = beng.generate(full, max_new_tokens=CONV_NEW,
                                   eos_token_id=-1)
            how.append("generate over the whole turn-2 prompt")
        refs.append(ref[len(full):])
    m, fl = divergences(beng, t2, o2, refs)
    emit({"phase": "batched_conversation", "card": smi, "conversations": 2,
          "turn_new_tokens": CONV_NEW, "extra_tokens": CONV_EXTRA,
          "resumed_turns": st2.get("resumed_turns"),
          "turn1_rounds": st1["rounds"], "turn2_rounds": st2["rounds"],
          "turn2_latency_rounds": st2["latency_rounds"],
          "reference": how, "match_fraction": m, "first_divergences": fl})
    check_lossless("batched conversation", fl)
    if st2.get("resumed_turns") != 2:
        raise AssertionError(f"batched conversation: {st2}")

    # one fused batch request and one solo fused request under the profiler
    prefill_b = {n: b * c for n, c in prefill.items()}
    prof = confirmed_profile(
        "batched fused",
        lambda p, max_new_tokens, eos_token_id: beng.generate_batch_fused(
            prompts, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id),
        prompts[0], PROFILE_TOKENS, f_per_round, prefill_b)
    prof_solo = confirmed_profile("batched solo fused", beng.generate_fused,
                                  prompts[0], PROFILE_TOKENS, f_per_round,
                                  prefill)
    emit({"phase": "batched_profile", "card": smi,
          "batch_fused_profile": prof, "solo_fused_profile": prof_solo,
          "batch_device_idle_share": prof["device_idle_share"],
          "solo_device_idle_share": prof_solo["device_idle_share"],
          "batch_kernels_per_round": prof["kernels_per_round"],
          "solo_kernels_per_round": prof_solo["kernels_per_round"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "kv_bytes_a_lane": 2 * beng.base_kv_len * mc.num_hidden_layers
          * mc.num_key_value_heads * mc.head_dim_ * 2})
    # only a fused batch request was profiled: no eager numbers
    return total, {"fused": prof["device_ms_per_round_by_family"]}


def stream_workload(vocab):
    """The open-loop stream: STREAM_REQUESTS 64-token prompts, budgets
    uniform in 32-192 and Poisson arrivals at STREAM_RATE a second (the
    first at 0), all from seeded generators."""
    import torch
    g = torch.Generator().manual_seed(SEED + 5)
    prompts = random_prompts(vocab, [PROMPT_LEN] * STREAM_REQUESTS, SEED + 5)
    budgets = torch.randint(32, 193, (STREAM_REQUESTS,), generator=g).tolist()
    gaps = torch.empty(STREAM_REQUESTS, dtype=torch.float64).exponential_(
        STREAM_RATE, generator=g)
    arrivals = (torch.cumsum(gaps, 0) - gaps[0]).tolist()
    return prompts, budgets, arrivals


class ReplayTally:
    """Counts the serve rounds of each (width, tree nodes) while open, by
    wrapping `ServeLanes.replay`, and the request each preemption pauses
    (the lane's request before `_run_boundary` snapshots it)."""

    def __init__(self, engines):
        from flowspec_tpu_torch.runtime import graphs
        self.graphs, self.rounds, self.paused = graphs, {}, []
        self.replay = graphs.ServeLanes.replay
        tally = self

        def replay(lanes, eng, tree_cfg):
            key = f"w{lanes.key[3]}_n{tree_cfg.node_cap}"
            tally.rounds[key] = tally.rounds.get(key, 0) + 1
            return tally.replay(lanes, eng, tree_cfg)
        graphs.ServeLanes.replay = replay
        for eng in engines:
            boundary = eng._run_boundary

            def run(r, plan, queue, boundary=boundary):
                if plan.get("pause_idx", -1) >= 0:
                    tally.paused.append(int(r.loop.req[plan["pause_idx"]]))
                return boundary(r, plan, queue)
            eng._run_boundary = run

    def take(self):
        out, self.rounds, self.paused = (self.rounds, self.paused), {}, []
        return out


def buffer_ptrs(eng):
    """{serve buffers key: the data_ptr of every state and loop tensor}."""
    from flowspec_tpu_torch.runtime import graphs
    return {str(k): [t.data_ptr() for t in graphs._fields(sl.state)]
            + [t.data_ptr() for t in graphs._fields(sl.loop)]
            for k, sl in eng._serve_sets.items()}


def graphs_share_buffers(eng) -> int:
    """Raises unless every serve graph reads its width's buffers (the same
    data_ptr for every state and loop tensor); returns the graph count."""
    from flowspec_tpu_torch.runtime import graphs
    ptrs = buffer_ptrs(eng)
    n = 0
    for k, g in eng._graphs.items():
        if k[0] != "serve":
            continue
        mine = ([t.data_ptr() for t in graphs._fields(g.state)]
                + [t.data_ptr() for t in graphs._fields(g.loop)])
        if mine != ptrs[str(k[:5])]:
            raise AssertionError(f"stream: graph {k[:5]} nodes "
                                 f"{k[5].node_cap} has buffers of its own")
        n += 1
    return n


def stream_turn(eng, counters, expected, tally, prompts, arrivals, budgets,
                strict=True, **kw):
    """One timed serve_stream after `warmup`: (outputs past the prompts,
    seconds, stats, launches, rounds by (width, nodes), paused requests).
    Raises if the run captured a graph, or (strict) if its launches are not
    its rounds x the launches a round implies."""
    import torch
    eng.warmup(n_requests=len(prompts))
    n_graphs = len(eng._graphs)
    torch.cuda.synchronize()
    zero(counters)
    tally.take()
    t0 = time.perf_counter()
    outs, st = eng.serve_stream(prompts, arrivals, max_new_tokens=budgets,
                                eos_token_id=-1,
                                rounds_per_dispatch=STREAM_K, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = counts(counters)
    if len(eng._graphs) != n_graphs:
        raise AssertionError("stream: a timed serve_stream captured a graph")
    want = {n: st["rounds"] * expected.get(n, 0) for n in launches}
    bad = {n: c for n, c in launches.items()
           if (c != want[n] if strict else c < want[n] or
               (want[n] == 0 and c))}
    if bad:
        raise AssertionError(f"stream: {bad} launches over {st['rounds']} "
                             f"rounds, expected {expected} a round")
    by_shape, paused = tally.take()
    return ([o[len(p):] for o, p in zip(outs, prompts)], sec, st, launches,
            by_shape, paused)


def stream_line(sec, st):
    keys = ("new_tokens", "rounds", "admission_p50_s", "admission_p95_s",
            "completion_p50_s", "completion_p95_s", "slot_utilization",
            "accept_per_round", "width_switches", "min_width",
            "preemptions", "preempt_cost_skips")
    return {"seconds": sec, "tok_s": st["new_tokens"] / sec,
            **{k: st[k] for k in keys}}


def stream_config(dev, counters, smi):
    """The stream phase (module docstring, 10) in its own process: returns
    its launches over the timed runs. Raises if a stream leaves its AR
    stream off a near-tie (the cold-prefix streams: the prefix-less
    stream), if a timed run captures a graph or launches other than its
    rounds imply, if the dynamic engine never narrows (min_width 4, or
    fewer than 2 width switches), if no preemption fires, or if a serve
    graph or a buffer moved off its width's buffers."""
    import dataclasses
    import torch
    from flowspec_tpu_torch.runtime import BatchedSpecEngine
    eng, _, params_s = make_engine(dev, "7b", "int8", 1, NEW_TOKENS)
    cfg = dataclasses.replace(eng.cfg, max_seq_len=STREAM_MAX_SEQ)
    static = BatchedSpecEngine(eng.params, eng.draft, cfg, batch_size=BATCH)
    dyn = BatchedSpecEngine(eng.params, eng.draft, cfg, batch_size=BATCH,
                            dynamic_tree=True, dynamic_batch=True)
    del eng
    mc = static.cfg.model
    expected = expected_per_round(static)
    if expected != expected_per_round(dyn):
        raise AssertionError("stream: the engines' rounds launch apart")
    tally = ReplayTally((static, dyn))
    total = {n: 0 for n in counters}

    def add(c):
        for n in total:
            total[n] += c[n]

    prompts, budgets, arrivals = stream_workload(mc.vocab_size)
    # AR references, the preemption run's long requests to their budget
    ar_budgets = [max(m, PREEMPT_LONG if i < 4 else 0)
                  for i, m in enumerate(budgets)]
    t0 = time.perf_counter()
    ar = [static.generate_ar_fused(p, max_new_tokens=m, eos_token_id=-1)[0][
        len(p):] for p, m in zip(prompts, ar_budgets)]
    ar_s = time.perf_counter() - t0

    # open loop, in turns: static, dynamic, dynamic, static
    turns = {"static": [], "dynamic": []}
    t_warm = time.perf_counter()
    static.warmup(n_requests=STREAM_REQUESTS)
    dyn.warmup(n_requests=STREAM_REQUESTS)
    warm_s = time.perf_counter() - t_warm
    ptrs = buffer_ptrs(dyn)
    for side, e in (("static", static), ("dynamic", dyn),
                    ("dynamic", dyn), ("static", static)):
        outs, sec, st, launches, by_shape, _ = stream_turn(
            e, counters, expected, tally, prompts, arrivals, budgets)
        add(launches)
        m, fl = divergences(e, prompts, outs,
                            [a[:n] for a, n in zip(ar, budgets)])
        check_lossless(f"stream {side}", fl)
        turns[side].append({**stream_line(sec, st),
                            "rounds_by_width_nodes": by_shape,
                            "match_fraction_vs_ar": m,
                            "first_divergences_vs_ar": fl})
    for t in turns["dynamic"]:
        if t["min_width"] >= BATCH or t["width_switches"] < 2:
            raise AssertionError(f"stream dynamic: never narrowed: {t}")
    if buffer_ptrs(dyn) != ptrs:
        raise AssertionError("stream: a serve buffer moved")
    n_dyn_graphs = graphs_share_buffers(dyn)
    emit({"phase": "stream", "card": smi,
          "model": "llama_7b int8 (random, seeded)",
          "draft": "checkpoints/draft_7b_thin_fp16.npz (int8)",
          "reduced": None, "lanes": BATCH, "max_seq_len": STREAM_MAX_SEQ,
          "base_kv_rows": [static.base_kv_len, dyn.base_kv_len],
          "requests": STREAM_REQUESTS, "rate_per_s": STREAM_RATE,
          "prompt_len": PROMPT_LEN, "budgets": budgets,
          "arrivals_s": arrivals, "rounds_per_dispatch": STREAM_K,
          "static_tree_nodes": static.cfg.tree.node_cap,
          "dynamic_tree_nodes": {n: tc.node_cap for n, tc
                                 in dyn._tree_variants.items()},
          "turns": ["static", "dynamic", "dynamic", "static"],
          "static": turns["static"], "dynamic": turns["dynamic"],
          "warmup_s": warm_s, "dynamic_serve_graphs": n_dyn_graphs,
          "graphs_share_width_buffers": True, "buffers_unmoved": True,
          "ar_reference_s": ar_s, "param_build_s": params_s})

    # preemption: 4 long requests, then 4 short ones from 0.3 s on
    pp = prompts[:8]
    pb = [PREEMPT_LONG] * 4 + [PREEMPT_SHORT] * 4
    pa = [0.0] * 4 + [0.3 + 0.05 * i for i in range(4)]
    outs, sec, st, launches, by_shape, paused = stream_turn(
        static, counters, expected, tally, pp, pa, pb,
        preempt_factor=PREEMPT_FACTOR)
    add(launches)
    m, fl = divergences(static, pp, outs, [a[:n] for a, n in zip(ar, pb)])
    emit({"phase": "stream_preempt", "card": smi, "budgets": pb,
          "arrivals_s": pa, "preempt_factor": PREEMPT_FACTOR,
          **stream_line(sec, st), "completion_s": st["completion_s"],
          "paused_requests": paused,
          "paused_match_fraction_vs_ar": [m[i] for i in paused],
          "match_fraction_vs_ar": m, "first_divergences_vs_ar": fl})
    check_lossless("stream preempt", fl)
    if st["preemptions"] < 1:
        raise AssertionError(f"stream preempt: no preemption: {st}")

    # a cold shared prefix built in a thread beside serving
    prefix = random_prompts(mc.vocab_size, [PREFIX_LEN], SEED + 6)[0]
    op = [prefix + sfx for sfx in random_prompts(
        mc.vocab_size, PREFIX_SUFFIXES, SEED + 7)]
    oa = [OVERLAP_GAP * i for i in range(OVERLAP_REQUESTS)]
    ob = [OVERLAP_NEW] * OVERLAP_REQUESTS
    plain, p_sec, p_st, launches, _, _ = stream_turn(
        dyn, counters, expected, tally, op, oa, ob)
    add(launches)
    cold = dyn._prefix_templates.copy()
    outs, sec, st, launches, by_shape, _ = stream_turn(
        dyn, counters, expected, tally, op, oa, ob, strict=False,
        shared_prefix=prefix, prefix_overlap=True)
    add(launches)
    if len(dyn._prefix_templates) != len(cold) + 1:
        raise AssertionError("stream overlap: the template was not cold")
    m, fl = divergences(dyn, op, outs, plain)
    other = random_prompts(mc.vocab_size, [PREFIX_LEN], SEED + 8)[0]
    t0 = time.perf_counter()
    dyn._prefix_template(other, SEED)       # a build alone, for its time
    torch.cuda.synchronize()
    template_s = time.perf_counter() - t0
    emit({"phase": "stream_overlap", "card": smi, "prefix_len": PREFIX_LEN,
          "suffix_lens": PREFIX_SUFFIXES, "new_tokens": OVERLAP_NEW,
          "arrivals_s": oa, "template_alone_s": template_s,
          "without_prefix": stream_line(p_sec, p_st),
          "cold_overlap": stream_line(sec, st),
          "rounds_by_width_nodes": by_shape,
          "match_fraction_vs_prefixless": m,
          "first_divergences_vs_prefixless": fl})
    check_lossless("stream overlap", fl)
    graphs_share_buffers(dyn)

    # one host admission (_run_boundary) against one serve replay
    lanes = static._serve_lanes(BATCH, static._queue_pad(STREAM_REQUESTS))
    tree = static.cfg.tree
    tpl, _ = static._prefix_template(prefix, SEED)

    def admit(tstate):
        plan = dict(src_sel=[2] + [0] * (BATCH - 1),
                    fresh_qpos=[0] + [-1] * (BATCH - 1),
                    fresh_sfx=[int(op[0][PREFIX_LEN]) if tstate else -1]
                    + [-1] * (BATCH - 1), fresh_seed=[SEED] * BATCH,
                    fresh_pos=[PREFIX_LEN if tstate else 0] * BATCH,
                    pause_idx=-1, parked=None, tstate=tstate)
        queue = (lanes.loop.q_prompts, lanes.loop.q_lens,
                 lanes.loop.q_budgets)
        static._run_boundary(lanes, plan, queue)
        torch.cuda.synchronize()

    def wall_ms(fn, n=20):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    emit({"phase": "stream_boundary", "card": smi, "lanes": BATCH,
          "tree_nodes": tree.node_cap,
          "serve_replay_ms": wall_ms(lambda: lanes.replay(static, tree)),
          "admission_ms": wall_ms(lambda: admit(None)),
          "admission_with_prefix_ms": wall_ms(lambda: admit(tpl)),
          "what": "host wall ms, synchronized: one serve replay (a round "
                  "with its pinned read) against one _run_boundary admitting "
                  "one lane (zero template; prefix template with its KV "
                  "rows)"})
    return total


def pipe_line(eng, sched, outs, sec, new, stats, launches, reads, peak):
    """One schedule's record: tok/s over its requests, rounds, turns, skips,
    ne_fires, accepted tokens a round, host wall ms and flag reads a turn,
    launches a turn, peak device memory."""
    turns = sum(s["turns"] for s in stats)
    rounds = sum(s["rounds"] for s in stats)
    return {"schedule": sched, "tok_s": new / sum(sec),
            "request_s": sec, "new_tokens": new, "rounds": rounds,
            "turns": turns, "turns_per_round": turns / rounds,
            "skips": sum(s["skips"] for s in stats),
            "ne_fires": sum(s["ne_fires"] for s in stats),
            "accept_per_round": new / rounds,
            "wall_ms_per_turn": sum(sec) * 1e3 / turns,
            "host_reads_per_turn": reads / turns,
            "launches_per_turn": {k: n / turns for k, n in launches.items()
                                  if n},
            "c_buf": eng.c_buf, "peak_gb": peak / 1e9}


def profile_turns(fn, prompt, new_tokens) -> dict:
    """One pipeline request through `fn` under torch.profiler, device
    activity only, read from `key_averages` (a turn launches ~2.5k kernels;
    walking every CPU and device event of a 128-token request took ~370 s):
    wall and device ms a turn, the idle share, kernels a turn, and device ms
    and kernels a turn by family. A trace without device time fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = fn(prompt, max_new_tokens=new_tokens, eos_token_id=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    turns = stats["turns"]
    ms, n, busy, kernels = {}, {}, 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        fam = family(ev.key)
        ms[fam] = ms.get(fam, 0.0) + us / 1e3 / turns
        n[fam] = n.get(fam, 0) + ev.count / turns
        busy += us / 1e6
        kernels += ev.count
    if not kernels:
        raise AssertionError("profile_turns: no device kernel in the trace")
    return {"turns": turns, "rounds": stats["rounds"], "wall_s": wall,
            "wall_ms_per_turn": wall * 1e3 / turns,
            "device_ms_per_turn": busy * 1e3 / turns,
            "device_idle_share": 1 - busy / wall,
            "kernels_per_turn": kernels / turns,
            "device_ms_per_turn_by_family": ms,
            "kernels_per_turn_by_family": n}


def pipe_config(mc, new_tokens: int = NEW_TOKENS):
    """The pipeline phases' EngineConfig: the JAX TreeConfig defaults with
    score_temperature 0.2, 4 stages x 8 layers, max_seq PIPE_MAX_SEQ."""
    from flowspec_tpu_torch.config import (
        EngineConfig, SamplingConfig, StageTopology, TreeConfig)
    return EngineConfig(model=mc, tree=TreeConfig(score_temperature=0.2),
                        sampling=SamplingConfig(), max_new_tokens=new_tokens,
                        max_seq_len=PIPE_MAX_SEQ, topology=StageTopology())


def pipeline_config(dev, counters, smi):
    """The pipeline phase in its own process: the 7B int8 pair through
    `PipelineEngine` (4 stages x 8 layers on the card), every schedule
    through `generate` on the serve prompts, continuous also through
    `generate_fused`, beside `SpecEngine.generate_fused` on the same pair
    and tree in turns (before and after); one resume; one profiled
    continuous request. Returns its launches. Raises if a stream leaves its
    AR stream off a near-tie, if generate_fused differs from generate, if
    the resumed stream differs from the fresh one off a near-tie, if a run
    launched no int8, attention or head kernel, or if a turn read more than
    three flag vectors."""
    import torch
    from flowspec_tpu_torch.parallel import PipelineEngine
    from flowspec_tpu_torch.runtime import SpecEngine
    base, prompts, params_s = make_engine(dev, "7b", "int8", N_REQUESTS,
                                          NEW_TOKENS)
    mc = base.cfg.model
    cfg = pipe_config(mc)
    spec = SpecEngine(base.params, base.draft, cfg)
    del base
    total = {n: 0 for n in counters}

    def turn(fn):
        zero(counters)
        torch.cuda.reset_peak_memory_stats()
        outs, sec, rounds, new, stats = serve_turn(fn, prompts, NEW_TOKENS)
        launches = counts(counters)
        for n in total:
            total[n] += launches[n]
        missing = [k for k in ("int8_matmul", "tree_attention", "head_topk")
                   if launches[k] == 0]
        if missing:
            raise AssertionError(f"pipeline: no launch of {missing}")
        return outs, sec, rounds, new, stats, launches, \
            torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    ar = [spec.generate_ar_fused(p, max_new_tokens=NEW_TOKENS,
                                 eos_token_id=-1)[0][len(p):]
          for p in prompts]
    ar_s = time.perf_counter() - t0
    yard = []
    for _ in range(2):          # the first turn captures the graph
        outs, sec, rounds, new, _, _, peak = turn(spec.generate_fused)
        yard.append({"tok_s": new / sum(sec), "rounds": rounds,
                     "accept_per_round": new / rounds, "request_s": sec,
                     "peak_gb": peak / 1e9})
    spec_outs = outs

    lines, engines = [], {}
    for sched in PIPE_SCHEDULES:
        eng = PipelineEngine(spec.params, spec.draft, cfg, schedule=sched)
        reads = eng.reads.count
        outs, sec, _, new, stats, launches, peak = turn(eng.generate)
        line = pipe_line(eng, sched, outs, sec, new, stats, launches,
                         eng.reads.count - reads, peak)
        if line["host_reads_per_turn"] > 3:
            raise AssertionError(f"pipeline {sched}: {line}")
        m, fl = divergences(spec, prompts, outs, ar)
        line.update(match_fraction_vs_ar=m, first_divergences_vs_ar=fl)
        lines.append(line)
        check_lossless(f"pipeline {sched}", fl)
        if sched == "continuous":
            cont, cont_outs = eng, outs
        del eng

    eng = cont
    reads = eng.reads.count
    fouts, fsec, _, fnew, fstats, flaunches, fpeak = turn(eng.generate_fused)
    fused = pipe_line(eng, "continuous", fouts, fsec, fnew, fstats,
                      flaunches, eng.reads.count - reads, fpeak)
    if fouts != cont_outs:
        raise AssertionError("pipeline: generate_fused != generate")
    outs, sec, rounds, new, _, _, peak = turn(spec.generate_fused)
    yard.append({"tok_s": new / sum(sec), "rounds": rounds,
                 "accept_per_round": new / rounds, "request_s": sec,
                 "peak_gb": peak / 1e9})
    if outs != spec_outs:
        raise AssertionError("pipeline: SpecEngine's turns differ")
    emit({"phase": "pipeline", "card": smi,
          "model": "llama_7b int8 (random, seeded)",
          "draft": "checkpoints/draft_7b_thin_fp16.npz (int8)",
          "reduced": None, "stages": list(eng.layer_split),
          "tree": "TreeConfig() defaults, score_temperature 0.2",
          "max_seq_len": PIPE_MAX_SEQ, "base_kv_rows": eng.base_rows,
          "draft_kv_rows": eng.draft_rows, "prompt_len": PROMPT_LEN,
          "requests": len(prompts), "new_tokens": NEW_TOKENS,
          "schedules": lines, "continuous_fused": fused,
          "fused_equals_generate": True,
          "spec_engine_generate_fused": yard,
          "turns_order": ["spec fused", "spec fused"] + list(PIPE_SCHEDULES)
          + ["continuous fused", "spec fused"],
          "ar_reference_s": ar_s, "param_build_s": params_s})

    # one resume turn against a fresh run on the whole history
    first, extra_n, second = PIPE_RESUME
    p = prompts[0]
    out1, _, st = eng.generate(p, max_new_tokens=first, eos_token_id=-1,
                               return_state=True)
    extra = random_prompts(mc.vocab_size, [extra_n], SEED + 9)[0]
    zero(counters)
    t0 = time.perf_counter()
    resumed, rstats = eng.resume_and_generate(st, out1, extra,
                                              max_new_tokens=second,
                                              eos_token_id=-1)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = counts(counters)
    for n in total:
        total[n] += launches[n]
    hist = out1 + extra
    fresh, _ = eng.generate(hist, max_new_tokens=second, eos_token_id=-1)
    m, fl = divergences(spec, [hist], [resumed[len(hist):]],
                        [fresh[len(hist):]])
    emit({"phase": "pipeline_resume", "card": smi, "history": len(out1),
          "extra": extra_n, "new_tokens": second, "resume_s": resume_s,
          "stats": rstats, "equal_to_fresh": resumed == fresh,
          "match_fraction_vs_fresh": m, "first_divergences_vs_fresh": fl})
    check_lossless("pipeline resume", fl)

    # one profiled continuous request: device ms a turn by family
    prof = profile_turns(eng.generate, prompts[0], PIPE_PROFILE_TOKENS)
    emit({"phase": "pipeline_profile", "card": smi, "schedule": "continuous",
          "new_tokens": PIPE_PROFILE_TOKENS, **prof})
    return total


class StageLaunches:
    """Per kernel, the launches made inside stage forwards
    (`parallel.pipeline._stage_forward`, wrapped for the process: the layers
    the process holds); a run's other launches are the replicated part (the
    draft and the beam head), which every stage process runs once."""

    def __init__(self, counters):
        from flowspec_tpu_torch.parallel import pipeline
        self.n = {k: 0 for k in counters}
        inner = pipeline._stage_forward

        def counted(*args, **kw):
            before = counts(counters)
            out = inner(*args, **kw)
            for k, v in counts(counters).items():
                self.n[k] += v - before[k]
            return out
        pipeline._stage_forward = counted

    def zero(self) -> None:
        for k in self.n:
            self.n[k] = 0


def nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def procs_turn(eng, prompts, counters, stage_n, new_tokens):
    """One schedule's requests through `eng.generate` (the launch counts set
    to 0 just before): (outputs past the prompt, the line, each request's
    (stream, state)). The line: tok/s, rounds, turns, turns a round, accept
    a round, host wall ms a turn, flag reads a turn, each request's stats,
    the launches (all, inside stage forwards), and for a distributed engine
    the stage ring's collectives a turn (calls, gloo payload bytes, host ms,
    staging copies included) by op and summed (`hop_ms_per_turn`,
    `gloo_bytes_per_turn`)."""
    ring = eng.ring
    kept = []

    def generate(p, **kw):
        out, stats, st = eng.generate(p, return_state=True, **kw)
        kept.append((out, st))
        return out, stats
    zero(counters)
    stage_n.zero()
    if ring is not None:
        ring.stats.clear()
    reads = eng.reads.count
    outs, sec, rounds, new, stats = serve_turn(generate, prompts, new_tokens)
    turns = sum(st["turns"] for st in stats)
    line = {"schedule": eng.schedule, "tok_s": new / sum(sec),
            "request_s": sec, "new_tokens": new, "rounds": rounds,
            "turns": turns, "turns_per_round": turns / rounds,
            "accept_per_round": new / rounds,
            "wall_ms_per_turn": sum(sec) * 1e3 / turns,
            "host_reads_per_turn": (eng.reads.count - reads) / turns,
            "stats": stats, "launches": nonzero(counts(counters)),
            "stage_launches": nonzero(dict(stage_n.n))}
    if ring is not None:
        hop = {op: {"calls_per_turn": c / turns, "bytes_per_turn": b / turns,
                    "ms_per_turn": t * 1e3 / turns}
               for op, (c, b, t) in ring.stats.items()}
        line.update(hop=hop,
                    flag_checks=ring.stats["all_gather_ints"][0],
                    hop_ms_per_turn=sum(h["ms_per_turn"]
                                        for h in hop.values()),
                    gloo_bytes_per_turn=sum(h["bytes_per_turn"]
                                            for h in hop.values()))
    return outs, line, kept


def weight_bytes(*trees) -> int:
    """Bytes of the distinct device tensors of `trees` (shared ones once)."""
    seen = {}
    for tree in trees:
        for t in tensors_of(tree).values():
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def stage_child(rank: str, world: str, port: str, out_path: str) -> int:
    """One stage process of the `pipeline_procs` phase (`procs_config`
    starts PROCS of them): joins the world over gloo through pinned host
    buffers, draws the same seeded 7B int8 pair as every process, builds a
    `PipelineEngine` a schedule on the distributed stage_mesh(PROCS), keeps
    its block (8 layers) and the replicated part and frees the rest, then
    serves the prompts with each schedule and runs one continuous resume
    against a fresh run on the whole history. Writes its record to
    `out_path`."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flowspec_tpu_torch.ops import _build
    from flowspec_tpu_torch.parallel import (
        PipelineEngine, init_multihost, stage_mesh)
    rank, world = int(rank), int(world)
    dev = torch.device("cuda")
    prebuilt = all(_build.lib_path(n).exists() for n in _build.KERNELS)
    init_multihost(f"127.0.0.1:{port}", world, rank, device=dev,
                   host_staging=True, timeout=PROCS_TIMEOUT)
    counters = launch_counts()
    t0 = time.perf_counter()
    base, prompts, _ = make_engine(dev, "7b", "int8", N_REQUESTS, PROCS_NEW)
    cfg = pipe_config(base.cfg.model, PROCS_NEW)
    whole_gb = weight_bytes(base.params, base.draft) / 1e9
    engines = {s: PipelineEngine(base.params, base.draft, cfg, schedule=s,
                                 mesh=stage_mesh(PROCS, distributed=True))
               for s in PROCS_SCHEDULES}
    del base
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    eng = engines["continuous"]
    rec = {"rank": rank, "kernels_prebuilt": prebuilt,
           "build_s": time.perf_counter() - t0, "drawn_weights_gb": whole_gb,
           "build_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "stages_here": list(eng.local), "layers_here": eng.n_layers,
           "weights_gb": weight_bytes(*[e.params for e in engines.values()],
                                      eng.draft, eng.beam_head) / 1e9,
           "block_weights_gb": weight_bytes(eng.params.layers) / 1e9,
           "resident_gb": torch.cuda.memory_allocated() / 1e9}
    stage_n = StageLaunches(counters)
    torch.cuda.reset_peak_memory_stats()
    kept = None
    for s in PROCS_SCHEDULES:
        outs, line, k = procs_turn(engines[s], prompts, counters, stage_n,
                                   PROCS_NEW)
        rec[s] = {"outs": outs, **line}
        kept = k if s == "continuous" else kept
    first, st = kept[0]
    extra = random_prompts(cfg.model.vocab_size, [PROCS_RESUME[0]],
                           SEED + 9)[0]
    t0 = time.perf_counter()
    resumed, rstats = eng.resume_and_generate(
        st, first, extra, max_new_tokens=PROCS_RESUME[1], eos_token_id=-1)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    fresh, _ = eng.generate(first + extra, max_new_tokens=PROCS_RESUME[1],
                            eos_token_id=-1)
    rec["resume"] = {"history": first, "extra": extra, "resumed": resumed,
                     "fresh": fresh, "stats": rstats, "resume_s": resume_s}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    Path(out_path).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def plain_gloo_refuses_cuda() -> str:
    """A world of one process over gloo without host staging: a CUDA
    tensor handed to its collectives must raise. Returns the message."""
    import torch
    import torch.distributed as dist
    from flowspec_tpu_torch.multihost_dryrun import free_port
    from flowspec_tpu_torch.parallel import init_multihost
    from flowspec_tpu_torch.parallel.comm import DistGroup
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        DistGroup().broadcast(torch.zeros(4, device="cuda"), 0)
    except ValueError as e:
        return str(e)
    finally:
        dist.destroy_process_group()
    raise AssertionError("pipeline_procs: gloo took a CUDA tensor without "
                         "host staging")


def run_stage_processes(out_dir: Path) -> tuple:
    """PROCS `--stage` processes of this script on a free port, each with
    its log in `out_dir`: (their records, wall seconds). Raises if one
    fails or outlives PROCS_TIMEOUT."""
    from flowspec_tpu_torch.multihost_dryrun import free_port
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(PROCS):
        (out_dir / f"rank{r}.json").unlink(missing_ok=True)
        logs.append(open(out_dir / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--stage",
             str(r), str(PROCS), str(port), str(out_dir / f"rank{r}.json")],
            stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        codes = [q.wait(timeout=max(PROCS_TIMEOUT - (time.perf_counter()
                                                     - t0), 1))
                 for q in procs]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        for f in logs:
            f.close()
    if any(codes):
        tails = {r: (out_dir / f"rank{r}.log").read_text()[-3000:]
                 for r in range(PROCS) if codes[r]}
        raise AssertionError(f"pipeline_procs: stage processes exited "
                             f"{codes}: {tails}")
    return ([json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(PROCS)], time.perf_counter() - t0)


def first_difference(a, b):
    """The first (request, position) at which two lists of streams part."""
    for i, (x, y) in enumerate(zip(a, b)):
        j = next((k for k, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if j is not None or len(x) != len(y):
            return i, j
    return None


def procs_config(dev, counters, smi):
    """The stage-process phase in its own process: the 7B int8 pair through
    the in-process `PipelineEngine` (continuous, pruned; 2 x PROCS_NEW
    tokens), then PROCS stage processes (`stage_child`) on the same prompts
    and schedules, then `multihost_dryrun --device cuda`. Returns its
    launches (this process's and the stage processes'). Raises if a stream
    leaves its AR stream off a near-tie, if the stage processes' stream or
    stats differ from the in-process engine's or from each other's, if a
    process launched no int8, attention or head kernel, if the stage
    layers' launches summed over the processes differ from the in-process
    engine's or a process's replicated part from the in-process one's, if
    the resume leaves the fresh run off a near-tie, if gloo took a CUDA
    tensor without host staging, or if the dry run fails."""
    import torch
    from flowspec_tpu_torch.parallel import PipelineEngine
    from flowspec_tpu_torch.runtime import SpecEngine
    refusal = plain_gloo_refuses_cuda()
    base, prompts, params_s = make_engine(dev, "7b", "int8", N_REQUESTS,
                                          PROCS_NEW)
    cfg = pipe_config(base.cfg.model, PROCS_NEW)
    spec = SpecEngine(base.params, base.draft, cfg)
    del base
    ar = [spec.generate_ar_fused(p, max_new_tokens=PROCS_NEW,
                                 eos_token_id=-1)[0][len(p):]
          for p in prompts]
    stage_n = StageLaunches(counters)
    total = {n: 0 for n in counters}
    local = {}
    for sched in PROCS_SCHEDULES:
        eng = PipelineEngine(spec.params, spec.draft, cfg, schedule=sched)
        torch.cuda.reset_peak_memory_stats()
        outs, line, kept = procs_turn(eng, prompts, counters, stage_n,
                                      PROCS_NEW)
        line["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        local[sched] = (outs, line)
        for n in total:
            total[n] += line["launches"].get(n, 0)
        if sched == "continuous":        # the resume the processes run
            first, st = kept[0]
            extra = random_prompts(cfg.model.vocab_size, [PROCS_RESUME[0]],
                                   SEED + 9)[0]
            local_resume = eng.resume_and_generate(
                st, first, extra, max_new_tokens=PROCS_RESUME[1],
                eos_token_id=-1)
            del first, st, kept
        del eng

    ranks, procs_s = run_stage_processes(OUT_DIR / "pipeline_procs")
    lines = []
    for sched in PROCS_SCHEDULES:
        mine = [r[sched] for r in ranks]
        outs, want = mine[0]["outs"], local[sched]
        for r, m in enumerate(mine):
            if m["outs"] != outs or m["stats"] != mine[0]["stats"]:
                raise AssertionError(f"pipeline_procs {sched}: rank {r} "
                                     f"returned another stream or stats")
            missing = [k for k in ("int8_matmul", "tree_attention",
                                   "head_topk") if not m["launches"].get(k)]
            if missing:
                raise AssertionError(f"pipeline_procs {sched}: rank {r} "
                                     f"launched no {missing}")
        if outs != want[0] or mine[0]["stats"] != want[1]["stats"]:
            raise AssertionError(
                f"pipeline_procs {sched}: the stage processes' stream parts "
                f"from the in-process engine's at (request, position) "
                f"{first_difference(outs, want[0])}, stats "
                f"{mine[0]['stats']} against {want[1]['stats']}")
        m, fl = divergences(spec, prompts, outs, ar)
        check_lossless(f"pipeline_procs {sched}", fl)
        stage_sum = nonzero({k: sum(r["stage_launches"].get(k, 0)
                                    for r in mine) for k in counters})
        if stage_sum != want[1]["stage_launches"]:
            raise AssertionError(
                f"pipeline_procs {sched}: stage launches over the processes "
                f"{stage_sum}, in-process {want[1]['stage_launches']}")
        replicated = nonzero({k: want[1]["launches"].get(k, 0)
                              - want[1]["stage_launches"].get(k, 0)
                              for k in counters})
        for r, mr in enumerate(mine):
            got = nonzero({k: mr["launches"].get(k, 0)
                           - mr["stage_launches"].get(k, 0)
                           for k in counters})
            if got != replicated:
                raise AssertionError(
                    f"pipeline_procs {sched}: rank {r}'s replicated launches "
                    f"{got}, in-process {replicated}")
        for mr in mine:
            for n in total:
                total[n] += mr["launches"].get(n, 0)
        keys = ("tok_s", "request_s", "rounds", "turns", "turns_per_round",
                "accept_per_round", "wall_ms_per_turn", "host_reads_per_turn")
        lines.append({
            "schedule": sched, **{k: mine[0][k] for k in keys},
            "hop_ms_per_turn": [r["hop_ms_per_turn"] for r in mine],
            "gloo_bytes_per_turn": [r["gloo_bytes_per_turn"]
                                    for r in mine],
            "hop_by_op": [r["hop"] for r in mine],
            "flag_checks": [r["flag_checks"] for r in mine],
            "launches_per_process": [
                {k: r["launches"].get(k, 0) for k in
                 ("int8_matmul", "tree_attention", "head_topk")}
                for r in mine],
            "stage_launches_per_process": [r["stage_launches"]
                                           for r in mine],
            "replicated_launches_per_process": replicated,
            "match_fraction_vs_ar": m, "first_divergences_vs_ar": fl,
            "in_process": {k: want[1][k] for k in keys + (
                "launches", "stage_launches", "peak_gb")}})
    emit({"phase": "pipeline_procs", "card": smi,
          "model": "llama_7b int8 (random, seeded)",
          "draft": "checkpoints/draft_7b_thin_fp16.npz (int8)",
          "reduced": None, "processes": PROCS,
          "stages": [ranks[r]["layers_here"] for r in range(PROCS)],
          "transport": PROCS_TRANSPORT,
          "plain_gloo_refuses_cuda": refusal,
          "tree": "TreeConfig() defaults, score_temperature 0.2",
          "max_seq_len": PIPE_MAX_SEQ, "prompt_len": PROMPT_LEN,
          "requests": len(prompts), "new_tokens": PROCS_NEW,
          "schedules": lines, "streams_equal_in_process": True,
          "ranks_agree": True,
          "memory": [{k: r[k] for k in (
              "drawn_weights_gb", "build_peak_gb", "weights_gb",
              "block_weights_gb", "resident_gb", "peak_gb", "build_s",
              "kernels_prebuilt")} for r in ranks],
          "stage_processes_s": procs_s, "param_build_s": params_s})

    res = ranks[0]["resume"]
    if any((r["resume"]["resumed"], r["resume"]["fresh"], r["resume"]["stats"])
           != (res["resumed"], res["fresh"], res["stats"]) for r in ranks):
        raise AssertionError("pipeline_procs: the ranks' resumes differ")
    if [res["resumed"], res["stats"]] != list(local_resume):
        at = first_difference([res["resumed"]], [local_resume[0]])
        raise AssertionError(f"pipeline_procs: the stage processes' resume "
                             f"parts from the in-process one at {at}")
    hist = res["history"] + res["extra"]
    m, fl = divergences(spec, [hist], [res["resumed"][len(hist):]],
                        [res["fresh"][len(hist):]])
    emit({"phase": "pipeline_procs_resume", "card": smi,
          "history": len(res["history"]), "extra": len(res["extra"]),
          "new_tokens": PROCS_RESUME[1], "resume_s": res["resume_s"],
          "stats": res["stats"], "equal_to_in_process_resume": True,
          "equal_to_fresh": res["resumed"] == res["fresh"],
          "match_fraction_vs_fresh": m, "first_divergences_vs_fresh": fl})
    check_lossless("pipeline_procs resume", fl)
    del spec
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "flowspec_tpu_torch.multihost_dryrun",
         "--device", "cuda", "--procs", "2", "--stages", "8", "--out",
         str(OUT_DIR / "multihost_dryrun"), "--timeout",
         str(PROCS_TIMEOUT)], cwd=ROOT, capture_output=True, text=True,
        timeout=PROCS_TIMEOUT + 60)
    if r.returncode != 0:
        raise AssertionError(f"multihost_dryrun --device cuda exited "
                             f"{r.returncode}: {r.stderr[-3000:]}")
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    emit({"phase": "pipeline_procs_dryrun", "card": smi, "ok": rep["ok"],
          "procs": rep["procs"], "stages": rep["stages"],
          "transport": rep["ranks"][0]["transport"],
          "seconds": time.perf_counter() - t0,
          "paths": {k: v for k, v in rep["ranks"][0].items()
                    if isinstance(v, dict)}})
    return total


def tp_expected_per_round(eng) -> dict:
    """Launches per speculative round of a `TPEngine` that the code
    implies: `expected_per_round` with every sharded product and attention
    once a rank (the base's 7 projections and one attention a layer, the
    draft's 8 sharded projections and one attention a pass), the thin
    draft's replicated w_out and the replicated beam head once."""
    tp = eng.mesh.shape["tp"]
    tree = eng.cfg.tree
    n_layers = eng.cfg.model.num_hidden_layers
    passes = tree.depth + 1
    out = {"tree_attention": tp * (n_layers + passes), "head_topk": passes}
    lp, dp = eng.params.shards[0].layers, eng.draft.shards[0]
    for w, m, n in ([(getattr(lp, f), tree.node_cap, tp * n_layers)
                     for f in BASE_PROJ]
                    + [(getattr(dp, f), tree.top_k,
                        passes * (1 if f == "w_out" else tp))
                       for f in DRAFT_PROJ]):
        kernel = _matmul_kernel(w, m)
        if kernel is not None:
            out[kernel] = out.get(kernel, 0) + n
    return out


def tp_round_sums(eng, kernel_rows, per_round) -> dict:
    """`round_sums` of one TP round: the shard products at their widths,
    each rank's; the attention on each rank's heads; the replicated head."""
    tp = eng.mesh.shape["tp"]
    tree, mc = eng.cfg.tree, eng.cfg.model
    n_layers, depth = mc.num_hidden_layers, tree.depth
    lp, dp = eng.params.shards[0].layers, eng.draft.shards[0]
    items = []
    for f in BASE_PROJ:
        _matmul_items(kernel_rows, items, getattr(lp, f), tree.node_cap,
                      tp * n_layers)
    for f in DRAFT_PROJ:
        _matmul_items(kernel_rows, items, getattr(dp, f), tree.top_k,
                      (depth + 1) * (1 if f == "w_out" else tp))
    attn, head = kernel_rows["tree_attention"], kernel_rows["head_topk"]
    items += [("tree_attention", attn[f"tp{tp}_verify_T81"], tp * n_layers),
              ("tree_attention", attn[f"tp{tp}_draft_ctx_T9"], tp),
              ("tree_attention", attn[f"tp{tp}_beam_T10"], tp * depth),
              ("head_topk", head["root_T1"], 1),
              ("head_topk", head["beam_T10"], depth)]
    return _sums(items, per_round, f"tp{tp} round_sums")


def tp_turns(eng, prompts, new_tokens, counters, total, tag):
    """One eager and two fused turns of `eng` (the first fused one
    captures): their outputs (which must agree), tok/s, rounds, launches
    a round (held to `tp_expected_per_round`, and each graph's replay),
    peak memory, capture seconds."""
    import torch
    zero(counters)
    eng.prefill(eng.init_state(), prompts[0])
    torch.cuda.synchronize()
    prefill = counts(counters)
    expected = tp_expected_per_round(eng)
    line = {}
    outs = []
    for i, (kind, fn) in enumerate((("eager", eng.generate),
                                    ("fused_capture", eng.generate_fused),
                                    ("fused", eng.generate_fused))):
        zero(counters)
        torch.cuda.reset_peak_memory_stats()
        out, sec, rounds, new, _ = serve_turn(fn, prompts, new_tokens)
        launches = counts(counters)
        for n in total:
            total[n] += launches[n]
        outs.append(out)
        rec = {"tok_s": new / sum(sec), "request_s": sec, "rounds": rounds,
               "accept_per_round": new / rounds,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if kind != "fused_capture":
            rec["launches_per_round"] = launches_per_round(
                f"{tag} {kind}", launches, prefill, len(prompts), rounds,
                expected)
            missing = [k for k in ("int8_matmul", "tree_attention",
                                   "head_topk") if launches[k] == 0]
            if missing:
                raise AssertionError(f"{tag} {kind}: no launch of {missing}")
        line[kind] = rec
    check_graph_launches(tag, eng, "spec", expected)
    if not outs[0] == outs[1] == outs[2]:
        raise AssertionError(f"{tag}: the fused stream differs from the "
                             "eager one")
    line["graph_capture_s"] = sum(g.capture_s for g in graphs_of(eng, "spec"))
    line["expected_per_round"] = expected
    line["prefill_launches"] = {k: n for k, n in prefill.items() if n}
    return outs[0], line


def spec_turn(spec, prompts, new_tokens):
    import torch
    torch.cuda.reset_peak_memory_stats()
    out, sec, rounds, new, _ = serve_turn(spec.generate_fused, prompts,
                                          new_tokens)
    return out, {"tok_s": new / sum(sec), "request_s": sec,
                 "rounds": rounds, "accept_per_round": new / rounds,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def tp_config(dev, counters, kernel_rows, smi):
    """The tensor-parallel phase in its own process (docstring, phase 12);
    each tp's line carries its `tp_round_sums`. Returns its launches.
    Raises if a stream
    leaves AR or the unsharded engine's stream off a near-tie, if the fused
    stream differs from the eager one, if a round or a replay launches
    other than the code implies, or if the galaxy forward never ran."""
    import dataclasses
    import torch
    from flowspec_tpu_torch.config import (
        EngineConfig, ModelConfig, SamplingConfig, StageTopology, TreeConfig)
    from flowspec_tpu_torch.draft.eagle import (
        load_thin_draft, quantize_eagle_params)
    from flowspec_tpu_torch.entry import dryrun_multichip, random_llama
    from flowspec_tpu_torch.parallel import (
        PipelineEngine, TPEngine, stage_tp_mesh, tp_mesh)
    from flowspec_tpu_torch.runtime import SpecEngine
    total = {n: 0 for n in counters}
    spec, prompts, params_s = make_engine(dev, "7b", "int8", N_REQUESTS,
                                          TP_NEW_TOKENS)
    t0 = time.perf_counter()
    ar = [spec.generate_ar_fused(p, max_new_tokens=TP_NEW_TOKENS,
                                 eos_token_id=-1)[0][len(p):]
          for p in prompts]
    ar_s = time.perf_counter() - t0
    yard = []
    for _ in range(2):          # the first turn captures the graph
        spec_out, rec = spec_turn(spec, prompts, TP_NEW_TOKENS)
        yard.append(rec)
    m, fl = divergences(spec, prompts, spec_out, ar)
    check_lossless("tp: SpecEngine", fl)
    lines = {}
    for tp in TP_SIZES:
        tag = f"tp{tp}"
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng = TPEngine(spec.params, spec.draft, spec.cfg, mesh=tp_mesh(tp))
        weights = torch.cuda.memory_allocated() - before
        out, line = tp_turns(eng, prompts, TP_NEW_TOKENS, counters, total,
                             tag)
        m_ar, f_ar = divergences(spec, prompts, out, ar)
        m_sp, f_sp = divergences(spec, prompts, out, spec_out)
        check_lossless(f"{tag} vs AR", f_ar)
        check_lossless(f"{tag} vs SpecEngine", f_sp)
        line.update(weights_gb=weights / 1e9, match_fraction_vs_ar=m_ar,
                    first_divergences_vs_ar=f_ar,
                    match_fraction_vs_spec=m_sp,
                    first_divergences_vs_spec=f_sp,
                    round_ms=tp_round_sums(
                        eng, kernel_rows,
                        line["fused"]["launches_per_round"]))
        if tp == 2:
            line["fused_profile"] = profile_request(
                eng.generate_fused, prompts[0], PROFILE_TOKENS)
        lines[tag] = line
        del eng
        torch.cuda.empty_cache()
    spec_out2, rec = spec_turn(spec, prompts, TP_NEW_TOKENS)
    yard.append(rec)
    if spec_out2 != spec_out:
        raise AssertionError("tp: SpecEngine's turns differ")
    emit({"phase": "tp", "card": smi,
          "model": "llama_7b int8 (random, seeded)",
          "draft": "checkpoints/draft_7b_thin_fp16.npz (int8)",
          "reduced": None, "mesh": "tp_mesh(tp), in-process on one card",
          "tree": "node_cap 96 (81 nodes), depth 8, score_temperature 0.2",
          "prompt_len": PROMPT_LEN, "requests": len(prompts),
          "new_tokens": TP_NEW_TOKENS,
          "spec_engine_generate_fused": yard,
          "turns_order": ["spec fused", "spec fused"]
          + [f"tp{tp} {k}" for tp in TP_SIZES
             for k in ("eager", "fused", "fused")] + ["spec fused"],
          "param_build_s": params_s,
          "ar_reference_s": ar_s, **lines})

    # galaxy: a bf16 base (the galaxy path takes unquantized LLaMA weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    mc8 = dataclasses.replace(ModelConfig.llama_7b(),
                              num_hidden_layers=GALAXY_LAYERS)
    base = random_llama(mc8, gen, dev)
    draft = quantize_eagle_params(load_thin_draft(
        str(ROOT / "checkpoints" / "draft_7b_thin_fp16.npz"), base.embed),
        "int8")
    gcfg = EngineConfig(model=mc8, tree=TreeConfig(
        node_cap=96, leaf_cap=96, depth=8, depth_cap=16,
        total_tokens=GALAXY_NODES - 1, score_temperature=0.2),
        sampling=SamplingConfig(),
        max_seq_len=PROMPT_LEN + GALAXY_NEW + 24)
    gspec = SpecEngine(base, draft, gcfg)
    g_ar = [gspec.generate_ar(p, max_new_tokens=GALAXY_NEW,
                              eos_token_id=-1)[0][len(p):] for p in prompts]
    glines = {}
    g_outs = {}
    for name, galaxy in (("plain_tp2", False), ("galaxy_tp2", True)):
        eng = TPEngine(base, draft, gcfg, mesh=tp_mesh(2), galaxy=galaxy)
        zero(counters)
        out, sec, rounds, new, _ = serve_turn(eng.generate, prompts,
                                              GALAXY_NEW)
        launches = counts(counters)
        for n in total:
            total[n] += launches[n]
        m, fl = divergences(gspec, prompts, out, g_ar)
        check_lossless(f"tp {name} vs AR", fl)
        g_outs[name] = out
        glines[name] = {"tok_s": new / sum(sec), "rounds": rounds,
                        "accept_per_round": new / rounds,
                        "match_fraction_vs_ar": m,
                        "first_divergences_vs_ar": fl,
                        "launches": {k: n for k, n in launches.items() if n}}
        if galaxy:
            fwd = eng.forward_fn
            glines[name].update(engaged=fwd.engaged, fallbacks=fwd.fallbacks)
            if fwd.engaged < rounds:
                raise AssertionError(f"tp galaxy: engaged {fwd.engaged} "
                                     f"times in {rounds} rounds")
        del eng
    m, fl = divergences(gspec, prompts, g_outs["galaxy_tp2"],
                        g_outs["plain_tp2"])
    check_lossless("tp galaxy vs plain TP", fl)
    emit({"phase": "tp_galaxy", "card": smi,
          "model": "llama_7b width, bf16 (random, seeded)",
          "draft": "checkpoints/draft_7b_thin_fp16.npz (int8)",
          "reduced": f"32 -> {GALAXY_LAYERS} layers: the run's time",
          "tree_nodes": GALAXY_NODES, "new_tokens": GALAXY_NEW,
          "requests": len(prompts), "galaxy_vs_plain_match": m,
          "galaxy_vs_plain_first_divergences": fl, **glines})
    del gspec, base, draft
    torch.cuda.empty_cache()

    # PP x TP: the pipeline phase's tree, pruned, on a (4, 2) mesh
    pcfg = EngineConfig(model=spec.cfg.model,
                        tree=TreeConfig(score_temperature=0.2),
                        sampling=SamplingConfig(),
                        max_new_tokens=TP_PIPE_NEW,
                        max_seq_len=PIPE_MAX_SEQ, topology=StageTopology())
    pipe = PipelineEngine(spec.params, spec.draft, pcfg, schedule="pruned",
                          mesh=stage_tp_mesh(4, 2))
    zero(counters)
    torch.cuda.reset_peak_memory_stats()
    out, sec, rounds, new, stats = serve_turn(pipe.generate, prompts,
                                              TP_PIPE_NEW)
    launches = counts(counters)
    for n in total:
        total[n] += launches[n]
    m, fl = divergences(spec, prompts, out,
                        [a[:TP_PIPE_NEW] for a in ar])
    check_lossless("tp pipeline (stage 4, tp 2)", fl)
    turns = sum(st["turns"] for st in stats)
    emit({"phase": "tp_pipeline", "card": smi, "mesh": "stage_tp_mesh(4, 2)",
          "schedule": "pruned", "stages": list(pipe.layer_split),
          "new_tokens": TP_PIPE_NEW, "requests": len(prompts),
          "tok_s": new / sum(sec), "rounds": rounds, "turns": turns,
          "accept_per_round": new / rounds,
          "wall_ms_per_turn": sum(sec) * 1e3 / turns,
          "launches_per_turn": {k: n / turns for k, n in launches.items()
                                if n},
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "match_fraction_vs_ar": m, "first_divergences_vs_ar": fl})
    del pipe

    # the multi-device dry run, in-process on the card
    zero(counters)
    t0 = time.perf_counter()
    report = dryrun_multichip(4)
    launches = counts(counters)
    if not (report["trained"]["run"] is False
            and all(report[f"{s}_struct_d8"]["ok"]
                    for s in ("continuous", "pruned"))):
        raise AssertionError(f"tp_dryrun: trained gates {report}")
    for n in total:
        total[n] += launches[n]
    emit({"phase": "tp_dryrun", "card": smi,
          "seconds": time.perf_counter() - t0, "report": report,
          "launches": {k: n for k, n in launches.items() if n}})
    return total


class CallLog:
    """While active, records every `SpecEngine.generate_fused`, `generate`
    and `resume_and_generate` call of any engine: (engine, prompt tokens,
    output stream, host seconds). The methods are wrapped on the class (an
    engine the sweep CLI builds is out of reach otherwise) and restored on
    exit."""

    NAMES = ("generate_fused", "generate", "resume_and_generate")

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from flowspec_tpu_torch.runtime import SpecEngine
        self.saved = {n: SpecEngine.__dict__[n] for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(SpecEngine, n, self._wrap(n, fn))
        return self

    def _wrap(self, name, fn):
        def call(eng, *a, **kw):
            t0 = time.perf_counter()
            r = fn(eng, *a, **kw)
            sec = time.perf_counter() - t0
            prompt = (list(a[1]) + list(a[2]) if name == "resume_and_generate"
                      else list(a[0]))
            self.calls.append({"engine": eng, "method": name,
                               "prompt": [int(t) for t in prompt],
                               "out": [int(t) for t in r[0]],
                               "seconds": sec})
            return r
        return call

    def __exit__(self, *exc):
        from flowspec_tpu_torch.runtime import SpecEngine
        for n, fn in self.saved.items():
            setattr(SpecEngine, n, fn)
        return False


class AttentionShapes:
    """While active, records the (lanes, nq, nkv, T, S, D) of every call the
    models make to `tree_attention` (a graph's capture makes each of its
    calls once for all its replays): the shapes a path gives the kernel.
    The models' reference to the wrapper is swapped for a recorder and
    restored on exit; the wrapper and its launch count are untouched."""

    def __init__(self):
        self.shapes = set()

    def __enter__(self):
        from flowspec_tpu_torch.models import llama
        self.fn = fn = llama.tree_attention

        def call(q, k, v, bias, n_valid=None):
            self.shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                             k.shape[2], q.shape[3]))
            return fn(q, k, v, bias, n_valid)
        llama.tree_attention = call
        return self

    def __exit__(self, *exc):
        from flowspec_tpu_torch.models import llama
        llama.tree_attention = self.fn
        return False

    def checked_by(self, rows) -> dict:
        """Each recorded shape, as "lanes x nq/nkv T x S D", with the
        kernel rows that held it against plain (an empty list: none)."""
        return {f"{b}x{nq}/{nkv} T{t} x S{s} D{d}": sorted(
            n for n, r in rows.items()
            if (r.get("lanes", 1), r["nq"], r["nkv"], r["T"], r["S"],
                r["D"]) == (b, nq, nkv, t, s, d))
            for b, nq, nkv, t, s, d in sorted(self.shapes)}


def spot_check(tag, calls, new_tokens):
    """Each recorded call's new tokens against `generate_ar` on its prompt
    by its own engine, under the near-tie rule (`check_lossless`); returns
    the match fractions and first divergences."""
    eng = calls[0]["engine"]
    prompts = [c["prompt"] for c in calls]
    spec = [c["out"][len(c["prompt"]):] for c in calls]
    ar = [eng.generate_ar(p, max_new_tokens=new_tokens,
                          eos_token_id=-1)[0][len(p):] for p in prompts]
    m, faults = divergences(eng, prompts, spec, ar)
    check_lossless(tag, faults)
    return {"methods": [c["method"] for c in calls],
            "prompt_tokens": [len(p) for p in prompts],
            "match_fraction_vs_ar": m, "first_divergences_vs_ar": faults}


def demo_line():
    """`python -m flowspec_tpu_torch.demo --random 7b --thin-draft ...` in
    a child process: its tok/s line and wall seconds."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "flowspec_tpu_torch.demo",
                        "--random", "7b", "--thin-draft", THIN_7B,
                        "--max-new-tokens", str(EVAL_NEW)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"demo exited with {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    if not lines or " tok/s | " not in lines[-1]:
        raise AssertionError(f"demo printed no tok/s line: {r.stdout}")
    return {"argv": ["--random", "7b", "--thin-draft", THIN_7B,
                     "--max-new-tokens", EVAL_NEW],
            "lines": lines, "seconds": time.perf_counter() - t0}


def eval_config(dev, counters, kernel_rows, smi):
    """The evaluation phase in its own process: the 7B int8 pair at full
    width and depth through the port's sweep CLI (`eval.sweep.main`),
    single engine, on 4 mt_bench questions x 2 turns, fused, then eager
    with the longest-common-prefix resume (`--resume --no-fused`); then
    `run_eval_serve` on a 4-lane `BatchedSpecEngine` over 8 questions x 2
    turns with the preamble prefilled once and a ConversationStore; each
    part inside a `Profiler.profile_context`; then the demo in a child
    process. Returns its launches. Raises if a row misses its token
    budget, if a spot-checked answer (one a turn of each sweep run) leaves
    its AR stream off a near-tie, if the resume run resumed other than
    every turn 2, if the int8, attention or head kernel never launched
    (or a comparison-only entry point did), or if the engines gave the
    attention kernel a shape that no row of the kernel phase checked."""
    import torch
    from flowspec_tpu_torch.eval import sweep
    from flowspec_tpu_torch.eval.harness import (
        load_questions, run_eval_serve)
    from flowspec_tpu_torch.utils.profiler import Profiler
    prof = Profiler(sync=True, device=dev)
    total = {n: 0 for n in counters}
    out_rows = OUT_DIR / "chip_smoke_eval_rows.jsonl"
    out_rows.unlink(missing_ok=True)
    argv = ["--random", "7b", "--quant", "int8", "--trained-draft", THIN_7B,
            "--engine", "single", "--data", EVAL_DATA,
            "--limit", str(EVAL_QUESTIONS), "--max-conv-turns", "2",
            "--depths", "8", "--score-temps", "0.2",
            "--max-new-tokens", str(EVAL_NEW),
            "--max-seq-len", str(EVAL_MAX_SEQ), "--out", str(out_rows)]
    budget = EVAL_QUESTIONS * 2 * EVAL_NEW

    def counted(fn):
        zero(counters)
        r = fn()
        for n, c in counts(counters).items():
            total[n] += c
        return r

    lines, eng = {}, None
    attn = AttentionShapes()
    for part, extra in (("single_fused", []),
                        ("resume", ["--resume", "--no-fused"])):
        eng = None                      # the previous part's engine
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with CallLog() as log, attn, prof.profile_context(part):
            rows = counted(lambda: sweep.main(argv + extra))
        (row,) = rows
        if row["new_tokens"] != budget or row["conversation_turns"] != 8:
            raise AssertionError(f"eval {part}: {row}")
        if part == "resume" and row["resume_hits"] != EVAL_QUESTIONS:
            raise AssertionError(f"eval resume: resume_hits {row}")
        # one answer a turn: question 1's turns 1 and 2
        check = spot_check(f"eval {part}", log.calls[:2], EVAL_NEW)
        # each call's host seconds: the first of a fresh engine's fused
        # calls captures its graph
        lines[part] = {"row": row, "spot_check": check,
                       "call_seconds": [c["seconds"] for c in log.calls],
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        eng = log.calls[0]["engine"]
        del log
    for part, line in lines.items():
        emit({"phase": f"eval_{part}", "card": smi,
              "model": "ModelConfig.llama_7b() int8, random (seed 0), "
                       f"{THIN_7B} in int8", **line})

    # the serving eval over the same pair: 8 questions, 2 turns, 4 lanes
    args = sweep.parse_args(argv + ["--engine", "serve", "--serve-slots",
                                    str(EVAL_LANES)])
    tc = sweep.tree_config(args, int(args.depths), int(args.expand_depths),
                           int(args.chunk_lens), float(args.score_temps))
    served = sweep.build_engine(args, eng.cfg.model, tc, eng.params,
                                eng.draft, 0.0)
    del eng
    tok, detok = sweep.byte_tokenizer(served.cfg.model.vocab_size)
    qs = load_questions(str(ROOT / EVAL_DATA), limit=EVAL_SERVE_QUESTIONS)
    torch.cuda.reset_peak_memory_stats()
    with attn, prof.profile_context("serve"):
        srows = counted(lambda: run_eval_serve(
            served, tok, qs, name="mt_bench", max_new_tokens=EVAL_NEW,
            prefix_cache=True, max_turns=2, detokenize=detok))
    for r in srows:
        if r["new_tokens"] != EVAL_NEW * r["questions"]:
            raise AssertionError(f"eval serve: {r}")
    emit({"phase": "eval_serve", "card": smi, "lanes": EVAL_LANES,
          "tree": "depth 8, 81 nodes a lane (adapt_tree off, as the sweep)",
          "rows": srows, "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del served
    torch.cuda.empty_cache()

    on_path = ("int8_matmul", "tree_attention", "head_topk")
    if any(total[n] == 0 for n in on_path) or any(
            total[n] for n in OLD.values()):
        raise AssertionError(f"eval: launches {total}")
    shapes = attn.checked_by(kernel_rows["tree_attention"])
    if not shapes or not all(shapes.values()):
        raise AssertionError(f"eval: attention shapes unchecked {shapes}")
    demo = demo_line()
    emit({"phase": "eval", "card": smi, "profile": prof.summary(),
          "launches": {k: n for k, n in total.items() if n},
          "attention_shapes_checked_by": shapes,
          "comparison_only_launches": {n: total[n] for n in OLD.values()},
          "demo": demo})
    return total


def lm_head_check(dev, gen, smi):
    """lm_head_logits at verify width (81 rows) at 7B: within f32 summation
    order of the f32 product, and one call's peak memory below one f32 copy
    of the head."""
    import torch
    from flowspec_tpu_torch.models.llama import LlamaParams, lm_head_logits
    h, v, t = 4096, 32000, 81
    head = (torch.randn((h, v), generator=gen, device=dev)
            * h ** -0.5).to(torch.bfloat16)
    x = torch.randn((1, t, h), generator=gen, device=dev).to(torch.bfloat16)
    params = LlamaParams(embed=None, layers=None, final_norm=None,
                         lm_head=head)
    lm_head_logits(params, x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = lm_head_logits(params, x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    err = float((got - x.float() @ head.float()).abs().max())
    row = {"phase": "lm_head", "card": smi, "T": t, "H": h, "V": v,
           "peak_bytes": peak, "f32_head_bytes": h * v * 4,
           "max_abs_err": err, "tolerance": "2e-3 abs (f32 sums of 4096)"}
    emit(row)
    if peak >= h * v * 4 or err > 2e-3:
        raise AssertionError(f"lm_head: {row}")


LOADER_LAYERS = 2          # the loader phase's Qwen2-7B, cut in depth only


def write_safetensors(path, tensors: dict) -> int:
    """Write {name: tensor} (bf16 here) as one safetensors file, tensor by
    tensor from the card: 8-byte little-endian header length, the JSON
    header padded to 8 bytes, the raw bytes. The card's machine has no
    `safetensors` package; this writer belongs to the smoke run, not to the
    port. Returns the bytes written."""
    import struct
    import torch
    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, off = {}, 0
    for n, t in tensors.items():
        size = t.numel() * t.element_size()
        header[n] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + size]}
        off += size
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for t in tensors.values():
            f.write(t.contiguous().cpu().view(torch.uint8).numpy().data)
    return 8 + len(h) + off


def write_hf_qwen2(params, mc, out: Path) -> int:
    """`params` (bf16 LlamaParams with biases) as an HF Qwen2 checkpoint:
    config.json, (out, in) weights, two shards named by
    model.safetensors.index.json (the embedding and layer 0; the rest).
    Returns the bytes of the shards."""
    out.mkdir(parents=True)
    lp = params.layers
    hf = {"model.embed_tokens.weight": params.embed}
    shards = [("model-00001-of-00002.safetensors", hf)]
    for i in range(mc.num_hidden_layers):
        if i == 1:
            hf = {}
            shards.append(("model-00002-of-00002.safetensors", hf))
        pre = f"model.layers.{i}."
        for f, name in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                        ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                        ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                        ("w_down", "mlp.down_proj")):
            hf[pre + name + ".weight"] = getattr(lp, f)[i].T
        for f, name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            hf[pre + f"self_attn.{name}.bias"] = getattr(lp, f)[i]
        hf[pre + "input_layernorm.weight"] = lp.input_ln[i]
        hf[pre + "post_attention_layernorm.weight"] = lp.post_ln[i]
    hf["model.norm.weight"] = params.final_norm
    hf["lm_head.weight"] = params.lm_head.T
    n_bytes = sum(write_safetensors(out / f, t) for f, t in shards)
    (out / "model.safetensors.index.json").write_text(json.dumps({
        "metadata": {"total_size": n_bytes},
        "weight_map": {n: f for f, t in shards for n in t}}))
    (out / "config.json").write_text(json.dumps({
        "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
        "vocab_size": mc.vocab_size, "hidden_size": mc.hidden_size,
        "intermediate_size": mc.intermediate_size,
        "num_hidden_layers": mc.num_hidden_layers,
        "num_attention_heads": mc.num_attention_heads,
        "num_key_value_heads": mc.num_key_value_heads,
        "rms_norm_eps": mc.rms_norm_eps, "rope_theta": mc.rope_theta,
        "max_position_embeddings": mc.max_position_embeddings,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16"}))
    return n_bytes


def tensors_of(tree, prefix=""):
    """{path: tensor} of a dataclass tree (quantized containers included)."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out.update(tensors_of(v, f"{prefix}{f.name}."))
        elif v is not None:
            out[prefix + f.name] = v
    return out


def unequal(a, b) -> list:
    """The paths where two trees differ in any bit (or in their paths)."""
    import torch
    ta, tb = tensors_of(a), tensors_of(b)
    if sorted(ta) != sorted(tb):
        return sorted(set(ta) ^ set(tb))
    return [k for k in ta if not (ta[k].dtype == tb[k].dtype
                                  and torch.equal(ta[k], tb[k]))]


def loader_phase(dev, smi):
    """Qwen2-7B at full width cut to LOADER_LAYERS layers, bf16, random from
    a seeded generator (biases and norms too): written as an HF checkpoint
    in two shards, loaded by the port's `load_model_config` /
    `load_llama_params` onto the card (seconds and GB/s, from the page
    cache the write left) and held bit for bit to its source; one request
    served from each through generate_fused, equal tokens; the int8
    quantization through `save_params` / `load_params`, bit-equal; and an
    engine state saved after 4 rounds, loaded and finished, equal to the
    uninterrupted stream. The files live in a directory of the checkout
    removed at the end."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from flowspec_tpu_torch.config import ModelConfig
    from flowspec_tpu_torch.draft.eagle import (
        init_eagle_params, quantize_eagle_params)
    from flowspec_tpu_torch.models import checkpoint, loader
    from flowspec_tpu_torch.models.llama import (
        LlamaLayerParams, LlamaParams, quantize_llama_params)
    from flowspec_tpu_torch.runtime import SpecEngine

    mc = dataclasses.replace(ModelConfig.qwen2_7b(),
                             num_hidden_layers=LOADER_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    h, i, n = mc.hidden_size, mc.intermediate_size, LOADER_LAYERS
    qd, kvd = mc.num_attention_heads * mc.head_dim_, \
        mc.num_key_value_heads * mc.head_dim_

    def r(shape, mean, std):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(
            mean, std, generator=gen)

    src = LlamaParams(
        embed=r((mc.vocab_size, h), 0.0, 0.02),
        layers=LlamaLayerParams(
            wq=r((n, h, qd), 0.0, h ** -0.5), wk=r((n, h, kvd), 0.0, h ** -0.5),
            wv=r((n, h, kvd), 0.0, h ** -0.5), wo=r((n, qd, h), 0.0, qd ** -0.5),
            w_gate=r((n, h, i), 0.0, h ** -0.5),
            w_up=r((n, h, i), 0.0, h ** -0.5),
            w_down=r((n, i, h), 0.0, i ** -0.5),
            input_ln=r((n, h), 1.0, 0.05), post_ln=r((n, h), 1.0, 0.05),
            bq=r((n, qd), 0.0, 0.1), bk=r((n, kvd), 0.0, 0.1),
            bv=r((n, kvd), 0.0, 0.1)),
        final_norm=r((h,), 1.0, 0.05), lm_head=r((h, mc.vocab_size), 0.0,
                                                 h ** -0.5))
    tmp = Path(tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT))
    try:
        t0 = time.perf_counter()
        n_bytes = write_hf_qwen2(src, mc, tmp / "hf")
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg = loader.load_model_config(str(tmp / "hf"))
        params = loader.load_llama_params(str(tmp / "hf"), cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        config_equal = dataclasses.asdict(cfg) == dataclasses.asdict(mc)
        bad = unequal(params, src)
        shutil.rmtree(tmp / "hf")

        draft = quantize_eagle_params(init_eagle_params(
            gen, mc, embed=src.embed), "int8")
        ecfg = engine_config(mc, FAMILY_NEW_TOKENS)
        rng = torch.Generator().manual_seed(SEED + 1)
        prompt = torch.randint(3, mc.vocab_size, (PROMPT_LEN,),
                               generator=rng).tolist()
        eng_src = SpecEngine(src, draft, ecfg, device=dev)
        from_src, _ = eng_src.generate_fused(prompt, FAMILY_NEW_TOKENS,
                                             eos_token_id=-1)
        del eng_src
        eng = SpecEngine(params, dataclasses.replace(draft,
                                                     embed=params.embed),
                         ecfg, device=dev)
        from_loaded, _ = eng.generate_fused(prompt, FAMILY_NEW_TOKENS,
                                            eos_token_id=-1)

        q = quantize_llama_params(src, "int8")
        t0 = time.perf_counter()
        checkpoint.save_params(q, str(tmp / "int8"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.load_params(str(tmp / "int8"), device=dev)
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        bad_int8 = unequal(back, q)
        del q, back
        shutil.rmtree(tmp / "int8")

        full, _ = eng.generate(prompt, FAMILY_NEW_TOKENS, eos_token_id=-1)
        st = eng.prefill(eng.init_state(0), prompt)
        out = list(prompt)
        for _ in range(4):
            st, acc, n_acc = eng._round(st)
            out += acc[:int(n_acc)].tolist()
        checkpoint.save_state(st, str(tmp / "state"))
        st = checkpoint.load_state(str(tmp / "state"), device=dev)
        while len(out) < len(prompt) + FAMILY_NEW_TOKENS:
            st, acc, n_acc = eng._round(st)
            out += acc[:int(n_acc)].tolist()
        resumed = out[:len(prompt) + FAMILY_NEW_TOKENS]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "loader", "card": smi,
           "model": "ModelConfig.qwen2_7b() bf16 with qkv biases, random, "
                    "seeded, untied head",
           "reduced": f"28 -> {LOADER_LAYERS} layers (a checkpoint written "
                      "and read within the run)",
           "shards": 2, "checkpoint_bytes": n_bytes, "write_s": write_s,
           "load_s": load_s, "load_GB_s": n_bytes / load_s / 1e9,
           "config_equal": config_equal, "tensors_unequal": bad,
           "served_tokens_equal": from_loaded == from_src,
           "fused_equals_eager": full == from_loaded,
           "int8_save_s": save_s, "int8_load_s": reload_s,
           "int8_tensors_unequal": bad_int8,
           "state_resume_equal": resumed == full}
    emit(row)
    if (bad or bad_int8 or not config_equal or from_loaded != from_src
            or resumed != full or full != from_loaded):
        raise AssertionError(f"loader: {row}")


def old_entry(kernel, rows, launches):
    """The "old" record of a redesigned kernel's line in `kernels`: its
    comparison-only entry point, its time at the kernel's main shape, its
    largest deviation from the new kernel, and its launches on the serve
    paths (0); None for a kernel without one."""
    if kernel not in OLD:
        return None
    main = rows[MAIN[kernel]]
    return {"name": OLD[kernel], "route": "cuda",
            "source": f"flowspec_tpu_torch/csrc/{kernel}.cu",
            "comparison_only": True, "launches": launches[OLD[kernel]],
            "ms": main["old_ms"],
            # the lane rows have none: the old kernel takes one lane
            "max_abs_err_vs_new": max(r["vs_old_max_abs_err"]
                                      for r in rows.values()
                                      if "vs_old_max_abs_err" in r)}


def top2_gap(eng, prefix) -> float:
    """The base model's top-2 logit gap after `prefix` (a fresh prefill)."""
    import torch
    _, logits = eng._prefill_chunks(eng.init_state(), prefix)
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def serve_child(tag: str, rows_path: str, out_path: str) -> int:
    """One configuration's serve phases (`serve_config`; at 7B int8 also
    `bucket_and_force_runs`) in a process of their own, started by `main`
    with the kernel phase's rows; writes (launches, round_sums,
    ar_step_sums, profiled ms by family) as JSON to `out_path`. A process a
    configuration keeps each one's profiler sessions few: in one process
    the profiler lost more kernel records the more sessions came before
    (PERF.md, section 6)."""
    import torch
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernel_rows = json.loads(Path(rows_path).read_text())
    smi = nvidia_smi()
    if tag == BATCHED_TAG:
        launches, profiled = batched_config(dev, launch_counts(), smi)
        Path(out_path).write_text(json.dumps([launches, {}, {}, profiled]))
        return 0
    if tag == STREAM_TAG:
        launches = stream_config(dev, launch_counts(), smi)
        Path(out_path).write_text(json.dumps([launches, {}, {}, {}]))
        return 0
    if tag == PIPE_TAG:
        launches = pipeline_config(dev, launch_counts(), smi)
        Path(out_path).write_text(json.dumps([launches, {}, {}, {}]))
        return 0
    if tag == PROCS_TAG:
        launches = procs_config(dev, launch_counts(), smi)
        Path(out_path).write_text(json.dumps([launches, {}, {}, {}]))
        return 0
    if tag == TP_TAG:
        launches = tp_config(dev, launch_counts(), kernel_rows, smi)
        Path(out_path).write_text(json.dumps([launches, {}, {}, {}]))
        return 0
    if tag == EVAL_TAG:
        launches = eval_config(dev, launch_counts(), kernel_rows, smi)
        Path(out_path).write_text(json.dumps([launches, {}, {}, {}]))
        return 0
    *results, served = serve_config(tag, dev, launch_counts(), kernel_rows,
                                    smi)
    if tag == "7b_int8":
        bucket_and_force_runs(*served, smi)
    Path(out_path).write_text(json.dumps(results))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--serve"]:
        return serve_child(*sys.argv[2:5])
    if sys.argv[1:2] == ["--stage"]:
        return stage_child(*sys.argv[2:6])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "flowspec_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)

    # 2. build
    from flowspec_tpu_torch.ops import _build
    t0 = time.perf_counter()
    per_kernel = _build.build()
    build_s = time.perf_counter() - t0
    logs = {n: _build.lib_path(n).with_suffix(".log").read_text()
            for n in _build.KERNELS}
    (OUT_DIR / "ptxas.log").write_text("\n".join(
        f"== {n}\n{log}" for n, log in logs.items()))
    emit({"phase": "build", "seconds": build_s, "per_kernel_s": per_kernel,
          "ptxas": {n: ptxas_summary(log) for n, log in logs.items()}})

    # 3. kernels at the shapes of the three serve paths
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.zeros(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    details = []
    kernel_rows = {
        "int8_matmul": check_int8(dev, gen, flush, details),
        "tree_attention": {**check_attention(dev, gen, flush, details),
                           **check_attention_lanes(dev, gen, flush,
                                                   details)},
        "head_topk": check_head(dev, gen, flush, details),
        "nf4_matmul": check_packed4("nf4_matmul", NF4_SHAPES, dev, gen,
                                    flush, details),
        "int4_matmul": check_packed4("int4_matmul", INT4_SHAPES, dev, gen,
                                     flush, details),
        "int4_matmul_smallm": check_packed4(
            "int4_matmul_smallm", INT4_SMALLM_SHAPES, dev, gen, flush,
            details),
    }
    del flush
    with open(OUT_DIR / "chip_smoke_kernels.jsonl", "w") as f:
        for row in details:
            f.write(json.dumps(row) + "\n")
    emit({"phase": "kernels", "checked": len(details),
          "all_ok": all(r["ok"] for r in details),
          "main_shapes": {n: kernel_rows[n][s] for n, s in MAIN.items()}})

    # 4-6. the configurations through the entry points, each in a process
    # of its own (`serve_child`), one after another; then the lm_head
    counters = launch_counts()
    rows_path = OUT_DIR / "chip_smoke_rows.json"
    rows_path.write_text(json.dumps(kernel_rows))
    torch.cuda.empty_cache()
    by_config, sums, ar_sums, profiled = {}, {}, {}, {}
    for tag in list(CONFIGS) + [BATCHED_TAG, STREAM_TAG, PIPE_TAG,
                                PROCS_TAG, TP_TAG, EVAL_TAG]:
        out = OUT_DIR / f"chip_smoke_{tag}.json"
        out.unlink(missing_ok=True)
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--serve", tag, str(rows_path),
                             str(out)]).returncode
        if rc != 0:
            raise AssertionError(f"{tag}: its serve process exited with {rc}")
        by_config[tag], sums[tag], ar_sums[tag], profiled[tag] = json.loads(
            out.read_text())
    lm_head_check(dev, gen, smi)
    loader_phase(dev, smi)
    launches = {n: sum(c[n] for c in by_config.values()) for n in counters}
    missing = [n for n in _build.KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"no serve path launched: {missing}")

    emit({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"flowspec_tpu_torch/csrc/{n}.cu",
         "replaces": REPLACES[n], "launches": launches[n],
         "max_abs_err": max(r["max_abs_err"]
                            for r in kernel_rows[n].values()),
         "ms": kernel_rows[n][MAIN[n]]["ms"],
         "plain_ms": kernel_rows[n][MAIN[n]]["plain_ms"],
         "bound_ms": kernel_rows[n][MAIN[n]]["bound_ms"],
         "bound_by": kernel_rows[n][MAIN[n]]["bound_by"],
         "library_ms": kernel_rows[n][MAIN[n]]["library_ms"],
         "shape": MAIN[n],
         "launches_by_config": {t: c[n] for t, c in by_config.items()},
         # per configuration: one round's launches x ms, bounds, old ms
         "round_ms": {t: v[n] for t, v in sums.items() if n in v},
         # per configuration: device ms a round of the kernel's family
         # under torch.profiler, eager and inside the replayed graph, for
         # the requests profiled where the family ran (nothing is filled
         # in for a request that was not profiled)
         "profiled_round_ms": {
             t: {m: fam[n] for m, fam in p.items() if n in fam}
             for t, p in profiled.items()},
         "ar_step_ms": {t: v[n] for t, v in ar_sums.items() if n in v},
         # a redesigned kernel's earlier version, an entry point of the same
         # library for comparison only (0 launches on every serve path),
         # timed in turns with it in this run
         "old": old_entry(n, kernel_rows[n], launches)}
        for n in _build.KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
