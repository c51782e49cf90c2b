"""DeepSeek-V3 in the port (`models/deepseek.py`) against the benchmark's
plain float32 reference (`benchmark/reference/deepseek_v3.py`), on a tiny
DeepSeek-shaped configuration in float32 on the CPU: 2 dense + 2 MoE
layers, 16 routed experts in 4 groups of which 2 are kept, top-4, one
shared expert, YaRN on (with an original context of 32 positions, so the
interpolated frequencies move within the test's positions).

Tolerances. The port and the reference compute the same float32 products
in other orders (absorbed against non-absorbed attention, a batched mixture
against a loop over experts): their logits agree to ~1e-5 of their scale.
`TOL` (2e-4 absolute on logits of scale ~1) leaves room for that and no
more; each comparison also checks that the reference computed in bfloat16,
without the selection bias or without YaRN, lies at least ten times
further away, so the tolerance would catch any of them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.families import deepseek_v3 as fam
from benchmark.families.common import Draw
from benchmark.reference import deepseek_v3 as ref
from flowspec_tpu_torch.config import (
    DeepseekConfig, EngineConfig, ModelConfig, SamplingConfig, TreeConfig,
)
from flowspec_tpu_torch.draft.eagle import (
    EagleParams, SizedEagleParams, draft_view, init_eagle_params,
)
from flowspec_tpu_torch.models import init_base_cache, model_forward
from flowspec_tpu_torch.models import deepseek as ds
from flowspec_tpu_torch.models.bias import prefill_bias, tree_bias
from flowspec_tpu_torch.models.llama import final_hidden, lm_head_logits
from flowspec_tpu_torch.ops.mla_attention import mla_attention_plain
from flowspec_tpu_torch.ops.tree_attention import tree_attention_plain
from flowspec_tpu_torch.runtime.engine import SpecEngine
from flowspec_tpu_torch.utils.profiler import prof

TOL = 2e-4

TINY = {
    "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
    "num_hidden_layers": 4, "first_k_dense_replace": 2,
    "num_attention_heads": 4, "num_key_value_heads": 4, "q_lora_rank": 32,
    "kv_lora_rank": 24, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "n_routed_experts": 16,
    "published": {"n_routed_experts": 16}, "expert_share": {"ep": 1,
                                                            "rank": 0},
    "n_group": 4, "topk_group": 2, "num_experts_per_tok": 4,
    "n_shared_experts": 1, "routed_scaling_factor": 2.5,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 1, "mscale_all_dim": 1,
                     "original_max_position_embeddings": 32,
                     "type": "yarn"},
    "rope_theta": 10000, "rms_norm_eps": 1e-6, "vocab_size": 96,
    "tie_word_embeddings": False, "torch_dtype": "float32",
}


def share(cfg, ep, rank):
    """`cfg` cut to rank `rank` of `ep` expert-parallel cards."""
    n = cfg["published"]["n_routed_experts"] // ep
    return {**cfg, "n_routed_experts": n,
            "expert_share": {"ep": ep, "rank": rank}}


def drawn(cfg=TINY, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return fam.draw(cfg, Draw(gen, "cpu", torch.float32))


@pytest.fixture(scope="module")
def tiny():
    w = drawn()
    return w, fam.port_params(w), fam.model_config(TINY)


def reference(w, cfg, seqs, **kw):
    seqs = [torch.as_tensor(s, dtype=torch.long) for s in seqs]
    rows = [torch.tensor([len(s) - 1]) for s in seqs]
    return torch.cat(ref.next_token_logits(w, cfg, seqs, rows, **kw))


def without_yarn(cfg):
    return {**cfg, "rope_scaling": None}


def without_bias(w):
    return {**w, "moe": {**w["moe"],
                         "score_bias": torch.zeros_like(w["moe"]
                                                        ["score_bias"])}}


def assert_close_and_separating(got, w, cfg, seqs):
    """`got` within TOL of the reference's logits of `seqs`, and the
    reference in bf16, without the bias and without YaRN each at least ten
    times TOL away from it."""
    want = reference(w, cfg, seqs)
    err = (got - want).abs().max().item()
    assert err < TOL, err
    for what, other in (
            ("bf16", reference(w, cfg, seqs, dtype=torch.bfloat16)),
            ("no bias", reference(without_bias(w), cfg, seqs)),
            ("no yarn", reference(w, without_yarn(cfg), seqs))):
        assert (other - want).abs().max().item() > 10 * TOL, what


def test_prefill_then_tree_verify_through_the_latent_cache(tiny):
    """A prompt prefilled in two chunks, then a tree of 6 nodes verified at
    the committed length: each node's logits equal the reference's full
    causal forward over the prompt and the node's root path."""
    w, params, mc = tiny
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, mc.vocab_size, 21).tolist()
    s_max = 64
    cache = init_base_cache(mc, 1, s_max, torch.float32, "cpu")
    assert cache.v is None and cache.k.shape == (4, 1, 1, s_max, 32)
    for lo in (0, 12):
        toks = torch.tensor(prompt[lo:lo + 12])
        t = len(toks)
        start = torch.tensor([lo], dtype=torch.int32)
        hidden = params.embed[toks][None]
        pos = start[:, None] + torch.arange(t)
        _, cache = model_forward(params, cache, hidden, pos,
                                 prefill_bias(start, t, s_max), start, mc)
    parents = [-1, 0, 0, 1, 3, 2]
    tokens = rng.integers(0, mc.vocab_size, len(parents)).tolist()
    depth = [0] * len(parents)
    for i, p in enumerate(parents):
        depth[i] = 0 if p < 0 else depth[p] + 1
    n = len(parents)
    anc = torch.zeros((1, n, n), dtype=torch.bool)
    for i in range(n):
        j = i
        while j >= 0:
            anc[0, i, j] = True
            j = parents[j]
    commit = torch.tensor([len(prompt)], dtype=torch.int32)
    bias = tree_bias(torch.where(anc, 0.0, -1e9), commit, s_max)
    hidden = params.embed[torch.tensor(tokens)][None]
    pos = commit[:, None] + torch.tensor(depth)[None]
    out, _ = model_forward(params, cache, hidden, pos, bias, commit, mc)
    got = lm_head_logits(params, final_hidden(params, out, mc))[0]
    paths = []
    for i in range(n):
        path, j = [], i
        while j >= 0:
            path.insert(0, tokens[j])
            j = parents[j]
        paths.append(prompt + path)
    assert_close_and_separating(got, w, TINY, paths)


def tiny_draft(params):
    """An f32 EAGLE layer of width 64 with 2 heads of its own head dim 32
    (the base's attention has 4 latent heads)."""
    gen = torch.Generator().manual_seed(7)
    base = ModelConfig(vocab_size=96, hidden_size=64, intermediate_size=96,
                       num_attention_heads=2, num_key_value_heads=2,
                       num_hidden_layers=1, dtype="float32")
    d = init_eagle_params(gen, base, embed=params.embed, device="cpu")
    return SizedEagleParams(**{f.name: getattr(d, f.name)
                               for f in dataclasses.fields(d)}, head_dim=32)


def tiny_engine(params, mc, buckets=(128,)):
    tc = TreeConfig(top_k=4, depth=3, total_tokens=12, node_cap=16,
                    leaf_cap=16, depth_cap=8)
    cfg = EngineConfig(model=mc, tree=tc, sampling=SamplingConfig(),
                       max_seq_len=200, prefill_chunk=16, kv_buckets=buckets)
    return SpecEngine(params, tiny_draft(params), cfg, device="cpu")


def test_generate_fused_greedy_equals_ar_and_records_the_moe_load(tiny):
    """Speculative decoding through the latent cache (prefill chunks, KV
    growth 128 -> 256 rows, tree verifies and compaction) serves AR
    greedy's tokens; with the recorder on, one `moe.load` span a request
    carries the device counts: a forward per MoE layer of every prefill
    chunk and round, its rows, and pairs equal to the per-expert sum; with
    it off, the forwards add nothing to the tally."""
    _, params, mc = tiny
    eng = tiny_engine(params, mc)
    assert draft_view(eng.draft, mc).head_dim_ == 32
    prompt = np.random.default_rng(2).integers(0, 96, 40).tolist()
    ar, _ = eng.generate_ar(prompt, max_new_tokens=100, eos_token_id=-1)
    prof.reset()
    prof.enabled = True
    try:
        spec, stats = eng.generate_fused(prompt, max_new_tokens=100,
                                         eos_token_id=-1)
    finally:
        prof.enabled = False
    assert spec == ar and stats["kv_buckets_used"] == 2
    loads = [s for s in prof.spans if s.name == "moe.load"]
    counted = prof.counters["moe_loads"]
    prof.reset()
    assert len(loads) == 1 and counted == 1
    v = loads[0].values
    chunks = -(-len(prompt) // 16)
    assert v["forwards"] == 2 * (chunks + stats["rounds"])
    assert v["rows"] == 2 * (chunks * 16 + stats["rounds"] * 13)
    assert v["pairs"] == sum(v["per_expert"]) > 0
    assert 0 < v["reached"] <= 16 * v["forwards"]
    tally = prof.tally("moe.load", len(v["per_expert"]) + 3, "cpu",
                       ds.load_values, "moe_loads")
    assert not tally.any()
    eng.generate_fused(prompt, max_new_tokens=20, eos_token_id=-1)
    assert not tally.any()


def test_router_matches_the_reference_with_ties_and_a_flipping_bias():
    """`route` selects and weighs as the reference's `select`: on random
    scores, on scores with forced ties (equal scores inside and across
    groups: the lower index wins in both), and with a bias that flips a
    selection (the same scores choose another expert with it)."""
    mc = fam.model_config(TINY)
    gen = torch.Generator().manual_seed(3)
    scores = torch.rand((64, 16), generator=gen)
    bias = torch.randn((16,), generator=gen) * 0.1
    tied = scores.clone()
    tied[:, 1] = tied[:, 0]                 # a tie inside group 0
    tied[:, 5] = tied[:, 0]                 # and across groups
    tied[:8, 4:8] = tied[:8, 0:4]           # whole groups tied
    flip = torch.full((1, 16), 0.5)
    flip[0, 0], flip[0, 4], flip[0, 15] = 0.9, 0.62, 0.6
    flip_bias = torch.zeros(16)
    flip_bias[15] = 0.1         # group 3 overtakes group 1: 15 in, 4 out
    for s, b in ((scores, bias), (tied, bias), (tied, torch.zeros(16)),
                 (flip, flip_bias)):
        got = ds.route(s, b, mc)
        ids, wts, _ = ref.select(s, b, TINY)
        want = torch.zeros_like(s).scatter_(-1, ids, wts)
        assert torch.equal(got > 0, want > 0)
        # the same f32 formula on the same scores: rounding only
        assert torch.allclose(got, want, atol=1e-6)
    plain = ds.route(flip, torch.zeros(16), mc)[0]
    flipped = ds.route(flip, flip_bias, mc)[0]
    assert plain[4] > 0 and plain[15] == 0
    assert flipped[15] > 0 and flipped[4] == 0


def test_expert_shares_sum_to_the_uncut_layer():
    """Four expert-parallel shares of a MoE layer (4 routed experts each,
    the shared expert on every card), each the port's `moe_block` over its
    own held stack, add up, with the shared expert counted once, to the
    reference's uncut layer."""
    w = drawn()
    x = torch.randn((1, 10, 64), generator=torch.Generator().manual_seed(4))
    lw = ref.moe_weights(w["moe"], 0)
    uncut, _ = ref.moe(x[0], lw, TINY, list(range(16)))
    moe = w["moe"]
    parts = []
    for rank in range(4):
        cut = share(TINY, 4, rank)
        keep = list(range(4 * rank, 4 * rank + 4)) + [16]
        part_w = {**w, "moe": {**moe, **{k: moe[k][:, keep]
                                         for k in ("w_gate", "w_up",
                                                   "w_down")}},
                  "layout": {**w["layout"], "held": keep[:4]}}
        p = fam.port_params(part_w)
        parts.append(ds.moe_block(x, p.moe.layer(0),
                                  fam.model_config(cut))[0])
    shared = ref.swiglu(x[0], lw["w_gate"][16], lw["w_up"][16],
                        lw["w_down"][16])
    total = sum(parts) - 3 * shared
    # f32 sums of the same products in another order (outputs ~0.1-1)
    assert torch.allclose(total, uncut, atol=1e-5)


def test_mla_plain_equals_softmax_attention_over_the_expanded_kv():
    """The absorbed latent attention, its output taken through kv_b's value
    half, equals plain softmax attention of the non-absorbed per-head q /
    K / V (`tree_attention_plain`) over a tree bias with dead rows."""
    gen = torch.Generator().manual_seed(5)
    nh, dn, dr, r, dv, t, s = 4, 16, 8, 24, 16, 6, 256
    q = torch.randn((1, nh, t, dn + dr), generator=gen)
    latent = torch.randn((1, s, r + dr), generator=gen)
    wkv_b = torch.randn((r, nh * (dn + dv)), generator=gen) * r ** -0.5
    w_uk, w_uv = ds.absorb_kv_b(wkv_b, nh, dn)
    bias = torch.where(torch.rand((t, s), generator=gen) < 0.7, 0.0, -1e9)
    bias[:, 40:] = -1e9
    q_abs = torch.cat([torch.matmul(q[0, ..., :dn], w_uk)[None],
                       q[..., dn:]], -1)
    o_lat = mla_attention_plain(q_abs, latent, bias, n_valid=40, scale=0.3,
                                v_dim=r)
    got = torch.matmul(o_lat[0], w_uv)
    kvb = (latent[0, :, :r] @ wkv_b).view(s, nh, dn + dv).transpose(0, 1)
    k = torch.cat([kvb[..., :dn], latent[0, :, r:].expand(nh, s, dr)], -1)
    v = kvb[..., dn:]
    want = tree_attention_plain(q * (0.3 * (dn + dr) ** 0.5), k[None],
                                torch.nn.functional.pad(v, (0, dn + dr - dv))
                                [None], bias, n_valid=40)[0, ..., :dv]
    # f32, the same products absorbed or not (outputs ~1)
    assert torch.allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("base", ["qwen2", "mixtral"])
def test_llama_family_drafts_keep_their_geometry(base):
    """The draft geometry of a Qwen2- or Mixtral-shaped base and its draft
    is the one the base's head dim gives, object for object, and a draft
    that states that same head dim gives the same config and the same
    layer output, bit for bit."""
    from flowspec_tpu_torch.draft.eagle import draft_context_forward
    from flowspec_tpu_torch.models.kv_cache import init_kv_cache
    mc = dataclasses.replace(
        ModelConfig.qwen2_7b() if base == "qwen2"
        else ModelConfig.mixtral_8x7b(), hidden_size=64,
        intermediate_size=96, num_attention_heads=4,
        num_key_value_heads=2 if base == "qwen2" else 4, vocab_size=96,
        dtype="float32")
    gen = torch.Generator().manual_seed(6)
    d = init_eagle_params(gen, mc, device="cpu")
    assert draft_view(d, mc) is mc
    sized = SizedEagleParams(**{f.name: getattr(d, f.name)
                                for f in dataclasses.fields(EagleParams)},
                             head_dim=mc.head_dim_)
    assert draft_view(sized, mc) == mc
    thin = init_eagle_params(gen, mc, width=32, n_heads=2, n_kv_heads=2,
                             inter=48, device="cpu")
    assert draft_view(thin, mc) == dataclasses.replace(
        mc, hidden_size=32, intermediate_size=48, num_attention_heads=2,
        num_key_value_heads=2, head_dim=16)
    outs = []
    for p in (d, sized):
        cache = init_kv_cache(1, 1, mc.num_key_value_heads, 256,
                              mc.head_dim_, torch.float32, "cpu")
        toks = torch.arange(1, 9, dtype=torch.int32)[None]
        hid = torch.randn((1, 8, 64), generator=torch.Generator()
                          .manual_seed(8))
        outs.append(draft_context_forward(p, cache, toks, hid, 0, 8, mc)[0])
    assert torch.equal(outs[0], outs[1])
    assert type(draft_view(tiny_draft(
        fam.port_params(drawn())), fam.model_config(TINY))) is ModelConfig
    assert not isinstance(draft_view(d, mc), DeepseekConfig)
