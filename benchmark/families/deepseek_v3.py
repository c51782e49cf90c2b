"""DeepSeek-V3 (multi-head latent attention; 3 dense SwiGLU layers, then
MoE layers of 256 sigmoid-routed experts, group-limited top-8, and one
shared expert) served in bf16 as one card of an expert-parallel
deployment: the card holds `n_routed_experts` of the router's
`published.n_routed_experts` experts, those of `expert_share.rank`.

The weights are drawn from the seed (the laws of `families/common.py`,
the selection bias N(0, 0.1) in f32: wide enough beside the sigmoid
scores that a program which left it out fails the check; the note on
routing below), the port's `DeepseekParams`
are built over the same tensors (kv_b's halves copied into the absorbed
layout), and the draft is an int8 EAGLE layer of the base's hidden width
with 56 heads of 128 (it states its head dim: the base's attention has no
head dim of the draft's kind). The plain reference is
`reference/deepseek_v3.py`; the work of the served requests is `work`
(`DeepseekWork`); the MLA kernel is the trace's `mla_attention`, and the
expert products' GEMMs are the trace's `moe_experts`.
"""

from __future__ import annotations

import dataclasses

from benchmark.families.common import (
    BIAS_STD, EMBED_STD, Draw, int8_tensor,
)
from benchmark.lib import program_spans, trace
from benchmark.lib import work as served
from benchmark.lib.bounds import bound_s
from benchmark.lib.work import Dims
from benchmark.reference.deepseek_v3 import EXPERT_STACKS, experts

REFERENCE = "deepseek_v3"
KERNEL_FAMILIES = (("mla_attention", "mla_attention"),)

DRAFT_HEAD_DIM = 128
# Routing. A random model's hidden states share a direction of their own
# in each sequence (on the card, mean cosine 0.13 -> 0.42 over the MoE
# layers), so a verify's rows crowd onto a few experts: a forward reaches
# ~3.3 of the 8 held experts with a small selection bias (N(0, 0.01)) and
# ~2.4 with this one, where an even load would reach ~7.4. No static bias
# evens the first part out (one balanced on some sequences left others
# less even); the second is the price of a bias that the check can see
# (without it the program reads 0.09 against a limit of 0.025; at
# N(0, 0.03) it read 0.03, at N(0, 0.01) 0.02).


def model_config(cfg: dict):
    from flowspec_tpu_torch.config import DeepseekConfig
    routed, held = experts(cfg)
    rs = cfg["rope_scaling"]
    return DeepseekConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        tie_word_embeddings=cfg["tie_word_embeddings"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        dtype=cfg["torch_dtype"], q_lora_rank=cfg["q_lora_rank"],
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        yarn_factor=float(rs["factor"]) if rs else 0.0,
        yarn_original_max_position=(
            rs["original_max_position_embeddings"] if rs else 4096),
        yarn_beta_fast=rs["beta_fast"] if rs else 32.0,
        yarn_beta_slow=rs["beta_slow"] if rs else 1.0,
        yarn_mscale=rs["mscale"] if rs else 1.0,
        yarn_mscale_all_dim=rs["mscale_all_dim"] if rs else 1.0,
        n_routed_experts=routed, n_shared_experts=cfg["n_shared_experts"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        n_group=cfg["n_group"], topk_group=cfg["topk_group"],
        routed_scaling_factor=cfg["routed_scaling_factor"],
        held_experts=tuple(held))


def draw(cfg: dict, draw: Draw) -> dict:
    """The base's weights: "attn" over every layer, "dense" over the dense
    ones, "moe" over the MoE ones (experts (Lm, held + shared, Out, In),
    the published checkpoint's layout, the held experts first), stacked
    along a leading layer axis, and the
    "layout" the port's params need (the held ids, heads, nope dims). The
    port's DeepSeek classes are imported first: a program without them
    fails here, before a weight is drawn."""
    from flowspec_tpu_torch.models.deepseek import DeepseekParams  # noqa
    n, h = cfg["num_hidden_layers"], cfg["hidden_size"]
    nd = min(cfg["first_k_dense_replace"], n)
    nm = n - nd
    nh, dn, dr = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                  cfg["qk_rope_head_dim"])
    dv, qr, r = cfg["v_head_dim"], cfg["q_lora_rank"], cfg["kv_lora_rank"]
    i, ie, v = (cfg["intermediate_size"], cfg["moe_intermediate_size"],
                cfg["vocab_size"])
    routed, held = experts(cfg)
    ne = len(held) + cfg["n_shared_experts"]
    m = draw.matrix
    attn = {"wq_a": m(n, h, qr), "q_a_ln": draw.norm(n, qr),
            "wq_b": m(n, qr, nh * (dn + dr)), "wkv_a": m(n, h, r + dr),
            "kv_a_ln": draw.norm(n, r), "wkv_b": m(n, r, nh * (dn + dv)),
            "wo": m(n, nh * dv, h), "input_ln": draw.norm(n, h),
            "post_ln": draw.norm(n, h)}
    dense = {"w_gate": m(nd, h, i), "w_up": m(nd, h, i),
             "w_down": m(nd, i, h)}
    bias = draw.normal(nm, routed, std=BIAS_STD)
    moe = {"router": m(nm, h, routed), "score_bias": bias.float(),
           "w_gate": draw.normal(nm, ne, ie, h, std=h ** -0.5),
           "w_up": draw.normal(nm, ne, ie, h, std=h ** -0.5),
           "w_down": draw.normal(nm, ne, h, ie, std=ie ** -0.5)}
    return {"embed": draw.normal(v, h, std=EMBED_STD), "attn": attn,
            "dense": dense, "moe": moe, "final_norm": draw.norm(h),
            "lm_head": m(h, v),
            "layout": {"held": held, "heads": nh, "nope": dn}}


def port_params(w: dict):
    """The port's `DeepseekParams` over the drawn tensors, kv_b's halves
    copied into the absorbed layout, the expert stacks as (In, Out) views
    of the drawn (Out, In) ones: their products then run transposed
    GEMMs, whose kernels no dense product of the model launches, so the
    trace can tell the expert products by name (`expert_gemm_names`)."""
    from flowspec_tpu_torch.models.deepseek import (
        DeepseekAttnParams, DeepseekDenseParams, DeepseekMoeParams,
        DeepseekParams, absorb_kv_b,
    )
    a, lay = dict(w["attn"]), w["layout"]
    w_uk, w_uv = absorb_kv_b(a.pop("wkv_b"), lay["heads"], lay["nope"])
    return DeepseekParams(
        embed=w["embed"], final_norm=w["final_norm"], lm_head=w["lm_head"],
        attn=DeepseekAttnParams(w_uk=w_uk, w_uv=w_uv, **a),
        dense=DeepseekDenseParams(**w["dense"]),
        moe=DeepseekMoeParams(**{k: (v.transpose(-1, -2)
                                     if k in EXPERT_STACKS else v)
                                  for k, v in w["moe"].items()}))


def draft(cfg: dict, draw: Draw, w: dict):
    """A random EAGLE layer in int8 at the base's hidden width: fc 2H -> H,
    56 heads of 128 (MHA, plain rope at the base's theta), a SwiGLU of
    `intermediate_size`, on the base's embedding."""
    from flowspec_tpu_torch.draft.eagle import SizedEagleParams
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    q8 = lambda *s: int8_tensor(draw.int8(*s))
    return SizedEagleParams(
        embed=w["embed"], fc_w=q8(2 * h, h),
        fc_b=draw.normal(h, std=EMBED_STD),
        wq=q8(h, h), wk=q8(h, h), wv=q8(h, h), wo=q8(h, h),
        w_gate=q8(h, i), w_up=q8(h, i), w_down=q8(i, h),
        post_ln=draw.norm(h), head_dim=DRAFT_HEAD_DIM)


# ---- the work of the served requests ---------------------------------------

def moe_loads(spans) -> dict | None:
    """The routing counts (`pairs`, `reached`, `forwards`, `rows`) summed
    over the program's `moe.load` spans given (`runtime/engine.py`), or
    None where there is none (the recorder off, or a program without
    them)."""
    vals = [s.values for s in spans
            if s.name == "moe.load" and getattr(s, "values", None)]
    if not vals:
        return None
    return {k: sum(v[k] for v in vals)
            for k in ("pairs", "reached", "forwards", "rows")}


def request_loads(reqs) -> dict | None:
    """`moe_loads` over the `moe.load` spans of `reqs`: each served
    request's one program `request` span inside its ns0 .. ns1, and that
    request's `moe.load`; None unless every request has both."""
    every = program_spans.spans()
    heads = [s for s in every if s.name == "request"]
    loads = {s.request: s for s in every if s.name == "moe.load"}
    out = []
    for r in reqs:
        inside = [h for h in heads if r.ns0 <= h.t0_ns and h.t1_ns <= r.ns1]
        if len(inside) != 1 or inside[0].request not in loads:
            return None
        out.append(loads[inside[0].request])
    return moe_loads(out)


@dataclasses.dataclass(frozen=True)
class DeepseekWork:
    """The work the served requests needed (`families/__init__.py` work):
    the base's share on this card (`lib/work.py` request model: chunked
    prefill, then a verify of the tree's rows a round), the draft, its
    beam head and the lm_head (`draft`: the LLaMA-style `Dims` of the
    draft with no base layers)."""
    draft: Dims
    layers: int
    dense_layers: int
    hidden: int
    inter: int
    expert_inter: int
    heads: int
    nope: int
    rope: int
    v_dim: int
    q_rank: int
    kv_rank: int
    routed: int
    held: int
    shared: int
    per_token: int

    @classmethod
    def of(cls, cfg: dict, mix: dict) -> "DeepseekWork":
        routed, held = experts(cfg)
        draft = dataclasses.replace(
            Dims.of(cfg, mix), layers=0, nq=cfg["hidden_size"]
            // DRAFT_HEAD_DIM, nkv=cfg["hidden_size"] // DRAFT_HEAD_DIM,
            head_dim=DRAFT_HEAD_DIM, experts=0, experts_per_token=0,
            base_int8=False)
        return cls(
            draft=draft, layers=cfg["num_hidden_layers"],
            dense_layers=min(cfg["first_k_dense_replace"],
                             cfg["num_hidden_layers"]),
            hidden=cfg["hidden_size"], inter=cfg["intermediate_size"],
            expert_inter=cfg["moe_intermediate_size"],
            heads=cfg["num_attention_heads"], nope=cfg["qk_nope_head_dim"],
            rope=cfg["qk_rope_head_dim"], v_dim=cfg["v_head_dim"],
            q_rank=cfg["q_lora_rank"], kv_rank=cfg["kv_lora_rank"],
            routed=routed, held=len(held), shared=cfg["n_shared_experts"],
            per_token=cfg["num_experts_per_tok"])

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers

    # ---- the hooks the frozen readers ask -------------------------------
    def attention_bound_s(self, reqs) -> float:
        """The GQA kernel serves the draft alone."""
        return served.attention_bound_s(reqs, self.draft)

    def int8_bound_s(self, reqs) -> float:
        """The draft's int8 products (the base is bf16)."""
        return served.int8_bound_s(reqs, self.draft)

    def head_bound_s(self, reqs) -> float:
        return served.head_bound_s(reqs, self.draft)

    def moe_bound_s(self, reqs):
        """The expert products' bound on this card: `expert_share_bound_s`
        over the program's routing counts of `reqs` (None where it
        recorded none)."""
        loads = request_loads(reqs)
        return None if loads is None else self.expert_share_bound_s(
            reqs, loads)

    def model_flops(self, reqs) -> float:
        """The draft, its beam head and the lm_head (`lib/work.py
        model_flops` with no base layers), and the base's share: every
        prefill token and verified row through the MLA projections, the
        latent attention over the keys each call reads, the dense SwiGLUs,
        and in each MoE layer the router, the shared expert and the routed
        (row, held expert) pairs, at the rate the program's counter read
        over the recorded requests (else the expected top-k x held /
        routed)."""
        per_row = self.per_token * self.held / self.routed
        loads = moe_loads(program_spans.spans())
        if loads and loads["rows"]:
            per_row = loads["pairs"] / loads["rows"]
        h, e = self.hidden, self.expert_inter
        swiglu = 6.0 * h * e
        row = (self.layers * self.attn_row_flops()
               + self.dense_layers * 6.0 * h * self.inter
               + self.moe_layers * (2.0 * h * self.routed + swiglu
                                    * (self.shared + per_row)))
        f = served.model_flops(reqs, self.draft)
        for r in reqs:
            for c in served.base_calls(r, self.draft):
                f += c.rows * row + self.layers * self.mla_work(c)[1]
        return f

    # ---- this family's own -----------------------------------------------
    def attn_row_flops(self) -> float:
        """One row through a layer's MLA projections, absorbed form."""
        h, nh, qr, r = self.hidden, self.heads, self.q_rank, self.kv_rank
        return 2.0 * (h * qr + qr * nh * (self.nope + self.rope)
                      + h * (r + self.rope) + nh * self.nope * r
                      + nh * r * self.v_dim + nh * self.v_dim * h)

    def mla_work(self, call: served.Call) -> tuple:
        """(bytes, FLOPs) of one latent attention launch: the latent rows up
        to its keys, q and out once (bf16); every query row of every head
        against every key, 576-deep scores and 512-wide values."""
        c = self.kv_rank + self.rope
        t = call.rows * self.heads
        n_bytes = call.keys * c * 2 + t * c * 2 + t * self.kv_rank * 2
        return n_bytes, 2.0 * t * call.keys * (c + self.kv_rank)

    def mla_bound_s(self, reqs) -> float:
        return sum(self.layers * bound_s(*self.mla_work(c))
                   for r in reqs for c in served.base_calls(r, self.draft)
                   if c.rows)

    def expert_share_bound_s(self, reqs, loads: dict) -> float:
        """The expert products of the base forwards of `reqs`, with their
        routing counts `loads` (`moe_loads` over the same requests): the
        bf16 weights of the held experts reached and of the shared
        experts read once a forward, the rows in and out once, each routed
        pair and each row's shared experts computed. A forward here has at
        most a few hundred rows, below the ~295 rows an expert at which the
        card turns compute-bound, so every forward is bound by its bytes
        and their sum is the sum of the forwards' bounds."""
        h, e = self.hidden, self.expert_inter
        w_bytes = 3 * h * e * 2
        rows = self.moe_layers * sum(c.rows for r in reqs
                                     for c in served.base_calls(r, self.draft))
        n_bytes = ((loads["reached"] + loads["forwards"] * self.shared)
                   * w_bytes + 2 * rows * h * 2)
        flops = 6.0 * h * e * (loads["pairs"] + rows * self.shared)
        return bound_s(n_bytes, flops)




def work(cfg: dict, mix: dict) -> DeepseekWork:
    return DeepseekWork.of(cfg, mix)


def expert_gemm_names(eng, cfg: dict, mix: dict, device) -> frozenset:
    """The GEMM kernels of the expert products (held experts and the
    shared one, one batched product each of gate, up and down): those one
    MoE layer's `moe_block` launches at the row counts of the cell's base
    forwards, less those of the MLA projections and absorptions, the
    router, a dense layer's SwiGLU and the lm_head at the same rows
    (`lib/trace.py moe_gemm_names`' rule: a shared name stays cuBLAS)."""
    import torch
    from flowspec_tpu_torch.models.deepseek import moe_block
    from flowspec_tpu_torch.models.llama import lm_head_logits
    from flowspec_tpu_torch.ops.quant import matmul_f32_out, qmatmul
    from torch.profiler import ProfilerActivity, profile
    p, mc = eng.params, eng.cfg.model

    def gemms(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {name for name, _, _ in trace.device_events(prof)
                if any(k in name.lower() for k in trace.GEMM_KEYS)}

    rows = (mix["engine"]["prefill_chunk"], eng.cfg.tree.node_cap)
    xs = [torch.randn((1, t, mc.hidden_size), device=device).to(
        torch.bfloat16) for t in rows]
    mp, ap, dp = p.moe.layer(0), p.attn.layer(0), p.dense.layer(0)

    def dense_products(x):
        t = x.shape[1]
        qa = qmatmul(x, ap.wq_a)
        qmatmul(qa, ap.wq_b)
        qmatmul(x, ap.wkv_a)
        q_nope = torch.zeros((mc.num_attention_heads, t, mc.qk_nope_head_dim),
                             dtype=x.dtype, device=device)
        o_lat = torch.matmul(q_nope, ap.w_uk)
        o = torch.matmul(o_lat, ap.w_uv).transpose(0, 1).reshape(1, t, -1)
        qmatmul(o, ap.wo)
        matmul_f32_out(x, mp.router)
        qmatmul(qmatmul(x, dp.w_gate) * qmatmul(x, dp.w_up), dp.w_down)
        lm_head_logits(p, x)

    moe = gemms(lambda: [moe_block(x, mp, mc) for x in xs])
    dense = gemms(lambda: [dense_products(x) for x in xs])
    if not moe - dense:
        raise RuntimeError("expert_gemm_names: every GEMM kernel of the "
                           f"expert products is a dense one's: {sorted(moe)}")
    return frozenset(moe - dense)
