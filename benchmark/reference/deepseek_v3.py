"""Plain float32 reference of DeepSeek-V3 (the family `deepseek_v3`).

The forward pass of the published `modeling_deepseek.py`
(huggingface.co/deepseek-ai/DeepSeek-V3), in its non-absorbed form:
token embedding; per layer RMSNorm, then multi-head latent attention
(q = q_b(RMSNorm(q_a(h))) split per head into nope and rope dims;
kv_a(h) split into c_kv, RMSNorm'd, and one k_pe for every head;
k_nope and v per head from kv_b(c_kv); YaRN rope on q_pe and k_pe after
the de-interleave of their dims; causal softmax at (nope + rope)^-1/2 x
mscale^2; o_proj) and a residual; RMSNorm, then the layer's MLP and a
residual: a SwiGLU for the first `first_k_dense_replace` layers, else the
MoE (sigmoid router scores in float32; the selection bias added for the
choice only; the 8 groups scored by the sum of their two best biased
scores, `topk_group` kept; the `num_experts_per_tok` best experts of
those; their unbiased scores normalised and x `routed_scaling_factor`;
the shared expert on every token); a final RMSNorm and the lm_head.

The expert share is the program's: the configuration holds `held` routed
experts of the router's `routed` (`experts`), and the layer adds only the
held experts' part of the mixture, plus the shared expert, as one card of
its expert-parallel deployment computes it. Ties in both selections go to
the lower index (torch.topk promises no order). Everything is float32 with
TF32 off, one layer at a time over every sequence.

It imports nothing of the program. It reads the weights the benchmark drew
(`benchmark/families/deepseek_v3.py draw`): stacked tensors under
"attn" (every layer), "dense" (the dense layers) and "moe" (the MoE
layers, whose expert stacks hold the held experts and then the shared
one, each matrix stored (Out, In) as the published checkpoint's
`nn.Linear` weights; `moe_weights` reads them as (In, Out)).
`weight(leaf, i)` gives layer i's float32 matrix
(`benchmark/reference/precision.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.decoder import float32_exact, rms_norm
from benchmark.reference.precision import exact

QUERY_BLOCK = 512           # query rows a block: bounds the score matrix


def experts(cfg: dict) -> tuple:
    """(routed experts of the router, ids of the held ones): the published
    count and this card's share of its expert-parallel deployment."""
    routed = cfg["published"]["n_routed_experts"]
    share = cfg["expert_share"]
    lo = share["rank"] * cfg["n_routed_experts"]
    return routed, list(range(lo, lo + cfg["n_routed_experts"]))


def log(x) -> float:
    return float(torch.tensor(float(x), dtype=torch.float64).log())


def yarn_mscale(factor, mscale):
    return 1.0 if factor <= 1 else 0.1 * mscale * log(factor) + 1.0


def rope_tables(t, cfg, device):
    """(cos, sin) (t, rope dims) of positions 0..t-1 under the config's
    rope (YaRN when `rope_scaling` is given)."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    freq = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim)
    scale = cfg.get("rope_scaling")
    m = 1.0
    if scale:
        factor, orig = scale["factor"], scale["original_max_position_embeddings"]

        def corr(rot):
            return dim * log(orig / (rot * 2 * torch.pi)) / (2 * log(base))
        low = max(int(corr(scale["beta_fast"]) // 1), 0)
        high = min(int(-(-corr(scale["beta_slow"]) // 1)), dim - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
                 - low) / (high - low)).clamp(0, 1)
        freq = freq / factor * ramp + freq * (1 - ramp)
        m = (yarn_mscale(factor, scale["mscale"])
             / yarn_mscale(factor, scale["mscale_all_dim"]))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * freq
    emb = torch.cat([ang, ang], -1)
    return emb.cos() * m, emb.sin() * m


def rope(x, cos, sin):
    """x (heads, T, d): de-interleave (pairs (2i, 2i+1) to (i, i + d/2)),
    then rotate-half rope."""
    h, t, d = x.shape
    x = x.view(h, t, d // 2, 2).transpose(-1, -2).reshape(h, t, d)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def softmax_scale(cfg):
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def attention(x, lw, cfg, dt):
    """Multi-head latent attention over one sequence's rows x (T, H),
    causal, non-absorbed: per-head K and V from kv_b."""
    t = x.shape[0]
    nh, dn = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    dr, dv, r = (cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                 cfg["kv_lora_rank"])
    eps = cfg["rms_norm_eps"]
    qa = rms_norm((x @ lw["wq_a"]).float(), lw["q_a_ln"].float(), eps).to(dt)
    q = (qa @ lw["wq_b"]).float().view(t, nh, dn + dr).transpose(0, 1)
    kv = x @ lw["wkv_a"]
    c = rms_norm(kv[:, :r].float(), lw["kv_a_ln"].float(), eps).to(dt)
    kvb = (c @ lw["wkv_b"]).float().view(t, nh, dn + dv).transpose(0, 1)
    cos, sin = rope_tables(t, cfg, x.device)
    q_pe = rope(q[..., dn:], cos, sin)
    k_pe = rope(kv[:, r:].float().view(1, t, dr), cos, sin)
    qf = torch.cat([q[..., :dn], q_pe], -1)
    kf = torch.cat([kvb[..., :dn], k_pe.expand(nh, t, dr)], -1)
    v = kvb[..., dn:]
    scale = softmax_scale(cfg)
    out = torch.empty((nh, t, dv), device=x.device)
    keys = torch.arange(t, device=x.device)
    for lo in range(0, t, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, t)
        s = qf[:, lo:hi] @ kf[:, :hi].transpose(1, 2) * scale
        s.masked_fill_(keys[None, :hi] > keys[lo:hi, None], float("-inf"))
        out[:, lo:hi] = torch.softmax(s, -1) @ v[:, :hi]
    return out.transpose(0, 1).reshape(t, nh * dv).to(dt) @ lw["wo"]


def select(scores, bias, cfg):
    """Group-limited top-k over the router's f32 `scores` (T, E) with the
    selection bias: (expert ids (T, k), weights (T, k), the smaller of the
    group cut's and the expert cut's margin per row, on biased scores)."""
    t, e = scores.shape
    g, kg, k = cfg["n_group"], cfg["topk_group"], cfg["num_experts_per_tok"]
    choice = scores + bias
    groups = choice.view(t, g, e // g)
    two = torch.sort(groups, -1, descending=True).values[..., :2].sum(-1)
    gs, gi = torch.sort(two, dim=-1, descending=True, stable=True)
    group_margin = (gs[:, kg - 1] - gs[:, kg] if kg < g
                    else torch.full((t,), float("inf"), device=gs.device))
    kept = torch.zeros((t, g), dtype=torch.bool, device=scores.device)
    kept[torch.arange(t, device=scores.device)[:, None], gi[:, :kg]] = True
    masked = torch.where(kept.repeat_interleave(e // g, 1), choice,
                         torch.full_like(choice, float("-inf")))
    ms, mi = torch.sort(masked, dim=-1, descending=True, stable=True)
    expert_margin = ms[:, k - 1] - ms[:, k]
    ids = mi[:, :k]
    w = scores.gather(1, ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    return ids, w, torch.minimum(group_margin, expert_margin)


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe(x, lw, cfg, held):
    """This card's part of the mixture over x (T, H): the held experts'
    weighted outputs plus the shared expert; and each row's margin."""
    scores = torch.sigmoid(x.float() @ lw["router"].float())
    ids, w, margin = select(scores, lw["score_bias"].float(), cfg)
    n_held = len(held)
    out = swiglu(x, lw["w_gate"][n_held], lw["w_up"][n_held],
                 lw["w_down"][n_held])
    for j, e in enumerate(held):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel():
            ye = swiglu(x[rows], lw["w_gate"][j], lw["w_up"][j],
                        lw["w_down"][j])
            out = out.index_add(0, rows, ye * w[rows, slot, None].to(x.dtype))
    return out, margin


def layer(x, i, lw, cfg, held):
    """Decoder layer i over one sequence's x (T, H): (x, router margin per
    row, +inf for a dense layer)."""
    dt, eps = x.dtype, cfg["rms_norm_eps"]
    h = rms_norm(x.float(), lw["input_ln"].float(), eps).to(dt)
    x = x + attention(h, lw, cfg, dt)
    h = rms_norm(x.float(), lw["post_ln"].float(), eps).to(dt)
    if i < cfg["first_k_dense_replace"]:
        return x + swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"]), \
            torch.full((x.shape[0],), float("inf"), device=x.device)
    y, margin = moe(h, lw, cfg, held)
    return x + y, margin


EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def moe_weights(moe: dict, j: int, weight=exact, dtype=torch.float32):
    """MoE layer j's weights for `moe`: the router and the expert stacks
    (read (In, Out), so that a control's per-column precision is per output
    column) in `dtype`, the selection bias in float32."""
    out = {name: weight(leaf.transpose(-1, -2) if name in EXPERT_STACKS
                        else leaf, j).to(dtype)
           for name, leaf in moe.items() if name != "score_bias"}
    out["score_bias"] = moe["score_bias"][j].float()
    return out


def next_token_logits(w, cfg, seqs, rows, weight=exact,
                      dtype=torch.float32, margins=None):
    """float32 logits of the next token at `rows[i]` (positions) of each
    token sequence `seqs[i]`, one (len(rows[i]), V) tensor a sequence;
    `weight` and `dtype` as in `reference/decoder.py`. A list given as
    `margins` receives, per sequence, each row's smallest router margin
    (group cut and expert cut, biased scores) over the MoE layers."""
    _, held = experts(cfg)
    k = cfg["first_k_dense_replace"]
    with torch.no_grad(), float32_exact():
        xs = [w["embed"][s].to(dtype) for s in seqs]
        low = [torch.full((len(s),), float("inf"), device=s.device)
               for s in seqs]
        for i in range(cfg["num_hidden_layers"]):
            part, j = (("dense", i) if i < k else ("moe", i - k))
            lw = {name: weight(leaf, i).to(dtype)
                  for name, leaf in w["attn"].items()}
            lw.update({name: weight(leaf, j).to(dtype)
                       for name, leaf in w["dense"].items()}
                      if part == "dense"
                      else moe_weights(w["moe"], j, weight, dtype))
            out = [layer(x, i, lw, cfg, held) for x in xs]
            xs = [x for x, _ in out]
            low = [torch.minimum(lo, m) for lo, (_, m) in zip(low, out)]
            del lw, out
        if margins is not None:
            margins.extend(lo[r] for lo, r in zip(low, rows))
        head = w["lm_head"].float()
        norm = w["final_norm"].float()
        return [rms_norm(x[r].float(), norm, cfg["rms_norm_eps"]).to(
            dtype).float() @ head for x, r in zip(xs, rows)]
