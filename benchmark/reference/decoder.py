"""Plain float32 reference of the LLaMA-style decoder families the
benchmark serves: the reference of a family that names no other
(`benchmark/families/__init__.py`).

The forward pass of a LLaMA-style decoder as the published model cards
describe it: token embedding; per layer RMSNorm, q / k / v projections
(with biases for Qwen2), rotary embedding (rotate-half, base
`rope_theta`), causal grouped-query attention, the output projection and a
residual; RMSNorm, then a SwiGLU MLP (Qwen2) or a sparse mixture of SwiGLU
experts (Mixtral: router softmax, top-k experts, their weights
renormalised to sum to 1) and a residual; a final RMSNorm and the lm_head.
Everything is computed in float32 with TF32 off, one layer at a time over
every sequence, so one layer's weights are made float32 once.

It imports nothing of the program: it reads the weights the benchmark
drew (`benchmark/families`), a dict of plain tensors in which an int8
weight is {"q": codes, "scale": column scales} and any other weight a
tensor, stacked along a leading layer axis. `weight(leaf, i)` gives layer
i's float32 matrix; `benchmark/reference/precision.py` holds the exact one
and the lower precisions of the control.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference.precision import exact

QUERY_BLOCK = 1024          # query rows a block: bounds the score matrix


@contextlib.contextmanager
def float32_exact():
    """float32 products in float32 (TF32 off) inside the block."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (heads, T, d) at positions 0..T-1."""
    t, d = x.shape[-2:]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q, k, v):
    """Causal attention of q (nq, T, d) over k, v (nkv, T, d), each group
    of nq / nkv query heads on one key head, in blocks of query rows."""
    nq, t, d = q.shape
    g = nq // k.shape[0]
    k, v = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
    out = torch.empty_like(q)
    keys = torch.arange(t, device=q.device)
    for lo in range(0, t, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, t)
        s = q[:, lo:hi] @ k[:, :hi].transpose(1, 2) / d ** 0.5
        s.masked_fill_(keys[None, :hi] > keys[lo:hi, None], float("-inf"))
        out[:, lo:hi] = torch.softmax(s, -1) @ v[:, :hi]
    return out


def moe(x, router, gate, up, down, top_k):
    """Sparse mixture of SwiGLU experts over the rows of x (T, H), and per
    row the router's margin: its k-th largest logit less the next one."""
    logits = x.float() @ router.float()
    top_l = torch.topk(logits, top_k + 1, -1).values
    margin = top_l[:, top_k - 1] - top_l[:, top_k]
    probs = torch.softmax(logits, -1)
    top_p, top_i = torch.topk(probs, top_k, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(router.shape[1]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel():
            xe = x[rows]
            ye = (torch.nn.functional.silu(xe @ gate[e]) * (xe @ up[e])) @ down[e]
            out.index_add_(0, rows, ye * top_p[rows, slot, None].to(x.dtype))
    return out, margin


def layer(x, lw, cfg):
    """One decoder layer over one sequence's hidden states x (T, H);
    `lw` that layer's weights in x's dtype. Norms, rotary embedding,
    attention scores and the router's softmax are float32 whatever the
    dtype; each result is cast back to it (float32: no cast at all).
    Returns (x, the router's margin per row: +inf for a dense MLP)."""
    dt = x.dtype
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg.get("head_dim", cfg["hidden_size"] // nq)
    eps = cfg["rms_norm_eps"]
    t = x.shape[0]
    h = rms_norm(x.float(), lw["input_ln"].float(), eps).to(dt)
    q, k, v = h @ lw["wq"], h @ lw["wk"], h @ lw["wv"]
    if "bq" in lw:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = rope(q.float().view(t, nq, d).transpose(0, 1), cfg["rope_theta"])
    k = rope(k.float().view(t, nkv, d).transpose(0, 1), cfg["rope_theta"])
    v = v.float().view(t, nkv, d).transpose(0, 1)
    a = attention(q, k, v).transpose(0, 1).reshape(t, nq * d).to(dt)
    x = x + a @ lw["wo"]
    h = rms_norm(x.float(), lw["post_ln"].float(), eps).to(dt)
    if "router" in lw:
        y, margin = moe(h, lw["router"], lw["w_gate"], lw["w_up"],
                        lw["w_down"], cfg["num_experts_per_tok"])
        return x + y, margin
    return x + (torch.nn.functional.silu(h @ lw["w_gate"])
                * (h @ lw["w_up"])) @ lw["w_down"], torch.full(
                    (t,), float("inf"), device=x.device)


def next_token_logits(w, cfg, seqs, rows, weight=exact,
                      dtype=torch.float32, margins=None):
    """float32 logits of the next token at `rows[i]` (positions) of each
    token sequence `seqs[i]` (1-D int64), one (len(rows[i]), V) tensor a
    sequence. `cfg`: the configuration's keys (the head dim `head_dim`,
    else hidden size / heads); `w`: the drawn weights; `weight`: how a
    weight leaf becomes float32; `dtype`: the reference's float32, or
    bfloat16 for a plain bf16 witness. A list
    given as `margins` receives, per sequence, each row's smallest router
    margin over the layers (+inf for a dense model)."""
    with torch.no_grad(), float32_exact():
        xs = [w["embed"][s].to(dtype) for s in seqs]
        low = [torch.full((len(s),), float("inf"), device=s.device)
               for s in seqs]
        layers = w["layers"]
        for i in range(cfg["num_hidden_layers"]):
            lw = {name: weight(leaf, i).to(dtype)
                  for name, leaf in layers.items()}
            out = [layer(x, lw, cfg) for x in xs]
            xs = [x for x, _ in out]
            low = [torch.minimum(lo, m) for lo, (_, m) in zip(low, out)]
            del lw, out
        if margins is not None:
            margins.extend(lo[r] for lo, r in zip(low, rows))
        head = w["lm_head"].float()
        norm = w["final_norm"].float()
        return [rms_norm(x[r].float(), norm, cfg["rms_norm_eps"]).to(
            dtype).float() @ head for x, r in zip(xs, rows)]
