"""Galaxy mode: sequence-sharded tensor parallelism with ring collectives.

Port of `flowspec_tpu/parallel/galaxy.py` (the reference's flagship TP,
tp/tp_modeling_llama.py:611-962). Between layers each rank holds T/tp rows
of the activations, and runs its norms and residual adds on them. Before
the column projections a ring all-gather reassembles the T rows, each
hop's arriving block feeding its matmul (`ring_ag_matmuls`); after the row
projections a ring reduce-scatter sums the ranks' partials and returns to
row blocks (`ring_matmul_rs`). The rings are `ring_shift`s of the TP
group's interface (`parallel/comm.py`): in-process they are list
rotations, over `torch.distributed` paired sends and receives. Weights and
KV keep the megatron layout of `parallel/tp.py`, so an engine switches
forward by forward.

Scope, as in JAX (`:176-179`): the base model's multi-row forwards of an
unquantized LLaMA-family model with one lane. A row count that tp does not
divide (the AR step, an 81-node verify at tp 2), quantized weights,
Mixtral, several lanes or a `live` mask take the plain TP forward
(`TPParams.forward`). The forward counts its calls each way (`engaged`,
`fallbacks`), so a caller can tell that the galaxy path ran.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flowspec_tpu_torch.models.kv_cache import KVCache
from flowspec_tpu_torch.models.llama import (
    LlamaParams, attend, kv_write, rms_norm,
)
from flowspec_tpu_torch.ops.quant import Int8Tensor, _Packed4Tensor
from flowspec_tpu_torch.parallel.tp import TPParams, head_ranges


def ring_ag_matmuls(x_loc: list, ws: list, group) -> list:
    """all_gather(x_loc) @ w for each w, as a ring.

    `x_loc` holds each local rank's (t_loc, H) row block, `ws` one list a
    weight of the local ranks' (H, O) shards. Each hop every rank
    multiplies the block it holds (whose origin it knows) and passes the
    block on; the outputs are joined in row order. Returns, a weight, the
    local ranks' (tp * t_loc, O) products."""
    tp = group.size
    held = list(x_loc)
    got = [[{} for _ in group.ranks] for _ in ws]   # [weight][rank]{src: y}
    for step in range(tp):
        for i, r in enumerate(group.ranks):
            src = (r - step) % tp
            for j, w in enumerate(ws):
                got[j][i][src] = (held[i] @ w[i]).to(held[i].dtype)
        if step < tp - 1:
            held = group.ring_shift(held, 1)
    return [[torch.cat([by_src[s] for s in range(tp)]) for by_src in per_w]
            for per_w in got]


def ring_matmul_rs(y: list, w: list, group) -> list:
    """reduce_scatter(y @ w) over row blocks, as a ring.

    `y` holds each local rank's (T, I_loc) rows of its inner shard and `w`
    its (I_loc, H) rows; the whole product is the sum over ranks. Each hop
    a rank adds its partial for the block whose accumulator it holds, in
    f32, and passes the accumulator back a rank. Returns each local rank's
    (T/tp, H) block r, summed, cast to y's dtype once."""
    tp = group.size
    t_loc = y[0].shape[0] // tp

    def part(i, b):
        return (y[i][b * t_loc:(b + 1) * t_loc] @ w[i]).float()

    acc = [part(i, (r + 1) % tp) for i, r in enumerate(group.ranks)]
    for s in range(1, tp):
        acc = group.ring_shift(acc, -1)
        acc = [a + part(i, (r + 1 + s) % tp)
               for i, (a, r) in enumerate(zip(acc, group.ranks))]
    return [a.to(y[0].dtype) for a in acc]


def _galaxy_layers(tpp, cache: KVCache, x_loc: list, positions, bias,
                   kvw, cfg, group) -> list:
    """The layer stack on row blocks (`:92-146`): `x_loc` each local
    rank's (1, t_loc, H) block; positions and bias for all T rows."""
    heads = head_ranges(cache.k.shape[2], len(group.ranks))
    for li in range(cache.k.shape[0]):
        lps = [s.layers.layer(li) for s in tpp.shards]
        kc, vc = cache.k[li], cache.v[li]
        res = x_loc
        h = [rms_norm(x, lps[0].input_ln, cfg.rms_norm_eps)[0]
             for x in x_loc]
        q, k, v = ring_ag_matmuls(
            h, [[lp.wq for lp in lps], [lp.wk for lp in lps],
                [lp.wv for lp in lps]], group)
        attn = []
        for i, lp in enumerate(lps):
            qi, ki, vi = q[i], k[i], v[i]
            if lp.bq is not None:
                qi, ki, vi = qi + lp.bq, ki + lp.bk, vi + lp.bv
            attn.append(attend(qi[None], ki[None], vi[None], kc, vc,
                               positions, bias, kvw, cfg, heads[i])[0])
        o = ring_matmul_rs(attn, [lp.wo for lp in lps], group)
        x_loc = [x + oi[None] for x, oi in zip(res, o)]

        res = x_loc
        h = [rms_norm(x, lps[0].post_ln, cfg.rms_norm_eps)[0]
             for x in x_loc]
        g, u = ring_ag_matmuls(h, [[lp.w_gate for lp in lps],
                                   [lp.w_up for lp in lps]], group)
        act = [F.silu(gi.float()).to(gi.dtype) * ui for gi, ui in zip(g, u)]
        d = ring_matmul_rs(act, [lp.w_down for lp in lps], group)
        x_loc = [x + di[None] for x, di in zip(res, d)]
    return x_loc


def _galaxy_ok(params, hidden, tp: int, live) -> bool:
    """Whether the galaxy stack takes this forward (module docstring)."""
    if not isinstance(params, TPParams) or live is not None:
        return False
    s0 = params.shards[0]
    if not isinstance(s0, LlamaParams):
        return False
    if any(isinstance(getattr(s0.layers, f), (Int8Tensor, _Packed4Tensor))
           for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")):
        return False
    b, t, _ = hidden.shape
    return b == 1 and t >= tp and t % tp == 0


def make_galaxy_forward(mesh):
    """A `models.model_forward`-signature forward running the galaxy layer
    stack over `mesh`'s tp group, or, where galaxy does not apply (module
    docstring), the plain TP forward. `fwd.engaged` / `fwd.fallbacks`
    count its calls each way."""
    group = mesh.group
    tp = mesh.shape["tp"]

    def galaxy_forward(params, cache: KVCache, hidden, positions, bias,
                       write_start, cfg, live=None):
        if not _galaxy_ok(params, hidden, tp, live):
            galaxy_forward.fallbacks += 1
            return params.forward(cache, hidden, positions, bias,
                                  write_start, cfg, live)
        galaxy_forward.engaged += 1
        t_loc = hidden.shape[1] // tp
        kvw = kv_write(write_start, hidden.shape[1], cache.k[0])
        x_loc = [hidden[:, r * t_loc:(r + 1) * t_loc] for r in group.ranks]
        x_loc = _galaxy_layers(params, cache, x_loc, positions, bias, kvw,
                               cfg, group)
        return group.all_gather(x_loc, 1), cache

    galaxy_forward.engaged = 0
    galaxy_forward.fallbacks = 0
    return galaxy_forward
