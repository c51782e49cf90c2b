"""Tensor-parallel verification path.

Port of `flowspec_tpu/parallel/tp.py`. The JAX package gives its weights
megatron PartitionSpecs and lets GSPMD partition the layer matmuls and
insert the all-reduces; here the same layout is explicit:

- `shard_params_tp` column-shards the Out axis of wq / wk / wv / w_gate /
  w_up and the q / k / v biases, row-shards the In axis of wo and w_down,
  replicates the norms and `embed`, and vocab-shards `lm_head`. Quantized
  containers follow JAX's scale rules (`:45-60`): int8's per-column scale
  follows Out under column sharding and is replicated under row sharding;
  the (In/64, Out) blocks of nf4 / int4 follow Out under column sharding
  and In under row sharding, so a row shard must keep whole 64-row blocks
  (In / tp % 64 == 0, else a ValueError). Mixtral keeps attention so and
  shards the stacked experts (L, E, ., .) on E (expert parallelism, E/tp
  experts a rank), the router replicated. `shard_draft_tp` does the same
  for the draft's 2-D weights, `fc_b` sharded with fc's columns, `embed`,
  `post_ln` and a thin draft's `w_out` replicated.
- The result is a type of its own (`TPParams`, `TPDraft`) that
  `models.model_forward`, `lm_head_logits` and the draft's `fuse` /
  `eagle_layer` / `project_out` / `draft_view` recognise, so `SpecEngine`,
  `BatchedSpecEngine` and the pipeline's stage views run over it
  unchanged, as the JAX engines run over GSPMD-placed weights.
- Inside a layer each rank projects its columns through the ops of
  `ops/quant.py qmatmul` (the dequant-matmul kernels on the card), ropes
  and attends its Hq/tp query heads over its Hkv/tp cached heads through
  the tree-attention kernel (G unchanged), and its row projection gives a
  partial that `all_reduce` sums (`parallel/comm.py`, which states the
  precision). The verify logits are computed a vocab shard a rank and
  joined by `all_gather`.
- The beam head stays replicated: `ops/head_topk.py head_plan` needs V %
  128 == 0 (32000 / 4 = 8000 is not), and a top-k of one vocab shard would
  also need the whole row's log-softmax. `make_beam_head` builds it from the
  gathered `lm_head` (131 MB in int8 at 7B) and its top-k is exact and
  unchanged; only the verify `lm_head` is vocab-sharded.

`TPEngine` is `SpecEngine` over such params with the base and draft KV
head-sharded: in-process one cache holds every rank's heads (rank i's a
slice of the head axis); over `torch.distributed` a process's cache holds
its own rank's heads. `save_state` writes the unsharded layout, so either
package reads it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from flowspec_tpu_torch.config import EngineConfig
from flowspec_tpu_torch.draft.eagle import EagleParams, geometry
from flowspec_tpu_torch.models.kv_cache import KVCache
from flowspec_tpu_torch.models.llama import (
    KVWrite, LlamaLayerParams, attention_block, kv_write, rms_norm,
)
from flowspec_tpu_torch.models.mixtral import (
    MixtralLayerParams, MixtralParams, moe_experts, moe_mixture,
)
from flowspec_tpu_torch.ops.quant import (
    NF4_BLOCK, Int8Tensor, _Packed4Tensor, matmul_f32_out, qmatmul,
)
from flowspec_tpu_torch.parallel.mesh import Mesh, put_global, tp_mesh
from flowspec_tpu_torch.runtime.engine import SpecEngine

COL = ("wq", "wk", "wv", "w_gate", "w_up")      # shard Out
ROW = ("wo", "w_down")                          # shard In
VEC = ("bq", "bk", "bv")                        # (L, Out): follow Out
EXPERTS = ("w_gate", "w_up", "w_down")          # Mixtral (L, E, ., .)


def _group(mesh: Mesh):
    if mesh.group is None:
        raise ValueError(f"{mesh} has no tp axis")
    return mesh.group


def shard_weight(w, group, kind: str, lead: int) -> list:
    """The local ranks' shards of one weight (In, Out) behind `lead`
    leading axes (1 for a stacked layer weight, 0 for the draft's):
    `kind` "col" shards Out, "row" shards In, with the quantized
    containers' scale rules (module docstring)."""
    if kind not in ("col", "row"):
        raise ValueError(f"kind {kind!r} not in ('col', 'row')")
    ax = lead + 1 if kind == "col" else lead
    if isinstance(w, Int8Tensor):
        scale = put_global(w.scale, group, lead if kind == "col" else None)
        return [Int8Tensor(q=q, scale=s)
                for q, s in zip(put_global(w.q, group, ax), scale)]
    if isinstance(w, _Packed4Tensor):
        if kind == "row" and (w.in_features // group.size) % NF4_BLOCK:
            raise ValueError(
                f"a row shard of a packed 4-bit weight must keep whole "
                f"{NF4_BLOCK}-row scale blocks: In {w.in_features} / tp "
                f"{group.size} is not a multiple of {NF4_BLOCK}")
        return [type(w)(q=q, scale=s) for q, s in zip(
            put_global(w.q, group, ax), put_global(w.scale, group, ax))]
    return put_global(w, group, ax)


def _rows(per_field: dict, n: int) -> list:
    """{field: [shard a local rank]} -> one {field: shard} a local rank."""
    return [{f: v[i] for f, v in per_field.items()} for i in range(n)]


def shard_params_tp(params, mesh: Mesh, vocab: bool = True) -> "TPParams":
    """The megatron layout of a LLaMA-family (or, expert-parallel, a
    Mixtral) base over `mesh`'s tp group. `vocab` False keeps `lm_head`
    replicated (the pipeline's PP x TP layout, `flowspec_tpu/parallel/
    pipeline.py:352-374`)."""
    if isinstance(params, MixtralParams):
        return _shard_mixtral_tp(params, mesh, vocab)
    group = _group(mesh)
    n = len(group.ranks)
    lp = params.layers
    per_field = {}
    for f in dataclasses.fields(lp):
        w = getattr(lp, f.name)
        if w is None:
            per_field[f.name] = [None] * n
        elif f.name in COL:
            per_field[f.name] = shard_weight(w, group, "col", 1)
        elif f.name in ROW:
            per_field[f.name] = shard_weight(w, group, "row", 1)
        elif f.name in VEC:
            per_field[f.name] = put_global(w, group, 1)
        else:
            per_field[f.name] = put_global(w, group)
    heads = put_global(params.lm_head, group, 1 if vocab else None)
    shards = [dataclasses.replace(params, layers=LlamaLayerParams(**row),
                                  lm_head=head)
              for row, head in zip(_rows(per_field, n), heads)]
    return TPParams(shards, group, vocab)


def _shard_mixtral_tp(params: MixtralParams, mesh: Mesh,
                      vocab: bool = True) -> "TPParams":
    """Attention column / row sharded as for LLaMA; the router replicated;
    the stacked experts sharded on E, each rank holding E/tp of them (the
    mixture's combine becomes an all-reduce)."""
    group = _group(mesh)
    n = len(group.ranks)
    lp = params.layers
    per_field = {}
    for f in dataclasses.fields(lp):
        w = getattr(lp, f.name)
        if f.name in EXPERTS:
            per_field[f.name] = put_global(w, group, 1)
        elif f.name in COL:
            per_field[f.name] = shard_weight(w, group, "col", 1)
        elif f.name in ROW:
            per_field[f.name] = shard_weight(w, group, "row", 1)
        else:
            per_field[f.name] = put_global(w, group)
    heads = put_global(params.lm_head, group, 1 if vocab else None)
    shards = [dataclasses.replace(params, layers=MixtralLayerParams(**row),
                                  lm_head=head)
              for row, head in zip(_rows(per_field, n), heads)]
    return TPParams(shards, group, vocab)


def shard_draft_tp(draft: EagleParams, mesh: Mesh) -> "TPDraft":
    """The draft's 2-D weights in the megatron layout (the container rules
    of `shard_weight`, no layer axis): fc and fc_b column-sharded, the
    attention and MLP as in the base; `embed`, `post_ln` and a thin
    draft's `w_out` replicated."""
    group = _group(mesh)
    n = len(group.ranks)
    per_field = {}
    for f in dataclasses.fields(draft):
        w = getattr(draft, f.name)
        if f.name == "fc_w" or f.name in COL:
            per_field[f.name] = shard_weight(w, group, "col", 0)
        elif f.name in ROW:
            per_field[f.name] = shard_weight(w, group, "row", 0)
        elif f.name == "fc_b":
            per_field[f.name] = put_global(w, group, 0)
        else:
            per_field[f.name] = ([None] * n if w is None
                                 else put_global(w, group))
    return TPDraft([EagleParams(**row) for row in _rows(per_field, n)],
                   group)


def _odim(w) -> int:
    q = getattr(w, "q", None)
    return (w if q is None else q).shape[-1]


def head_ranges(cache_heads: int, n_local: int) -> list:
    """The (lo, hi) KV heads of each local rank in a cache of
    `cache_heads` heads (every rank's in-process, one rank's over
    `torch.distributed`)."""
    if cache_heads % n_local:
        raise ValueError(f"{cache_heads} cached KV heads do not split over "
                         f"{n_local} ranks")
    h = cache_heads // n_local
    return [(i * h, (i + 1) * h) for i in range(n_local)]


def tp_attention(x, lps, k_cache, v_cache, positions, bias, kvw, cfg,
                 group) -> torch.Tensor:
    """Every local rank's attention shard, the row partials all-reduced."""
    heads = head_ranges(k_cache.shape[1], len(lps))
    return group.all_reduce([
        attention_block(x, lp.wq, lp.wk, lp.wv, lp.wo, k_cache, v_cache,
                        positions, bias, kvw, cfg,
                        bq=getattr(lp, "bq", None), bk=getattr(lp, "bk", None),
                        bv=getattr(lp, "bv", None), heads=h)
        for lp, h in zip(lps, heads)])


def tp_mlp(x, lps, group) -> torch.Tensor:
    """The gated MLP, w_gate / w_up columns and w_down rows a rank."""
    return group.all_reduce([
        qmatmul(F.silu(qmatmul(x, lp.w_gate)) * qmatmul(x, lp.w_up),
                lp.w_down) for lp in lps])


def tp_moe(x, lps, group, cfg) -> torch.Tensor:
    """The Mixtral MoE block with E/tp experts a rank: the replicated
    router's mixture, each rank's experts weighted by their columns of it,
    the partials all-reduced."""
    mix = moe_mixture(x, lps[0].router, cfg)
    e = lps[0].w_gate.shape[0]
    return group.all_reduce([
        moe_experts(x, lp.w_gate, lp.w_up, lp.w_down,
                    mix[..., r * e:(r + 1) * e])
        for lp, r in zip(lps, group.ranks)])


def tp_decoder_layer(x, lps, k_cache, v_cache, positions, bias, kvw, cfg,
                     group) -> torch.Tensor:
    """One decoder layer (LLaMA or Mixtral) over the local ranks' shards
    `lps` of its weights; norms and residuals replicated."""
    res = x
    h = rms_norm(x, lps[0].input_ln, cfg.rms_norm_eps)
    x = res + tp_attention(h, lps, k_cache, v_cache, positions, bias, kvw,
                           cfg, group)
    res = x
    h = rms_norm(x, lps[0].post_ln, cfg.rms_norm_eps)
    if isinstance(lps[0], MixtralLayerParams):
        return res + tp_moe(h, lps, group, cfg)
    return res + tp_mlp(h, lps, group)


class TPParams:
    """A base model's params over a TP group: `shards[i]` is local rank
    `group.ranks[i]`'s (its family's params type, each leaf its shard; a
    replicated leaf is one tensor every shard shares). `embed` and
    `final_norm` are replicated; `lm_head` gathers the whole head (the
    beam head is made from it); `vocab_logits` and `forward` are what the
    model layer calls."""

    def __init__(self, shards: list, group, vocab_sharded: bool = True):
        self.shards = shards
        self.group = group
        self.vocab_sharded = vocab_sharded

    @property
    def embed(self) -> torch.Tensor:
        return self.shards[0].embed

    @property
    def final_norm(self) -> torch.Tensor:
        return self.shards[0].final_norm

    @property
    def lm_head(self) -> torch.Tensor:
        """The whole (H, V) head: the vocab shards gathered (a copy)."""
        parts = [s.lm_head for s in self.shards]
        return (self.group.all_gather(parts, -1) if self.vocab_sharded
                else parts[0])

    def vocab_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., H) -> (..., V) f32: each rank's vocab shard
        (`matmul_f32_out`), gathered in rank order."""
        if not self.vocab_sharded:
            return matmul_f32_out(hidden, self.shards[0].lm_head)
        return self.group.all_gather(
            [matmul_f32_out(hidden, s.lm_head) for s in self.shards], -1)

    def layer_slice(self, lo: int, hi: int) -> "TPParams":
        """Layers [lo, hi) of every shard (views): a pipeline stage."""
        def cut(lp):
            return dataclasses.replace(lp, **{
                f.name: (None if getattr(lp, f.name) is None
                         else getattr(lp, f.name)[lo:hi])
                for f in dataclasses.fields(lp)})
        return TPParams([dataclasses.replace(s, layers=cut(s.layers))
                         for s in self.shards], self.group,
                        self.vocab_sharded)

    def forward(self, cache: KVCache, hidden, positions, bias, write_start,
                cfg, live=None):
        """`models.model_forward` over the shards: (hidden, cache), the
        cache appended in place, each rank's heads its own."""
        x = hidden
        kvw = kv_write(write_start, hidden.shape[1], cache.k[0], live)
        for i in range(cache.k.shape[0]):
            lps = [s.layers.layer(i) for s in self.shards]
            x = tp_decoder_layer(x, lps, cache.k[i], cache.v[i], positions,
                                 bias, kvw, cfg, self.group)
        return x, cache


class TPDraft:
    """An EAGLE draft over a TP group (`shard_draft_tp`): `shards[i]` local
    rank i's `EagleParams`. The draft functions of `draft/eagle.py` call
    `fuse`, `layer` and `view` (`project_out` takes the replicated w_out of
    `shards[0]`); `wq` is for `make_beam_head`'s choice of head (the
    container kind)."""

    def __init__(self, shards: list, group):
        self.shards = shards
        self.group = group

    @property
    def wq(self):
        return self.shards[0].wq

    def view(self, base_cfg):
        """The unsharded draft's geometry (`draft_view`)."""
        s, n = self.shards[0], self.group.size
        return geometry(base_cfg, _odim(s.fc_w) * n, _odim(s.wq) * n,
                        _odim(s.wk) * n, _odim(s.w_gate) * n)

    def fuse(self, tokens, hidden) -> torch.Tensor:
        """fc(concat(embed(tokens), hidden)): each rank's fc columns (and
        fc_b), gathered."""
        s0 = self.shards[0]
        emb = s0.embed[tokens.long().clamp(0, s0.embed.shape[0] - 1)]
        x = torch.cat([emb.to(hidden.dtype), hidden], dim=-1)
        return self.group.all_gather(
            [qmatmul(x, s.fc_w) + s.fc_b for s in self.shards], -1)

    def layer(self, x, k_cache, v_cache, positions, bias, write_start, cfg,
              live=None) -> torch.Tensor:
        """`eagle_layer` over the shards (no input norm), the draft KV's
        heads a rank's own."""
        if not isinstance(write_start, KVWrite):
            write_start = kv_write(write_start, x.shape[1], k_cache, live)
        res = x
        x = res + tp_attention(x, self.shards, k_cache, v_cache, positions,
                               bias, write_start, cfg, self.group)
        res = x
        h = rms_norm(x, self.shards[0].post_ln, cfg.rms_norm_eps)
        return res + tp_mlp(h, self.shards, self.group)


def shard_cache(cache: KVCache, group) -> KVCache:
    """This process's heads of a whole cache: itself in-process, the
    rank's slice of the head axis (a copy) over `torch.distributed`."""
    if not group.distributed:
        return cache
    return KVCache(k=put_global(cache.k, group, 2)[0],
                   v=put_global(cache.v, group, 2)[0], length=cache.length)


def gather_cache(cache: KVCache, group) -> KVCache:
    """The whole cache from this process's heads (`shard_cache` undone)."""
    if not group.distributed:
        return cache
    return KVCache(k=group.all_gather([cache.k], 2),
                   v=group.all_gather([cache.v], 2), length=cache.length)


class TPEngine(SpecEngine):
    """`SpecEngine` with tensor-parallel weights and head-sharded KV
    (`flowspec_tpu/parallel/tp.py:152-204`): the draft tree is built once
    (replicated compute), the whole tree verified in one TP forward,
    acceptance and KV compaction as usual. `generate`, `generate_ar`,
    `generate_fused` (the round as one CUDA graph on the card: in-process
    the ranks run one after another on one stream) and
    `resume_and_generate` are `SpecEngine`'s.

    `galaxy=True` sends the multi-row forwards through the sequence-sharded
    ring collectives of `parallel/galaxy.py` (same weights and KV layout,
    same tokens). Without a mesh, an in-process one of `tp` ranks
    (default: min(4, KV heads))."""

    def __init__(self, params, draft: EagleParams, cfg: EngineConfig,
                 mesh: Mesh | None = None, tp: int | None = None,
                 galaxy: bool = False, device=None):
        mc = cfg.model
        if mesh is None:
            mesh = tp_mesh(tp or min(4, mc.num_key_value_heads))
        self.mesh = mesh
        tp_size = mesh.shape["tp"]
        assert mc.num_key_value_heads % tp_size == 0, \
            "kv heads must divide tp"
        if mc.num_local_experts:
            assert mc.num_local_experts % tp_size == 0, \
                "experts must divide tp (expert parallelism)"
        params = shard_params_tp(params, mesh)
        draft = shard_draft_tp(draft, mesh)
        dkv = draft.view(mc).num_key_value_heads
        assert dkv % tp_size == 0, \
            f"draft kv heads ({dkv}) must divide tp (head-sharded draft KV)"
        fwd = None
        if galaxy:
            from flowspec_tpu_torch.parallel.galaxy import make_galaxy_forward
            assert mc.num_attention_heads % tp_size == 0, \
                "q heads must divide tp (galaxy)"
            fwd = make_galaxy_forward(mesh)
        super().__init__(params, draft, cfg, device=device, forward_fn=fwd)

    def init_state(self, seed: int = 0, max_seq: int | None = None):
        """`SpecEngine.init_state` with the base and draft KV head-sharded
        (`:191-204`): in-process one cache holds every rank's heads; over
        `torch.distributed` this rank's heads."""
        state = super().init_state(seed, max_seq=max_seq)
        return self.shard_state(state)

    def shard_state(self, state):
        """A whole (unsharded) engine state as this process holds it."""
        g = self.mesh.group
        return dataclasses.replace(
            state, base_cache=shard_cache(state.base_cache, g),
            draft_cache=shard_cache(state.draft_cache, g))

    def gather_state(self, state):
        """This process's state with every rank's KV heads: the unsharded
        layout (as the JAX package's `np.asarray` gathers)."""
        g = self.mesh.group
        return dataclasses.replace(
            state, base_cache=gather_cache(state.base_cache, g),
            draft_cache=gather_cache(state.draft_cache, g))

    def save_state(self, state, out_dir: str) -> None:
        """Save `state` unsharded (`models/checkpoint.py save_state`);
        over `torch.distributed` every rank gathers, rank 0 writes."""
        from flowspec_tpu_torch.models.checkpoint import save_state
        whole = self.gather_state(state)
        if not self.mesh.distributed or self.mesh.group.rank == 0:
            save_state(whole, out_dir)

    def load_state(self, out_dir: str):
        """A saved (unsharded) engine state, sharded as this engine holds
        it."""
        from flowspec_tpu_torch.models.checkpoint import load_state
        return self.shard_state(load_state(out_dir, device=self.device))
