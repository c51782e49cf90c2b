"""Pipelined tree-speculative decoding: P layer stages on one card.

Port of `flowspec_tpu/parallel/pipeline.py` (the schedules of the
reference's `StageEaModel`, stage_ea_model.py:369-1791). The JAX engine
runs the stages as one SPMD program over a `stage` mesh; here one process
runs every stage on one card, turn by turn:

- stage s owns layers [lo_s, hi_s) of the one stacked layer pytree and of
  one stacked KV cache, as views (no padding: a stage of 0 layers passes
  its chunk on unchanged, where JAX pads uneven splits with all-zero
  identity layers, `:128-157`);
- the ring hop (`ppermute`, `:111-125`) is a rotation of the list of
  flights: stage s takes stage s-1's flight of the last turn; the
  completed chunk (`all_gather(...)[p-1]`) is the last stage's flight;
- the replicated draft and control plane (verdict, pruning, expansion)
  runs once;
- every `lax.cond` and `while_loop` (`:601`, `:999-1000`, `:1024-1026`,
  `:1062`, `:1149`, `:1177-1179`, `:1202`, `:1261`) is a host branch on a
  device flag. A turn reads back at most three small int vectors through
  a pinned buffer (`HostReads`): [do_verdict, the expansion gates] when no
  chunk completed (or the schedule verdicts once a round), [truncate, eos,
  over budget, pipedec's gate] after a verdict, and [each stage's chunk
  length, more to inject or verify, the none_expand queue flag] before the
  forwards. No token and no larger tensor crosses inside a round.

The outputs and statistics (rounds, turns, skips, ne_fires) are the JAX
engine's. The verified-logits buffer (`:20-26`: (node_cap, V) f32,
remapped at every prune, so a verdict can accept through nodes verified
earlier) is kept. Stochastic verdicts draw from the port's counter-based
streams (`tree/sampling.py Draws`), so only their law matches JAX's.

Schedules: naive, pruned, continuous (with none_expand), serial, ar,
pipedec. The base is any family of `models.model_forward`. PP x TP
(`:232-246`, `:316-374`): on a `stage_tp_mesh(p, tp)` (`parallel/mesh.py`)
each stage's view of the layers is tensor-parallel over the mesh's
in-process TP group (`parallel/tp.py shard_params_tp`: the megatron layout,
Mixtral's experts on tp), `lm_head` and the draft replicated as in JAX, and
every stage's chunk forward runs through the TP forward. The turn runs
eagerly (its CUDA graph is a later step).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from flowspec_tpu_torch.config import EngineConfig, StageTopology
from flowspec_tpu_torch.draft.beam import _topk_stable, expand_tree, \
    topk_generate
from flowspec_tpu_torch.draft.eagle import (
    EagleParams, draft_context_forward, draft_view, eagle_layer, fuse,
    project_out,
)
from flowspec_tpu_torch.models import model_forward
from flowspec_tpu_torch.models.bias import prefill_bias, tree_bias
from flowspec_tpu_torch.models.kv_cache import (
    KVCache, clamp_start, grow_kv, init_kv_cache,
)
from flowspec_tpu_torch.models.llama import (
    embed_tokens, final_hidden, lm_head_logits,
)
from flowspec_tpu_torch.ops.head_topk import head_topk
from flowspec_tpu_torch.parallel.tp import TPParams, shard_params_tp
from flowspec_tpu_torch.runtime.engine import make_beam_head, resolve_device
from flowspec_tpu_torch.tree.build import finalize_tree
from flowspec_tpu_torch.tree.merge import merge_trees
from flowspec_tpu_torch.tree.partition import (
    partition_lengths, rebucket_lengths,
)
from flowspec_tpu_torch.tree.posterior import (
    evaluate_posterior_greedy, evaluate_posterior_stochastic,
)
from flowspec_tpu_torch.tree.prune import (
    compute_pruning_info, kept_order, kv_keep_positions, old_to_new,
    prune_tree,
)
from flowspec_tpu_torch.tree.sampling import Draws, lane_rng, sample_token
from flowspec_tpu_torch.tree.types import (
    NEG_INF, TokenTree, ancestor_matrix, take,
)

SCHEDULES = ("naive", "pruned", "continuous", "serial", "ar", "pipedec")


@dataclasses.dataclass
class PipeState:
    """Cross-round state of one request. `kv` holds every stage's layers
    in one (L, 1, H, S, D) stack; lengths are 0-d int32 on the device."""
    kv: KVCache
    draft_cache: KVCache
    commit_len: torch.Tensor   # ()
    root_token: torch.Tensor   # ()
    pend_tok: torch.Tensor     # (CTX,) draft pairs pending
    pend_hid: torch.Tensor     # (1, CTX, H)
    pend_n: torch.Tensor       # ()
    rng: torch.Tensor          # (1, 2) draw stream, `tree/sampling.py`


class Flight(NamedTuple):
    """A chunk in the pipeline: contiguous node ids [start, start + n)."""
    h: torch.Tensor       # (C, H)
    start: torch.Tensor   # () int32
    n: torch.Tensor       # () int32


class RoundOut(NamedTuple):
    out_tokens: torch.Tensor   # (OUT_CAP,) on the device
    n_out: torch.Tensor        # () on the device
    turns: int
    skips: int                 # bubble turns (no verdict)
    ne_fires: int              # none_expand expansions
    eos_hit: bool              # the last verdict met eos
    over_budget: bool          # the last verdict reached the budget
    stalled: bool              # no verdict: the round ran to max_turns


class HostReads:
    """Small int32 vectors read back to the host, counted: on the card
    through one pinned buffer (a copy and a stream sync), on the CPU by
    `tolist`."""

    def __init__(self, device: torch.device, size: int = 32):
        self.count = 0
        self.buf = (torch.empty((size,), dtype=torch.int32, pin_memory=True)
                    if device.type == "cuda" else None)

    def __call__(self, *vals) -> list:
        v = torch.stack([x.reshape(()).to(torch.int32) for x in vals])
        self.count += 1
        if self.buf is None:
            return v.tolist()
        out = self.buf[:v.numel()]
        out.copy_(v, non_blocking=True)
        torch.cuda.current_stream(v.device).synchronize()
        return out.tolist()


# ---- layer split -----------------------------------------------------------

def layer_split(cfg: EngineConfig) -> tuple:
    """Layers per stage: the topology's when it covers the model, else the
    even split (`flowspec_tpu/parallel/pipeline.py:219-227`)."""
    topo, n_layers = cfg.topology, cfg.model.num_hidden_layers
    if topo.layers_per_stage and topo.total_layers == n_layers \
            and len(topo.layers_per_stage) == topo.num_stages:
        return tuple(topo.layers_per_stage)
    return StageTopology.even(n_layers, topo.num_stages).layers_per_stage


def slot_layers(split) -> list:
    """The slot of each layer in the JAX package's padded stage layout
    (stage s's layers at slots [s * per, s * per + split[s]), per =
    max(split); the other slots hold all-zero layers)."""
    per = max(split)
    return [s * per + i for s, n in enumerate(split) for i in range(n)]


def to_slots(x: torch.Tensor, split) -> torch.Tensor:
    """(L, ...) -> (p * max(split), ...) in the slot layout, zeros in the
    padded slots."""
    out = x.new_zeros((len(split) * max(split),) + tuple(x.shape[1:]))
    out[slot_layers(split)] = x
    return out


def from_slots(x: torch.Tensor, split) -> torch.Tensor:
    """(p * max(split), ...) in the slot layout -> (L, ...)."""
    return x[slot_layers(split)]


def _stage_params(params, lo: int, hi: int):
    """`params` with its layer stack cut to [lo, hi) (views)."""
    if isinstance(params, TPParams):
        return params.layer_slice(lo, hi)
    lp = params.layers
    return dataclasses.replace(params, layers=dataclasses.replace(lp, **{
        f.name: (None if getattr(lp, f.name) is None
                 else getattr(lp, f.name)[lo:hi])
        for f in dataclasses.fields(lp)}))


# ---- small helpers ---------------------------------------------------------

def _i32(x, device) -> torch.Tensor:
    return torch.full((), int(x), dtype=torch.int32, device=device)


def _drop_set(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
              ok: torch.Tensor) -> torch.Tensor:
    """`buf.at[where(ok, idx, OOB)].set(val, mode="drop")`: a copy of
    `buf` with rows idx[ok] set (the dropped rows go to a sink row)."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf[:1]])
    ext.index_copy_(0, torch.where(ok, idx, n).long(), val.to(buf.dtype))
    return ext[:n]


def _select_tree(ok: torch.Tensor, a: TokenTree, b: TokenTree) -> TokenTree:
    return TokenTree(**{f.name: torch.where(ok, getattr(a, f.name),
                                            getattr(b, f.name))
                        for f in dataclasses.fields(TokenTree)})


def _queue_appended(lens: torch.Tensor, n_chunks: torch.Tensor, n_app,
                    cap: int, s_cap: int):
    """Queue `n_app` appended nodes as pipeline chunks
    (`flowspec_tpu/parallel/pipeline.py:679-699`): one chunk when cap <=
    0, else ceil(n_app / cap) entries of <= cap nodes. Returns (lens',
    n_chunks', ok); ok False (nothing to append, or the queue would
    overflow) leaves the queue as it was."""
    q = torch.arange(lens.shape[0], device=lens.device)
    k = q - n_chunks
    if cap > 0:
        n_new = (n_app + cap - 1) // cap
        entry = (n_app - k * cap).clamp(0, cap)
    else:
        n_new = (n_app > 0).to(torch.int32)
        entry = torch.where(k == 0, n_app, 0)
    ok = (n_app > 0) & (n_chunks + n_new <= s_cap)
    lens2 = torch.where(ok & (k >= 0) & (k < n_new), entry, lens)
    nch2 = torch.where(ok, n_chunks + n_new, n_chunks)
    return lens2.to(torch.int32), nch2.to(torch.int32), ok


# ---- the engine ------------------------------------------------------------

class PipelineEngine:
    """The pipeline engine (`flowspec_tpu/parallel/pipeline.py:196`) with
    its P stages in one process on one device; `device` defaults to cuda.
    `mesh` (`parallel/mesh.py`): a `stage_mesh(p)` (the default) or a
    `stage_tp_mesh(p, tp)`, whose stages are tensor-parallel."""

    def __init__(self, params, draft: EagleParams, cfg: EngineConfig,
                 schedule: str = "continuous", device=None, mesh=None):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
        mc = cfg.model
        if mesh is not None:
            if mesh.distributed or "stage" not in mesh.axis_names:
                raise ValueError(f"PipelineEngine takes an in-process stage "
                                 f"or (stage, tp) mesh, got {mesh}")
            if mesh.shape["stage"] != cfg.topology.num_stages:
                raise ValueError(f"{mesh} for {cfg.topology.num_stages} "
                                 "stages")
        self.mesh = mesh
        self.tp = mesh.shape.get("tp", 1) if mesh is not None else 1
        if self.tp > 1:
            assert mc.num_attention_heads % self.tp == 0
            assert mc.num_key_value_heads % self.tp == 0
            if mc.num_local_experts:
                # MoE: expert-parallel over tp (each TP rank holds E/tp
                # experts; the mixture's partials are all-reduced)
                assert mc.num_local_experts % self.tp == 0
            params = shard_params_tp(params, mesh, vocab=False)
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.schedule = schedule
        mc, tc = cfg.model, cfg.tree
        self.p = p = cfg.topology.num_stages
        self.layer_split = layer_split(cfg)
        off = np.concatenate([[0], np.cumsum(self.layer_split)]).tolist()
        self.stage_layers = [(off[s], off[s + 1]) for s in range(p)]
        self.params = params
        self.stage_params = [_stage_params(params, lo, hi)
                             for lo, hi in self.stage_layers]
        self.draft = draft
        self.dcfg = draft_view(draft, mc)
        self.beam_head = make_beam_head(params, draft, cfg)

        # static capacities (`:248-272`)
        if schedule == "serial":
            self.c_buf = tc.node_cap
        else:
            n0 = tc.total_tokens + 1
            if n0 // p <= tc.chunk_len:
                mx = -(-n0 // p)
            else:
                mx = max(tc.chunk_len, n0 - tc.chunk_len * p)
            app_max = 0
            if schedule == "continuous":
                if tc.expand_chunk_len > 0:
                    app_max = tc.expand_chunk_len
                else:
                    app_max = max(tc.expand_tokens,
                                  tc.none_expand_tokens if tc.none_expand
                                  else 0)
            self.c_buf = max(mx, tc.chunk_len, app_max) + 1
        self.ctx = tc.depth_cap + 1
        self.out_cap = 4 * tc.node_cap
        self.max_turns = 64
        self.force_turn = self.max_turns - tc.chunk_cap - p - 4
        self.max_levels = tc.depth + tc.expand_depth
        self.base_rows, self.draft_rows = self._kv_rows(cfg.max_seq_len)
        self.reads = HostReads(self.device)

    def _kv_rows(self, max_seq: int):
        """(base_rows, draft_rows): JAX's margins (`:398`, `:406-412`)
        rounded up to 256, the attention kernel's block of rows."""
        tc = self.cfg.tree
        rnd = lambda n: -(-n // 256) * 256
        return (rnd(max_seq + 2 * tc.node_cap + tc.depth_cap),
                rnd(max_seq + max(self.max_levels * tc.top_k,
                                  2 * tc.node_cap + tc.depth_cap + self.ctx)))

    def stage_cache(self, kv: KVCache, s: int) -> KVCache:
        """Stage s's view of the stacked cache."""
        lo, hi = self.stage_layers[s]
        return KVCache(k=kv.k[lo:hi], v=kv.v[lo:hi], length=kv.length)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> PipeState:
        mc = self.cfg.model
        dt = getattr(torch, mc.dtype)
        dev = self.device
        kv = init_kv_cache(mc.num_hidden_layers, 1, mc.num_key_value_heads,
                           self.base_rows, mc.head_dim_, dt, dev)
        dc = init_kv_cache(1, 1, self.dcfg.num_key_value_heads,
                           self.draft_rows, self.dcfg.head_dim_, dt, dev)
        return PipeState(
            kv=kv.with_length(0), draft_cache=dc.with_length(0),
            commit_len=_i32(0, dev), root_token=_i32(0, dev),
            pend_tok=torch.zeros((self.ctx,), dtype=torch.int32, device=dev),
            pend_hid=torch.zeros((1, self.ctx, mc.hidden_size), dtype=dt,
                                 device=dev),
            pend_n=_i32(0, dev),
            rng=lane_rng(torch.full((1,), seed, dtype=torch.int64,
                                    device=dev)))

    def _fit_state(self, state: PipeState) -> PipeState:
        """A state (say, one the JAX package saved, with its own margins)
        with caches of at least this engine's rows: zero-padded, as a KV
        bucket grows."""
        if state.kv.max_len < self.base_rows:
            state = dataclasses.replace(
                state, kv=grow_kv(state.kv, self.base_rows))
        if state.draft_cache.max_len < self.draft_rows:
            state = dataclasses.replace(
                state, draft_cache=grow_kv(state.draft_cache,
                                           self.draft_rows))
        return state

    # ------------------------------------------------------------------
    def prefill(self, state: PipeState, prompt, start: int = 0) -> PipeState:
        """Pipelined chunked prefill, then the draft context catches up
        over the (next_token, hidden) pairs (`_prefill_all`). `start` > 0
        appends at an existing committed position (resume): the caller
        has rolled the lengths back to `start`."""
        pc = self.cfg.prefill_chunk
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = len(prompt)
        n_chunks = max(1, -(-n // pc))
        padded = np.zeros((n_chunks * pc,), np.int32)
        padded[:n] = prompt
        return _prefill_all(self, state, padded, n, start)

    def generate(self, prompt, max_new_tokens=None, eos_token_id=2,
                 seed: int = 0, return_state: bool = False):
        max_new = max_new_tokens or self.cfg.max_new_tokens
        state = self.prefill(self.init_state(seed), prompt)
        out = [int(t) for t in np.asarray(prompt).reshape(-1)]
        return self._decode_host(state, out, max_new, eos_token_id,
                                 return_state)

    def _decode_host(self, state, out, max_new, eos_token_id,
                     return_state: bool = False):
        """Rounds in a host loop; after each, one read of its tokens."""
        new_tokens = rounds = turns = skips = ne = 0
        while new_tokens < max_new:
            state, res = _pipeline_round(self, state, eos_token_id,
                                         max_new - new_tokens)
            rounds += 1
            turns += res.turns
            skips += res.skips
            ne += res.ne_fires
            n, *acc = torch.cat([res.n_out.view(1),
                                 res.out_tokens]).tolist()
            stop = False
            for t in acc[:n]:
                out.append(t)
                new_tokens += 1
                if t == eos_token_id or new_tokens >= max_new:
                    stop = True
                    break
            if stop or n == 0:
                break
        stats = {"new_tokens": new_tokens, "rounds": rounds, "turns": turns,
                 "skips": skips, "ne_fires": ne,
                 "accept_per_round": new_tokens / max(rounds, 1)}
        if return_state:
            return out, stats, state
        return out, stats

    def generate_fused(self, prompt, max_new_tokens=None, eos_token_id=2,
                       seed: int = 0, return_state: bool = False):
        """The multi-round decode of `_pipeline_decode_loop` (`:1223`):
        rounds chain on the device (tokens gathered into a device buffer)
        with no token read between them; the loop's condition comes from
        each round's last verdict flags. One read of the tokens at the
        end."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        if max_new > self.out_cap:
            raise ValueError(f"max_new_tokens {max_new} exceeds the output "
                             f"buffer's {self.out_cap} (4 * node_cap)")
        state = self.prefill(self.init_state(seed), prompt)
        dev = self.device
        buf_cap = self.out_cap * 4
        buf = torch.zeros((buf_cap + 1,), dtype=torch.int32, device=dev)
        n_out = _i32(0, dev)
        i = torch.arange(self.out_cap, device=dev)
        rounds = turns = skips = ne = 0
        done = False
        while not done:
            state, res = _pipeline_round(self, state, eos_token_id,
                                         max_new - n_out)
            pv = i < res.n_out
            wpos = torch.where(pv & (n_out + i < buf_cap), n_out + i,
                               buf_cap)
            buf.index_copy_(0, wpos.long(),
                            torch.where(pv, res.out_tokens, 0))
            n_out = n_out + res.n_out
            rounds += 1
            turns += res.turns
            skips += res.skips
            ne += res.ne_fires
            done = res.eos_hit or res.over_budget or res.stalled
        n, *toks = torch.cat([n_out.view(1), buf[:self.out_cap]]).tolist()
        out = [int(t) for t in np.asarray(prompt).reshape(-1)]
        new_tokens = 0
        for t in toks[:n]:
            out.append(t)
            new_tokens += 1
            if t == eos_token_id or new_tokens >= max_new:
                break
        stats = {"new_tokens": new_tokens, "turns": turns, "rounds": rounds,
                 "skips": skips, "ne_fires": ne,
                 "accept_per_round": new_tokens / max(rounds, 1)}
        if return_state:
            return out, stats, state
        return out, stats

    def resume_and_generate(self, state: PipeState, history, extra_prompt,
                            max_new_tokens=None, eos_token_id: int = 2,
                            return_state: bool = False):
        """Multi-turn continuation with KV reuse (`:532-571`): `history` is
        the token stream the previous call on `state` returned; the state
        rolls back to len(history) - 1 commits and the boundary token
        history[-1] is prefilled again ahead of `extra_prompt`."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        history = [int(t) for t in np.asarray(history).reshape(-1)]
        extra = [int(t) for t in np.asarray(extra_prompt).reshape(-1)]
        keep = len(history) - 1
        if keep < 0 or not extra:
            raise ValueError(f"resume_and_generate needs a history and an "
                             f"extra prompt, got {len(history)} and "
                             f"{len(extra)} tokens")
        need = len(history) + len(extra) + max_new \
            + self.cfg.tree.depth_cap + 1
        if need > self.cfg.max_seq_len:
            raise ValueError(
                f"history+extra+max_new+depth_cap = {need} exceeds "
                f"max_seq_len {self.cfg.max_seq_len}")
        dev = self.device
        state = self._fit_state(state)
        state = dataclasses.replace(
            state, kv=state.kv.with_length(keep),
            draft_cache=state.draft_cache.with_length(keep),
            commit_len=_i32(keep, dev),
            pend_tok=torch.zeros_like(state.pend_tok),
            pend_hid=torch.zeros_like(state.pend_hid),
            pend_n=_i32(0, dev))
        state = self.prefill(state, [history[-1]] + extra, start=keep)
        return self._decode_host(state, history + extra, max_new,
                                 eos_token_id, return_state)


# ---- prefill ---------------------------------------------------------------

def _prefill_all(eng: PipelineEngine, state: PipeState, padded: np.ndarray,
                 n: int, start: int) -> PipeState:
    """`flowspec_tpu/parallel/pipeline.py:578-676`: the injection ring over
    n_chunks + p turns (stage 0 injects chunk t at turn t, stage s forwards
    what stage s-1 sent; the completed chunk's final-normed hiddens gather
    into a buffer), the root sampled from the last prompt token's logits,
    then the draft context drained over the (prompt[i+1], hidden_i) pairs.
    The chunk schedule is known on the host: nothing is read back."""
    mc = eng.cfg.model
    p, pc = eng.p, eng.cfg.prefill_chunk
    dev = eng.device
    params = eng.params
    n_chunks = len(padded) // pc
    dt = getattr(torch, mc.dtype)
    tok = torch.from_numpy(padded).to(dev)
    s_max = state.kv.max_len
    buf = torch.zeros((n_chunks * pc, mc.hidden_size), dtype=dt, device=dev)
    steps = torch.arange(pc, device=dev)
    outs = [None] * p            # (h, start, n) of each stage's last chunk
    for t in range(n_chunks + p):
        comp = outs[p - 1]
        if comp is not None:
            off = comp[1] - start
            buf[off:off + pc] = final_hidden(params, comp[0][None], mc)[0]
        mine = [None] * p
        nv = min(max(n - t * pc, 0), pc) if t < n_chunks else 0
        if nv > 0:
            mine[0] = (embed_tokens(params, tok[t * pc:(t + 1) * pc][None])[0],
                       start + t * pc, nv)
        for s in range(1, p):
            mine[s] = outs[s - 1]
        for s, fl in enumerate(mine):
            if fl is None:
                continue
            h, cs, _ = fl
            lo, hi = eng.stage_layers[s]
            if hi > lo:
                h, _ = model_forward(
                    eng.stage_params[s], eng.stage_cache(state.kv, s),
                    h[None], cs + steps, prefill_bias(cs, pc, s_max,
                                                      device=dev), cs, mc)
                h = h[0].to(dt)
            mine[s] = (h, cs, fl[2])
        outs = mine
    kv = state.kv.with_length(state.kv.length.clamp_min(start + n))

    h_last = buf[min(max(n - 1, 0), n_chunks * pc - 1)]
    draws = Draws(state.rng)
    root = sample_token(draws, lm_head_logits(params, h_last),
                        eng.cfg.sampling, is_probs=False)
    pair = torch.from_numpy(np.concatenate(
        [padded[1:], np.zeros((1,), np.int32)])).to(dev)
    dcache = state.draft_cache
    for c in range(n_chunks):
        nv = min(max(n - 1 - c * pc, 0), pc)
        _, dcache = draft_context_forward(
            eng.draft, dcache, pair[c * pc:(c + 1) * pc],
            buf[c * pc:(c + 1) * pc][None], dcache.length, nv, mc)
    pend_tok = torch.zeros_like(state.pend_tok)
    pend_tok[0].copy_(root)
    pend_hid = torch.zeros_like(state.pend_hid)
    pend_hid[0, 0].copy_(h_last)
    return dataclasses.replace(
        state, kv=kv, draft_cache=dcache, rng=draws.rng, root_token=root,
        commit_len=_i32(start + n, dev), pend_tok=pend_tok,
        pend_hid=pend_hid, pend_n=_i32(1, dev))


# ---- one round -------------------------------------------------------------

def _forward_chunk(eng: PipelineEngine, s: int, kv: KVCache, anc_rows,
                   depth: torch.Tensor, fl: Flight, commit) -> torch.Tensor:
    """Stage s's layers over an in-flight chunk (contiguous node ids,
    `:702-717`). `anc_rows` is the tree's (N, N) ancestor matrix."""
    lo, hi = eng.stage_layers[s]
    if hi == lo:
        return fl.h
    c_buf = fl.h.shape[0]
    n_cap = anc_rows.shape[0]
    ids = fl.start + torch.arange(c_buf, device=fl.h.device)
    safe = ids.clamp(0, n_cap - 1).long()
    rows = anc_rows[safe] & (torch.arange(c_buf, device=ids.device)[:, None]
                             < fl.n)
    bias = tree_bias(torch.where(rows, 0.0, NEG_INF), commit, kv.max_len)
    h, _ = model_forward(eng.stage_params[s], eng.stage_cache(kv, s),
                         fl.h[None], commit + depth[safe], bias,
                         commit + fl.start, eng.cfg.model)
    return h[0].to(fl.h.dtype)


def _pipeline_round(eng: PipelineEngine, state: PipeState, eos_id: int,
                    budget):
    """One speculation round (`:720-1220`): draft a tree, stream, verify,
    prune and expand until truncate; returns (state', RoundOut).
    `budget` is a host int or a 0-d device tensor."""
    cfg = eng.cfg
    mc, tc, sampling = cfg.model, cfg.tree, cfg.sampling
    p, c_buf, out_cap = eng.p, eng.c_buf, eng.out_cap
    n_cap, d_cap, s_cap = tc.node_cap, tc.depth_cap, tc.chunk_cap
    sched = eng.schedule
    inflight = sched in ("pruned", "continuous", "pipedec")
    do_expand = sched == "continuous"
    pipedec = sched == "pipedec"
    ne_on = do_expand and tc.none_expand
    params, draft, bhead = eng.params, eng.draft, eng.beam_head
    ml = eng.max_levels
    read = eng.reads
    dev = eng.device
    dt = state.pend_hid.dtype
    ctx = state.pend_tok.shape[0]
    h_dim = state.pend_hid.shape[-1]
    vocab = params.embed.shape[0]
    draws = Draws(state.rng)
    ar_n = torch.arange(n_cap, device=dev)
    ar_c = torch.arange(c_buf, device=dev)
    d_idx = torch.arange(d_cap, device=dev)

    # ---- 1. draft the initial tree ----
    d_out, dcache = draft_context_forward(
        draft, state.draft_cache, state.pend_tok, state.pend_hid,
        state.draft_cache.length, state.pend_n, mc)
    root_hidden = take(d_out[0], (state.pend_n - 1).clamp(0, ctx - 1))
    if pipedec:
        tree, beam, dcache = topk_generate(
            draft, bhead, dcache, state.root_token, root_hidden, tc, mc,
            num_select=tc.top_k, depth=0, max_levels=ml)
    else:
        tree, beam, dcache = topk_generate(
            draft, bhead, dcache, state.root_token, root_hidden, tc, mc,
            num_select=0 if sched == "ar" else None, max_levels=ml)
    if sched == "serial":
        lens = torch.cat([tree.n_nodes.reshape(1),
                          torch.zeros((s_cap - 1,), dtype=torch.int32,
                                      device=dev)])
        n_chunks = _i32(1, dev)
    else:
        lens, n_chunks = partition_lengths(tree.n_nodes, p, tc.chunk_len,
                                           s_cap)

    next_inject = verified = _i32(0, dev)
    commit = state.commit_len
    vhidden = torch.zeros((n_cap, h_dim), dtype=dt, device=dev)
    vlogits = torch.zeros((n_cap, vocab), dtype=torch.float32, device=dev)
    dhidden = torch.zeros((n_cap, h_dim), dtype=dt, device=dev)
    dhidden[0].copy_(root_hidden)
    dh_valid = ar_n == 0
    out_tokens = torch.zeros((out_cap + 1,), dtype=torch.int32, device=dev)
    n_out = _i32(0, dev)
    sampled_root = state.root_token
    pend_tok, pend_hid, pend_n = (torch.zeros_like(state.pend_tok),
                                  torch.zeros_like(state.pend_hid),
                                  _i32(0, dev))
    kv = state.kv
    kv_tree_len = [_i32(0, dev)] * p
    empty = Flight(h=torch.zeros((c_buf, h_dim), dtype=dt, device=dev),
                   start=_i32(0, dev), n=_i32(0, dev))
    outs, out_n = [empty] * p, [0] * p
    truncate = eos_hit = over_budget = False
    turn = skips = ne_fires = verdicts = 0
    beam_ok = ne_on
    alive = True

    while alive and turn < eng.max_turns:
        comp, comp_n = outs[p - 1], out_n[p - 1]
        inc, inc_n = [outs[s - 1] for s in range(p)], \
            [out_n[s - 1] for s in range(p)]

        # ---- collect the completed chunk into the verified buffers ----
        if comp_n > 0:
            normed = final_hidden(params, comp.h[None], mc)[0]
            logits = lm_head_logits(params, normed)
            rows = (comp.start + ar_c[:comp_n]).long()
            vhidden.index_copy_(0, rows, normed[:comp_n].to(dt))
            vlogits.index_copy_(0, rows, logits[:comp_n])
            verified = verified + comp.n
            # retire it with any leading zero-length chunks
            r = torch.argmax((lens > 0).to(torch.int8)) + 1
            sh = torch.arange(s_cap, device=dev) + r
            lens = torch.where(sh < s_cap, lens[sh.clamp(0, s_cap - 1)], 0)
            n_chunks = n_chunks - r.to(torch.int32)
            next_inject = next_inject - r.to(torch.int32)

        # ---- whether to verdict this turn (read A unless it is known) ----
        can_ne = can_expand = False
        if inflight and comp_n > 0:
            do_verdict = True
        else:
            all_verified = verified >= tree.n_nodes
            if inflight:
                drained = (n_chunks <= 0) | (lens.sum() <= 0)
                dv = drained & all_verified
            else:
                dv = all_verified & (tree.n_nodes > 0)
            flags = [dv]
            if ne_on:
                flags.append(tree.n_nodes < n_cap)
            if pipedec:
                flags.append(_pd_gate(tree, n_chunks, tc))
            got = read(*flags)
            do_verdict = bool(got[0])
            if ne_on:
                can_ne = (not do_verdict and bool(got[1]) and beam_ok
                          and verdicts > 0
                          and beam.level + tc.none_expand_depth <= ml)
            if pipedec:
                can_expand = not do_verdict and bool(got[-1])

        beam_next = None
        incoming = inc
        if do_verdict:
            verdicts += 1
            force = n_out + d_cap >= out_cap
            if turn >= eng.force_turn:
                force = torch.ones_like(force)
            sub = torch.where((tree.retrieve >= 0)
                              & (tree.retrieve < verified), tree.retrieve, -1)
            vtree = dataclasses.replace(tree, retrieve=sub)
            if sampling.is_greedy:
                res = evaluate_posterior_greedy(vlogits, vtree)
            else:
                res = evaluate_posterior_stochastic(
                    vlogits, vtree, sampling, draws, max_trials=tc.leaf_cap)
            new_root_tok = sample_token(draws, res.sample_p, sampling,
                                        is_probs=True)
            n_acc = res.accept_len + 1
            info = compute_pruning_info(tree, res.best_leaf, n_acc,
                                        new_root_tok)
            trunc = (info.truncate | force) if inflight else \
                torch.ones((), dtype=torch.bool, device=dev)

            # commit the accepted tokens
            path = take(tree.retrieve, res.best_leaf)
            pv = d_idx < n_acc
            safe_path = path.clamp(0, n_cap - 1).long()
            acc_tokens = torch.where(pv, tree.tokens[safe_path], 0)
            wpos = torch.where(pv & (n_out + d_idx < out_cap),
                               n_out + d_idx, out_cap)
            out_tokens.index_copy_(0, wpos.long(), acc_tokens.to(torch.int32))
            n_out = n_out + n_acc
            eos_dev = (pv & (acc_tokens == eos_id)).any() if eos_id >= 0 \
                else torch.zeros((), dtype=torch.bool, device=dev)
            over_dev = n_out >= budget
            trunc = trunc | eos_dev | over_dev

            # the pruned tree and the remapped buffers
            new_tree = prune_tree(tree, info)
            old2new = old_to_new(info, n_cap)
            in_r = ar_n < info.n_kept
            src = info.kept_old_ids.clamp(0, n_cap - 1).long()
            lens2 = rebucket_lengths(
                lens, torch.where(info.kept_old_ids >= 0,
                                  info.kept_old_ids - verified, -1),
                info.n_kept)
            n_chunks = n_chunks.clamp_min(0)
            flags = [trunc, eos_dev, over_dev]
            if pipedec:
                flags.append(_pd_gate(new_tree, n_chunks, tc))
            got = read(*flags)
            truncate, eos_hit, over_budget = (bool(x) for x in got[:3])
            can_expand = pipedec and not truncate and bool(got[-1])

            # per-stage KV compaction
            for s in range(p):
                lo, hi = eng.stage_layers[s]
                src_pos, n_src = kv_keep_positions(
                    info, commit, kv_tree_len[s], n_cap + d_cap)
                if truncate:        # keep only the accepted path
                    n_src = n_acc
                if hi > lo:
                    eng.stage_cache(kv, s).compact(src_pos, n_src, commit)
                kv_tree_len[s] = _i32(0, dev) if truncate else (
                    (info.kept_old_ids >= 0)
                    & (info.kept_old_ids < kv_tree_len[s])).sum().to(
                        torch.int32)

            # the draft pairs: accepted tokens + the new root
            shifted = torch.roll(acc_tokens, -1)
            pair_tok = torch.where(d_idx + 1 < n_acc, shifted, 0)
            pair_tok = torch.where(d_idx + 1 == n_acc, new_root_tok,
                                   pair_tok)
            pair_tok = torch.where(pv, pair_tok, 0).to(torch.int32)
            ph = torch.where(pv[:, None], vhidden[safe_path], 0).to(dt)
            pend_tok = torch.cat([pair_tok, pair_tok.new_zeros(ctx - d_cap)])
            pend_hid = torch.cat([ph, ph.new_zeros((ctx - d_cap, h_dim))])[
                None]
            pend_n = n_acc if truncate else _i32(0, dev)
            commit = commit + n_acc
            sampled_root = new_root_tok
            if truncate:
                turn += 1
                break

            vhidden = torch.where(in_r[:, None], vhidden[src], 0)
            vlogits = torch.where(in_r[:, None], vlogits[src], 0.0)
            dhidden = torch.where(in_r[:, None], dhidden[src], 0)
            dh_valid = in_r & dh_valid[src]
            verified = (in_r & (info.kept_old_ids < verified)).sum().to(
                torch.int32)
            tree, lens = new_tree, lens2
            next_inject = next_inject.clamp_min(0)

            # in-flight pruning of every stage's incoming chunk
            incoming = list(inc)
            for s in range(1, p):
                if inc_n[s] > 0:
                    incoming[s] = _remap_flight(inc[s], old2new, n_cap)

            # drain the pairs (+ expansion)
            if do_expand:
                d_out2, dcache = draft_context_forward(
                    draft, dcache, pend_tok, pend_hid, dcache.length, n_acc,
                    mc)
                rh = take(d_out2[0], (n_acc - 1).clamp(0, ctx - 1))
                fresh, beam, dcache = topk_generate(
                    draft, bhead, dcache, new_root_tok, rh, tc, mc,
                    num_select=tc.expand_tokens, depth=tc.expand_depth,
                    max_levels=ml)
                mr = merge_trees(tree, fresh, beam.level + 1)
                lens, n_chunks, can_queue = _queue_appended(
                    lens, n_chunks, mr.n_appended, tc.expand_chunk_len,
                    s_cap)
                tree = _select_tree(can_queue, mr.tree, tree)
                beam_ok = tc.none_expand
            elif pipedec:
                dcache = _pipedec_drain(dcache, info, pend_tok, pend_hid,
                                        n_acc, draft, mc, n_cap)
            else:
                _, dcache = draft_context_forward(
                    draft, dcache, pend_tok, pend_hid, dcache.length, n_acc,
                    mc)

        if can_ne:
            # no-completion expansion (`:1028-1064`): deepen the saved
            # beam and merge the new nodes; the beam is kept only if they
            # were queued (known after read C)
            tree_x, beam_next, dcache = expand_tree(
                draft, bhead, dcache, beam, tree.tokens[0], tc, mc,
                extra_depth=tc.none_expand_depth,
                expand_size=tc.none_expand_tokens, max_levels=ml)
            mr = merge_trees(tree, tree_x, beam_next.level + 1)
            lens, n_chunks, okq = _queue_appended(
                lens, n_chunks.clamp_min(0), mr.n_appended,
                tc.expand_chunk_len, s_cap)
            tree = _select_tree(okq, mr.tree, tree)
            ne_fires += 1

        if can_expand:
            tree, lens, n_chunks, dhidden, dh_valid = _pd_expand(
                eng, tree, lens, n_chunks, dhidden, dh_valid, dcache)

        # ---- stage 0 injects the next queued chunk, the others take the
        # ring's ----
        cum = torch.cumsum(lens, 0)
        q = next_inject.clamp(0, s_cap - 1)
        inj_start = verified + torch.where(
            q > 0, take(cum, (q - 1).clamp_min(0)), 0).to(torch.int32)
        inj_len = torch.where((next_inject >= 0) & (next_inject < n_chunks),
                              take(lens, q), 0).to(torch.int32)
        inj_tok = torch.where(
            ar_c < inj_len,
            tree.tokens[(inj_start + ar_c).clamp(0, n_cap - 1).long()], 0)
        mine = [Flight(h=embed_tokens(params, inj_tok[None])[0].to(dt),
                       start=inj_start, n=inj_len)] + incoming[1:]
        next_inject = torch.where(next_inject < n_chunks, next_inject + 1,
                                  next_inject)
        more = (next_inject < n_chunks) | (verified < tree.n_nodes)

        # ---- read C: every stage's chunk length, the aliveness ----
        flags = [fl.n for fl in mine] + [more]
        if beam_next is not None:
            flags.append(okq)
        got = read(*flags)
        my_n = got[:p]
        if beam_next is not None and got[-1]:
            beam = beam_next

        # ---- forward ----
        anc = (ancestor_matrix(tree.parents, d_cap, tree.valid())
               if any(my_n) else None)
        outs = []
        for s, fl in enumerate(mine):
            if my_n[s] > 0:
                h = _forward_chunk(eng, s, kv, anc, tree.depth, fl, commit)
                kv_tree_len[s] = torch.maximum(kv_tree_len[s],
                                               fl.start + fl.n)
                outs.append(Flight(h=h, start=fl.start, n=fl.n))
            else:
                outs.append(fl)
        out_n = my_n
        alive = any(my_n) or bool(got[p])
        turn += 1
        skips += 0 if do_verdict else 1

    new_state = PipeState(
        kv=kv.with_length(commit), draft_cache=dcache, commit_len=commit,
        root_token=sampled_root if truncate else state.root_token,
        pend_tok=pend_tok, pend_hid=pend_hid, pend_n=pend_n, rng=draws.rng)
    return new_state, RoundOut(
        out_tokens=out_tokens[:out_cap], n_out=n_out, turns=turn,
        skips=skips, ne_fires=ne_fires, eos_hit=eos_hit,
        over_budget=over_budget, stalled=verdicts == 0)


def _remap_flight(fl: Flight, old2new: torch.Tensor, n_cap: int) -> Flight:
    """A chunk's rows through the pruning map, compacted to the kept ones
    (`:911-921`); a chunk emptied by pruning travels on with n 0."""
    c_buf = fl.h.shape[0]
    ar = torch.arange(c_buf, device=fl.h.device)
    nid = torch.where(ar < fl.n,
                      old2new[(fl.start + ar).clamp(0, n_cap - 1).long()],
                      -1)
    keep = nid >= 0
    order = kept_order(keep)
    nid2 = nid[order]
    n2 = keep.sum().to(torch.int32)
    return Flight(h=fl.h[order],
                  start=torch.where(n2 > 0, nid2[0], 0).to(torch.int32),
                  n=n2)


def _pd_gate(tree: TokenTree, n_chunks, tc) -> torch.Tensor:
    """pipedec's expansion gate without the truncate term (`:1143-1148`)."""
    maxd = torch.where(tree.valid(), tree.depth, 0).max()
    return (tree.n_nodes + tc.top_k <= tc.node_cap) \
        & (maxd + 2 < tc.depth_cap) & (n_chunks < tc.chunk_cap)


def _pipedec_drain(dcache: KVCache, info, pend_tok, pend_hid, n_acc,
                   draft, mc, n_cap: int) -> KVCache:
    """pipedec's draft KV mirrors the base layout (ctx pairs, then tree
    nodes at dctx + node id): gather the kept tree rows first, drain the
    accepted pairs (a ctx-row block at dctx), then write the kept rows at
    dctx + n_acc, over the drain's padding (`:970-990`)."""
    dctx = dcache.length
    s_max = dcache.max_len
    keep_src = (info.kept_old_ids.clamp(0, n_cap - 1) + dctx).clamp(
        0, s_max - 1).long()
    kk = dcache.k.index_select(3, keep_src)
    vv = dcache.v.index_select(3, keep_src)
    _, dcache = draft_context_forward(draft, dcache, pend_tok, pend_hid,
                                      dctx, n_acc, mc)
    rows = (clamp_start(dctx + n_acc, n_cap, s_max)
            + torch.arange(n_cap, device=dctx.device)).long()
    dcache.k.index_copy_(3, rows, kk)
    dcache.v.index_copy_(3, rows, vv)
    return dcache.with_length(dctx + n_acc)


def _pd_expand(eng: PipelineEngine, t: TokenTree, lens, n_chunks, dhidden,
               dh_valid, dc: KVCache):
    """pipedec: grow the tree by one level (`:1073-1141`): the frontier
    (the deepest level, a trailing id block) is forwarded through the
    draft layer against the ctx pairs and its tree ancestors, scored by
    the head top-k (kernel 6 on the card), and the best top_k children are
    appended as one new chunk."""
    tc, mc, draft = eng.cfg.tree, eng.cfg.model, eng.draft
    n_cap, k = tc.node_cap, tc.top_k
    dev = t.tokens.device
    valid = t.valid()
    maxd = torch.where(valid, t.depth, 0).max()
    n_f = (valid & (t.depth == maxd)).sum().to(torch.int32)
    f_start = t.n_nodes - n_f
    fi = torch.arange(k, device=dev)
    f_ids = f_start + fi
    fv = fi < n_f
    sf = f_ids.clamp(0, n_cap - 1).long()
    dctx = dc.length

    par_h = dhidden[t.parents[sf].clamp(0, n_cap - 1).long()]
    x = fuse(draft, t.tokens[sf][None], par_h[None])
    positions = dctx + (t.depth[sf] - 1).clamp_min(0)
    jd = torch.arange(dc.max_len, device=dev)[None, :]
    rowsb = ancestor_matrix(t.parents, t.depth_cap, valid)[sf] & fv[:, None]
    tree_ok = torch.gather(rowsb, 1, (jd - dctx).clamp(0, n_cap - 1).expand(
        k, dc.max_len))
    # tree column 0 (the root) lives in the ctx region: excluded
    okb = torch.where(jd < dctx, True, tree_ok & (jd > dctx))
    out_h = eagle_layer(x, draft, dc.k[0], dc.v[0], positions,
                        torch.where(okb, 0.0, NEG_INF), dctx + f_start,
                        eng.dcfg)
    out_h = project_out(draft, out_h, par_h[None])[0]           # (k, H)
    dhidden = _drop_set(dhidden, sf, out_h, fv)
    dh_valid = _drop_set(dh_valid, sf, torch.ones_like(fv), fv)

    row_lp, row_tok = head_topk(out_h / tc.score_temperature, eng.beam_head,
                                k)
    cu = row_lp + torch.where(fv, t.scores[sf], -torch.inf)[:, None]
    top_sc, sel = _topk_stable(cu.reshape(-1), k)
    ok = top_sc > -torch.inf
    wpos = t.n_nodes + fi
    tokens = _drop_set(t.tokens, wpos, row_tok.reshape(-1)[sel], ok)
    parents = _drop_set(t.parents, wpos, f_ids[sel // k], ok)
    scores = _drop_set(t.scores, wpos, top_sc, ok)
    n_new = ok.sum().to(torch.int32)
    t2 = finalize_tree(tokens, parents, scores, t.n_nodes + n_new,
                       t.leaf_cap, t.depth_cap)
    lens = lens.index_copy(0, n_chunks.clamp(0, tc.chunk_cap - 1).reshape(
        1).long(), n_new.reshape(1))
    return t2, lens, n_chunks + 1, dhidden, dh_valid
