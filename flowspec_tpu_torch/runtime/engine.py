"""Single-device tree-speculative decoding engine.

Port of `flowspec_tpu/runtime/engine.py` (single-request path):
prefill -> [draft context -> beam tree -> verify the whole tree -> greedy
accept -> compact KV] -> ... The JAX package jits each step and runs the
round loop on device; here each step runs eagerly and the round loop is a
Python loop. Positions and lengths (commit_len, n_pending, cache lengths)
are host ints, so every kernel launch knows its live KV rows without a
device sync; the round syncs once, to read the accepted length.

Not ported yet (ROADMAP.md, Queue 1): `generate_fused` / CUDA graphs, KV
buckets, `resume_and_generate`, `serve` and `force_accept`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from flowspec_tpu_torch.config import (
    EngineConfig, ModelConfig, SamplingConfig, TreeConfig,
)
from flowspec_tpu_torch.draft.beam import topk_generate
from flowspec_tpu_torch.draft.eagle import (
    EagleParams, draft_context_forward, draft_view,
)
from flowspec_tpu_torch.models.bias import prefill_bias, tree_bias
from flowspec_tpu_torch.models.kv_cache import KVCache, init_kv_cache
from flowspec_tpu_torch.models.llama import (
    LlamaParams, embed_tokens, final_hidden, lm_head_logits, llama_forward,
)
from flowspec_tpu_torch.ops.quant import Int8Tensor, NF4Tensor, quantize_int8
from flowspec_tpu_torch.tree.posterior import (
    evaluate_posterior_greedy, evaluate_posterior_stochastic,
)
from flowspec_tpu_torch.tree.sampling import sample_token
from flowspec_tpu_torch.tree.types import tree_attention_bias


def resolve_device(device=None) -> torch.device:
    """The engine's device: `cuda` unless the caller names another; a CUDA
    device without a card raises (there is no silent CPU fallback)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    return dev


def make_beam_head(params: LlamaParams, draft: EagleParams,
                   cfg: EngineConfig):
    """The lm_head copy the draft beam scores proposals with
    (EngineConfig.beam_head_quant; "auto" = int8 for an int8 or nf4 draft,
    plain for an int4 or unquantized one, as in the JAX package)."""
    mode = cfg.beam_head_quant
    if mode == "auto":
        mode = ("int8" if isinstance(draft.wq, (Int8Tensor, NF4Tensor))
                else "none")
    if mode == "int8":
        return quantize_int8(params.lm_head)
    assert mode == "none", mode
    return params.lm_head


@dataclasses.dataclass
class EngineState:
    base_cache: KVCache
    draft_cache: KVCache
    commit_len: int                # committed tokens (== base KV length)
    root_token: torch.Tensor       # () int32 — current speculation root
    pending_tokens: torch.Tensor   # (CTX,) int32 — draft pairs not consumed
    pending_hidden: torch.Tensor   # (1, CTX, H)
    n_pending: int
    root_hidden: torch.Tensor      # (H,) — draft hidden of the root pair,
                                   #   used when n_pending == 0
    generator: Optional[torch.Generator] = None


class SpecEngine:
    """Owns params and the step functions for one (base, draft) pair."""

    def __init__(self, params: LlamaParams, draft: EagleParams,
                 cfg: EngineConfig, device=None):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.draft = draft
        self.dcfg = draft_view(draft, cfg.model)
        tc = cfg.tree
        # fresh (never merged) trees hold exactly total_tokens+1 nodes of
        # depth <= depth: clamp the static caps to that envelope, as the
        # JAX engine does, so verify runs no padded rows beyond it
        tc = dataclasses.replace(
            tc,
            node_cap=min(tc.node_cap, tc.total_tokens + 1),
            leaf_cap=min(tc.leaf_cap, tc.total_tokens + 1),
            depth_cap=min(tc.depth_cap, tc.depth + 1))
        self.cfg = dataclasses.replace(cfg, tree=tc)
        self.beam_head = make_beam_head(params, draft, self.cfg)
        # pending pair buffers hold a full prefill chunk until the first
        # round drains them
        self.ctx_pad = max(tc.depth_cap + 1, cfg.prefill_chunk)
        self._max_levels = tc.depth + tc.expand_depth
        self.draft_kv_len, self.base_kv_len = self._kv_rows(cfg.max_seq_len)

    # ---- state setup -----------------------------------------------------
    def _kv_rows(self, max_seq: int):
        """(draft_rows, base_rows), rounded up to 256 (the attention kernel
        reads whole 256-row blocks)."""
        tc = self.cfg.tree
        rnd = lambda n: -(-n // 256) * 256
        return (rnd(max_seq + self._max_levels * tc.top_k),
                rnd(max_seq + tc.node_cap))

    def init_state(self, seed: int = 0) -> EngineState:
        mc = self.cfg.model
        dt = getattr(torch, mc.dtype)
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return EngineState(
            base_cache=init_kv_cache(mc.num_hidden_layers, 1,
                                     mc.num_key_value_heads,
                                     self.base_kv_len, mc.head_dim_, dt, dev),
            draft_cache=init_kv_cache(1, 1, self.dcfg.num_key_value_heads,
                                      self.draft_kv_len, self.dcfg.head_dim_,
                                      dt, dev),
            commit_len=0,
            root_token=torch.zeros((), dtype=torch.int32, device=dev),
            pending_tokens=torch.zeros((self.ctx_pad,), dtype=torch.int32,
                                       device=dev),
            pending_hidden=torch.zeros((1, self.ctx_pad, mc.hidden_size),
                                       dtype=dt, device=dev),
            n_pending=0,
            root_hidden=torch.zeros((mc.hidden_size,), dtype=dt, device=dev),
            generator=gen)

    # ---- prefill ---------------------------------------------------------
    def _prefill_chunks(self, state: EngineState, prompt):
        """Consume `prompt` in `prefill_chunk`-token chunks, leaving the last
        chunk's draft pairs pending with a placeholder in the final slot."""
        c = self.cfg.prefill_chunk
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = len(prompt)
        n_chunks = max(1, -(-p // c))
        padded = np.zeros((n_chunks * c,), np.int32)
        padded[:p] = prompt
        nxt = np.roll(padded, -1)
        dev = self.device
        for i in range(n_chunks):
            state, last_logits = _prefill_chunk(
                state, self.params, self.draft,
                torch.from_numpy(padded[i * c:(i + 1) * c]).to(dev),
                torch.from_numpy(nxt[i * c:(i + 1) * c]).to(dev),
                min(c, p - i * c), cfg=self.cfg.model)
        return state, last_logits

    def prefill(self, state: EngineState, prompt) -> EngineState:
        """Chunked prefill; the draft context advances in lockstep with the
        pairs (token_{i+1}, base_hidden_i)."""
        state, last_logits = self._prefill_chunks(state, prompt)
        return _finish_prefill(state, self.draft, last_logits,
                               cfg=self.cfg.model,
                               ctx_small=self.cfg.tree.depth_cap + 1,
                               sampling=self.cfg.sampling)

    def _check_budget(self, prompt, max_new: int):
        """Tree chunks are written at [commit, commit + node_cap), so commit
        may never pass max_seq_len (a clamped write would overwrite the
        newest valid rows)."""
        need = (len(np.asarray(prompt).reshape(-1)) + max_new
                + self.cfg.tree.depth_cap + 1)
        if need > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt+max_new+depth_cap = {need} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}; raise EngineConfig.max_seq_len or "
                "shorten the request")

    # ---- decoding --------------------------------------------------------
    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_token_id: int = 2, seed: int = 0,
                 return_state: bool = False):
        """Returns (tokens list incl prompt, stats dict[, final state])."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        self._check_budget(prompt, max_new)
        state = self.prefill(self.init_state(seed), prompt)
        out = [int(t) for t in np.asarray(prompt).reshape(-1)]
        return self._decode_rounds(state, out, max_new, eos_token_id,
                                   return_state)

    def _decode_rounds(self, state, out, max_new, eos_token_id,
                       return_state):
        new_tokens = 0
        rounds = 0
        while new_tokens < max_new:
            state, accepted = _spec_round(
                state, self.params, self.draft, self.beam_head,
                cfg=self.cfg.model, tree_cfg=self.cfg.tree,
                sampling=self.cfg.sampling)
            rounds += 1
            stop = False
            for t in accepted:
                out.append(t)
                new_tokens += 1
                if t == eos_token_id or new_tokens >= max_new:
                    stop = True
                    break
            if stop:
                break
        stats = {"new_tokens": new_tokens, "rounds": rounds,
                 "accept_per_round": new_tokens / max(rounds, 1)}
        if return_state:
            return out, stats, state
        return out, stats

    def generate_ar(self, prompt, max_new_tokens: Optional[int] = None,
                    eos_token_id: int = 2, seed: int = 0):
        """Plain autoregressive baseline (ref `ar` schedule)."""
        max_new = max_new_tokens or self.cfg.max_new_tokens
        self._check_budget(prompt, max_new)
        state = self.prefill(self.init_state(seed), prompt)
        out = [int(t) for t in np.asarray(prompt).reshape(-1)]
        tok = state.root_token
        new_tokens = 0
        while new_tokens < max_new:
            t = int(tok)
            out.append(t)
            new_tokens += 1
            if t == eos_token_id:
                break
            state, tok = _ar_step(state, self.params, cfg=self.cfg.model,
                                  sampling=self.cfg.sampling)
        return out, {"new_tokens": new_tokens}


# ---- step bodies -----------------------------------------------------------

def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    c = x.shape[0]
    if c >= n:
        return x[:n].to(torch.int32)
    return torch.cat([x, x.new_zeros((n - c,))]).to(torch.int32)


def _pad_rows(h: torch.Tensor, n: int) -> torch.Tensor:
    b, c, d = h.shape
    if c >= n:
        return h[:, :n]
    return torch.cat([h, h.new_zeros((b, n - c, d))], dim=1)


def _prefill_chunk(state: EngineState, params: LlamaParams,
                   draft: EagleParams, tokens, next_tokens, n_valid: int, *,
                   cfg: ModelConfig):
    c = tokens.shape[0]
    start = state.commit_len
    dev = tokens.device
    s_max = state.base_cache.max_len
    hidden = embed_tokens(params, tokens[None])
    bias = prefill_bias(start, c, s_max, device=dev)
    positions = start + torch.arange(c, device=dev)
    out, cache = llama_forward(params, state.base_cache, hidden, positions,
                               bias, start, cfg)
    cache = cache.with_length(start + n_valid)
    normed = final_hidden(params, out, cfg)

    # consume the *previous* pending pairs, then queue this chunk's pairs
    dstate = _drain_pending(state, draft, cfg)
    last_logits = lm_head_logits(params, normed[0, min(max(n_valid - 1, 0),
                                                        c - 1)])
    new_state = dataclasses.replace(
        dstate, base_cache=cache, commit_len=start + n_valid,
        pending_tokens=_pad_to(next_tokens, state.pending_tokens.shape[0]),
        pending_hidden=_pad_rows(normed, state.pending_hidden.shape[1]),
        n_pending=n_valid)
    return new_state, last_logits


def _finish_prefill(state: EngineState, draft: EagleParams, last_logits, *,
                    cfg: ModelConfig, ctx_small: int,
                    sampling: SamplingConfig) -> EngineState:
    """Sample the first root from `last_logits`, patch it into the final
    pending pair, drain the last prompt chunk's pairs, keep the root's draft
    hidden, and shrink the pending buffers to depth_cap+1 rows."""
    root = sample_token(state.generator, last_logits, sampling,
                        is_probs=False)
    pt = state.pending_tokens.clone()
    pt[state.n_pending - 1] = root
    state = dataclasses.replace(state, root_token=root, pending_tokens=pt)
    out, dcache = draft_context_forward(
        draft, state.draft_cache, state.pending_tokens, state.pending_hidden,
        state.draft_cache.length, state.n_pending, cfg)
    rh = out[0, min(max(state.n_pending - 1, 0), out.shape[1] - 1)]
    h = state.pending_hidden.shape[-1]
    return dataclasses.replace(
        state, draft_cache=dcache, root_hidden=rh,
        pending_tokens=state.pending_tokens.new_zeros((ctx_small,)),
        pending_hidden=state.pending_hidden.new_zeros((1, ctx_small, h)),
        n_pending=0)


def _drain_pending(state: EngineState, draft: EagleParams,
                   cfg: ModelConfig) -> EngineState:
    """Advance the draft context KV over the queued (token, hidden) pairs."""
    _, dcache = draft_context_forward(
        draft, state.draft_cache, state.pending_tokens, state.pending_hidden,
        state.draft_cache.length, state.n_pending, cfg)
    return dataclasses.replace(state, draft_cache=dcache)


def _spec_round(state: EngineState, params: LlamaParams, draft: EagleParams,
                beam_head=None, *, cfg: ModelConfig, tree_cfg: TreeConfig,
                sampling: SamplingConfig):
    """One draft -> verify -> accept round (ref eagle/ea_model.py:236-297).
    Returns (state, accepted tokens as a list of ints)."""
    n_cap = tree_cfg.node_cap
    s_max = state.base_cache.max_len
    dev = state.root_token.device

    # 1. draft context + tree generation
    out, dcache = draft_context_forward(
        draft, state.draft_cache, state.pending_tokens, state.pending_hidden,
        state.draft_cache.length, state.n_pending, cfg)
    # n_pending == 0 only on the first round after prefill (the prefill
    # drain consumed the pairs and kept the root's hidden)
    root_hidden = (out[0, min(state.n_pending - 1, out.shape[1] - 1)]
                   if state.n_pending > 0 else state.root_hidden)
    head = params.lm_head if beam_head is None else beam_head
    tree, _, dcache = topk_generate(draft, head, dcache, state.root_token,
                                    root_hidden, tree_cfg, cfg)

    # 2. verify the whole tree in one chunk of node_cap tokens
    commit = state.commit_len
    anc_bias = tree_attention_bias(tree.parents, tree_cfg.depth_cap,
                                   tree.valid())
    bias = tree_bias(anc_bias, commit, s_max)
    toks = torch.where(tree.tokens >= 0, tree.tokens, 0)
    hidden = embed_tokens(params, toks[None])
    positions = commit + tree.depth
    b_out, bcache = llama_forward(params, state.base_cache, hidden,
                                  positions, bias, commit, cfg)
    normed = final_hidden(params, b_out, cfg)            # (1, N, H)
    node_logits = lm_head_logits(params, normed[0])      # (N, V) f32

    # 3. accept
    if sampling.is_greedy:
        res = evaluate_posterior_greedy(node_logits, tree)
    else:
        res = evaluate_posterior_stochastic(
            node_logits, tree, sampling, state.generator,
            max_trials=min(2 * tree_cfg.top_k, tree_cfg.leaf_cap))
    new_root = sample_token(state.generator, res.sample_p, sampling,
                            is_probs=True)
    n_acc = int(res.accept_len) + 1                      # the round's sync

    # 4. commit: path nodes [root, a_1..a_k]
    d_cap = tree_cfg.depth_cap
    path = tree.retrieve[res.best_leaf.long()]           # (D,)
    d_idx = torch.arange(d_cap, device=dev)
    path_valid = d_idx < n_acc
    safe_path = path.clamp(0, n_cap - 1).long()
    accepted_tokens = torch.where(path_valid, tree.tokens[safe_path], -1)

    # 5. base KV compaction: keep accepted node rows right after commit
    src = torch.where(path_valid, commit + safe_path, 0)
    bcache = bcache.compact(src, n_acc, commit)

    # 6. next round's draft pairs: (a_1..a_k, new_root) with hiddens of
    # (a_0..a_k)
    ctx = state.pending_tokens.shape[0]
    shifted = torch.roll(accepted_tokens, -1)
    pair_tok = torch.where(d_idx + 1 < n_acc, shifted, 0)
    pair_tok = torch.where(d_idx + 1 == n_acc, new_root, pair_tok)
    pair_hidden = normed[:, safe_path]                   # (1, D, H)
    pair_hidden = torch.where(path_valid[None, :, None], pair_hidden,
                              torch.zeros((), dtype=pair_hidden.dtype,
                                          device=dev))

    new_state = EngineState(
        base_cache=bcache, draft_cache=dcache, commit_len=commit + n_acc,
        root_token=new_root, pending_tokens=_pad_to(pair_tok, ctx),
        pending_hidden=_pad_rows(pair_hidden, ctx), n_pending=n_acc,
        root_hidden=root_hidden, generator=state.generator)
    return new_state, accepted_tokens[:n_acc].tolist()


def _ar_step(state: EngineState, params: LlamaParams, *, cfg: ModelConfig,
             sampling: SamplingConfig):
    """Decode one token autoregressively (baseline)."""
    s_max = state.base_cache.max_len
    commit = state.commit_len
    dev = state.root_token.device
    hidden = embed_tokens(params, state.root_token.reshape(1, 1))
    bias = prefill_bias(commit, 1, s_max, device=dev)
    positions = torch.full((1,), commit, device=dev)
    out, cache = llama_forward(params, state.base_cache, hidden, positions,
                               bias, commit, cfg)
    cache = cache.with_length(commit + 1)
    logits = lm_head_logits(params, final_hidden(params, out, cfg))[0, 0]
    tok = sample_token(state.generator, logits, sampling, is_probs=False)
    return dataclasses.replace(state, base_cache=cache,
                               commit_len=commit + 1, root_token=tok), tok
