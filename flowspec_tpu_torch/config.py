"""Typed configuration tree for the PyTorch port of flowspec-tpu.

An own copy of the JAX package's config (the port imports nothing from
it); the fields and defaults are the same so parity tests can build both
from one set of values.

Replaces the reference's module-singleton dataclass (`config/run_config.py:7-195`)
and the per-stage persisted `StageEaConfig` (`stage_ea_config.py:5-211`) with
explicit, immutable config objects passed down the call tree. Static tree
capacities are first-class here because every tensor in the engine is padded to
them (the reference uses dynamic shapes throughout; on TPU shapes must be
static).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Draft-tree hyperparameters + static padded capacities.

    Reference defaults (config/run_config.py:122-179): initial tree of
    ``total_tokens=80`` nodes grown with a ``top_k=10`` beam for ``depth=6``
    levels, streamed in chunks of ``subseq_len=16``; incremental expansion adds
    up to ``expand_tokens=64`` nodes (``none_expand``: 48, depth 2).
    """

    # Beam / tree growth (ref: eagle/cnets.py:700-846).
    top_k: int = 10
    depth: int = 6
    total_tokens: int = 80          # nodes *excluding* the root
    # Incremental expansion (ref: eagle/cnets.py:1439-1708, config 133-139).
    expand_tokens: int = 64
    expand_depth: int = 6
    none_expand_tokens: int = 48
    none_expand_depth: int = 2
    # Chunking for the pipeline (ref: pipeline_utils.py:673-715).
    chunk_len: int = 16
    # Score-sorted node order (ref: eagle/cnets.py:856-866, draft_gen_sort_score,
    # default True for pruned/continuous): nodes are laid out by descending
    # cumulative log-prob instead of BFS, so chunk 0 — the first to reach a
    # verdict — carries the highest-probability (most-likely-accepted) paths.
    # Ancestor-before-descendant ordering is preserved because cumulative
    # log-probs are monotone non-increasing along paths.
    sort_score: bool = True
    # Cap on each appended chunk after a merge (ref: expand_subseq_token,
    # config/run_config.py:133 + stage_ea_model.py:1380-1385). -1 = uncapped
    # (the reference default): the whole appended node set queues as one
    # chunk. >0: appended nodes split into ceil(n/cap) queue entries so one
    # oversized chunk never raises per-turn latency for the stages behind it.
    # TPU note: the pipeline's flight buffers are statically padded to the
    # largest possible chunk, so an uncapped append makes EVERY turn pay for
    # an expand_tokens-row forward — capping at chunk_len is strictly better
    # here and is the default.
    expand_chunk_len: int = 16
    # Beam score temperature (tree-SHAPE knob, this repo's addition): the
    # beam ranks candidates by cumulative log-softmax(logits / tau). Per-row
    # top-k order is tau-invariant, so the PROPOSED token set per node never
    # changes — only how node budget is allocated across depths. tau < 1
    # sharpens scores so confident chains out-rank wide shallow fans and
    # the tree grows deeper; tau = 1 is exact reference behavior
    # (eagle/cnets.py:833-846 ranks by raw cumulative log-probs). Matters
    # when the base's softmax is flat relative to its argmax stability
    # (e.g. the random-weight bench base: top-1 agreement ~0.86 but top-1
    # prob ~1e-3, so at tau=1 the whole node budget lands on levels 0-1 and
    # caps acceptance at ~3/round regardless of draft quality). Greedy
    # losslessness is unaffected (proposal-set-independent).
    score_temperature: float = 1.0
    # No-completion expansion (ref none_expand, run_config.py:175-179 — default
    # True for continuous): on pipeline-bubble turns (no chunk completed), the
    # draft deepens its *saved* beam by `none_expand_depth` levels and merges
    # the top `none_expand_tokens` new nodes instead of idling.
    none_expand: bool = True

    # ---- Static capacities (TPU-only concept) ----
    # Max nodes a (merged) tree can ever hold, incl. root. Initial 81 nodes +
    # repeated expansions are capped here; merge spills lowest-score nodes.
    node_cap: int = 192
    # Max leaves tracked in retrieve_indices. A tree of N nodes has < N leaves.
    leaf_cap: int = 128
    # Max root-to-leaf depth (root at d=0). Bounded by accumulated expansions.
    depth_cap: int = 24
    # Max chunks in flight (lens_split length). >= num_stages + in-flight appends.
    chunk_cap: int = 16

    def __post_init__(self):
        assert self.node_cap > self.total_tokens
        assert self.depth_cap > self.depth


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """HF-style logits warping (ref: pipeline_utils.py:61-77)."""

    temperature: float = 0.0
    top_p: float = 0.0
    top_k: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature < 1e-5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Transformer architecture description (LLaMA / Qwen2 / Mixtral families).

    Mirrors the fields the reference reads from HF configs
    (eagle/modeling_llama_kv.py, stage_ea_config.py).
    """

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2560   # ref forces 2560 (stage_ea_config.py:108)
    attention_bias: bool = False          # True for Qwen2 qkv (modeling_qwen2_kv.py:482)
    tie_word_embeddings: bool = False
    # MoE (Mixtral) — 0 experts means dense MLP.
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama_7b() -> "ModelConfig":
        return ModelConfig()

    @staticmethod
    def llama_13b() -> "ModelConfig":
        return ModelConfig(hidden_size=5120, intermediate_size=13824,
                           num_hidden_layers=40, num_attention_heads=40,
                           num_key_value_heads=40)

    @staticmethod
    def qwen2_7b() -> "ModelConfig":
        return ModelConfig(vocab_size=152064, hidden_size=3584,
                           intermediate_size=18944, num_hidden_layers=28,
                           num_attention_heads=28, num_key_value_heads=4,
                           rope_theta=1e6, attention_bias=True,
                           rms_norm_eps=1e-6)

    @staticmethod
    def mixtral_8x7b() -> "ModelConfig":
        return ModelConfig(hidden_size=4096, intermediate_size=14336,
                           num_hidden_layers=32, num_attention_heads=32,
                           num_key_value_heads=8, num_local_experts=8,
                           num_experts_per_tok=2, rope_theta=1e6)

    @staticmethod
    def tiny(vocab_size: int = 256, n_layers: int = 2) -> "ModelConfig":
        """Small random-weight config for tests."""
        return ModelConfig(vocab_size=vocab_size, hidden_size=64,
                           intermediate_size=128, num_hidden_layers=n_layers,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=512)


@dataclasses.dataclass(frozen=True)
class DeepseekConfig(ModelConfig):
    """DeepSeek-V3 (`models/deepseek.py`): the LLaMA fields above (the dense
    layers' SwiGLU width is intermediate_size) and these. A subclass, so
    that a LLaMA-family config keeps exactly the JAX package's fields."""

    # Latent attention (MLA): q through a q_lora_rank bottleneck, one latent KV
    # row of kv_lora_rank + qk_rope_head_dim values a token.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN rope scaling (factor 0: none)
    yarn_factor: float = 0.0
    yarn_original_max_position: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 1.0
    # DeepSeek's MoE: the first `first_k_dense_replace` layers are dense
    # SwiGLUs of intermediate_size, the rest route over n_routed_experts
    # SwiGLUs of moe_intermediate_size (sigmoid scores, n_group groups of
    # which topk_group are kept, num_experts_per_tok experts, weights
    # normalised then x routed_scaling_factor) beside n_shared_experts.
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    first_k_dense_replace: int = 0
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    # the expert share: the ids of the routed experts this card holds
    # (expert parallelism; () = every one)
    held_experts: Tuple[int, ...] = ()

    @property
    def latent_dim(self) -> int:
        """Values a token and layer in the latent (MLA) KV cache."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class StageTopology:
    """Pipeline topology: how base-model layers map onto verify stages.

    The reference hard-codes 1 draft stage + 4 verify stages with layers split
    0+8+8+8+8 (config/run_config.py:80,120; tools/split_and_save_models.py:33-57).
    Here the draft head + lm_head + embeddings are *replicated* across the mesh
    (they are small) so there is no asymmetric rank-0 — every device runs the
    same SPMD program and computes the draft/verdict redundantly, which deletes
    the reference's entire broadcast control plane (comm/comm_handler.py:211-234).
    """

    num_stages: int = 4                  # verify stages == mesh axis size
    layers_per_stage: Tuple[int, ...] = (8, 8, 8, 8)

    @property
    def total_layers(self) -> int:
        return sum(self.layers_per_stage)

    @staticmethod
    def even(num_layers: int, num_stages: int) -> "StageTopology":
        base, rem = divmod(num_layers, num_stages)
        # Smaller shards first, like the reference's split_close_equal
        # (pipeline_utils.py:136-146 reverses so larger counts go last).
        sizes = tuple(base + (1 if i >= num_stages - rem else 0)
                      for i in range(num_stages))
        return StageTopology(num_stages=num_stages, layers_per_stage=sizes)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine knobs (ref: config/run_config.py)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    tree: TreeConfig = dataclasses.field(default_factory=TreeConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    topology: StageTopology = dataclasses.field(default_factory=StageTopology)
    max_new_tokens: int = 512
    max_seq_len: int = 2560              # KV capacity (ref: stage_ea_config.py:108)
    prefill_chunk: int = 64              # ref: ~60-token chunks (pipeline_utils.py:196)
    pipeline_type: str = "continuous"    # ar|serial|naive|pruned|continuous|pipedec
    # Quantization of the lm_head COPY used for beam scoring (the draft reads
    # the head once per tree level — ~8x per round); verification always uses
    # the exact head, so greedy losslessness is unaffected (proposal-
    # independent). "auto" = int8 iff the draft weights are quantized.
    beam_head_quant: str = "auto"        # auto|none|int8
    # KV bucket growth for long generations: attention reads the WHOLE
    # static KV allocation every pass (dense path), so allocating
    # max_seq_len rows up front taxes every early round (+11.8ms/round at
    # 7B for a 2816-row alloc vs 512 at ~100 live tokens — PROFILE_7b_
    # int8.md). With buckets, generate_fused starts in the smallest bucket
    # that fits the prompt and migrates (zero-pads) the caches to the next
    # bucket when commit_len approaches the current one; each bucket is a
    # separately compiled fused loop (cached). () = single allocation at
    # max_seq_len. SpecEngine-family engines only (the pipeline engine
    # keeps one allocation — its KV is stage-sharded state).
    kv_buckets: tuple = ()               # ascending max_seq values
    # SYNTHETIC-ACCEPTANCE BENCH MODE (measurement only): when > 0, the
    # greedy verdict is overridden to accept min(force_accept, deepest
    # path) nodes along the deepest drafted path each round. Output tokens
    # are then NOT the base model's distribution — this exists solely to
    # measure the engine's acceptance->throughput scaling on hardware
    # (random weights pin acceptance at ~1; trained EAGLE drafts reach
    # ~3-4, reference README). Never set in production.
    force_accept: int = 0
