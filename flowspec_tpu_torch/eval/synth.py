"""Deterministic synthetic corpus with LEARNABLE sequential structure.

The port's copy of `flowspec_tpu/eval/synth.py` (numpy only): its arrays
are bit-equal to the JAX package's for the same arguments. It makes the
prompts of the struct tiny8 gate of `entry.dryrun_multichip`.

Purpose: this environment has no model checkpoints, so the bench base is
random-weight — and a random base's greedy dynamics collapse to token
attractors that make distilled-draft acceptance artificially easy, while
its near-flat softmax makes stochastic (T=1) acceptance artificially hard
(ROADMAP honesty notes). This corpus lets the repo TRAIN a base model with
genuine sequential structure (tools/train_struct_base.py) and then earn
draft acceptance against it — the realistic middle ground between the
random base and the real-checkpoint evaluation the reference runs
(reference eval/run_pipe_eval.py:348-360 measures mean accepted length on
real Vicuna/LLaMA2 weights; see data/*/question.jsonl for its prompt sets).

The process mixes three mechanisms a transformer can learn, chosen so the
next-token distribution has REAL but PARTIAL predictability (like text,
top-1 achievable accuracy ~0.5, not ~1.0):

  struct (p_struct): next token drawn from a fixed 4-candidate table
      indexed by the CLASS (token % n_classes) of the previous two tokens,
      mixed with the class of the token `copy_dist` back — a (K, K, 4)
      lookup the model must memorize plus a long-range feature, with a
      peaked-but-not-deterministic candidate distribution.
  copy (p_copy): next token copies the token `copy_dist` positions back —
      induction-head structure.
  noise (remainder): Zipf-distributed unigram draw — irreducible entropy.

Everything derives from `seed`; no corpus files need committing.
"""

from __future__ import annotations

import numpy as np

CAND_P = np.array([0.60, 0.22, 0.12, 0.06])


def struct_tables(vocab: int, n_classes: int, seed: int):
    """The fixed structure underlying the corpus: candidate table and the
    Zipf unigram distribution (rank permutation fixed by the seed)."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    cand = rng.integers(0, vocab, (n_classes, n_classes, 4))
    ranks = 1.0 / np.arange(1, vocab + 1) ** 1.2
    zipf = ranks / ranks.sum()
    perm = rng.permutation(vocab)
    zipf_p = np.zeros(vocab)
    zipf_p[perm] = zipf
    return cand, zipf_p


def gen_struct_corpus(n_seqs: int, seq_len: int, vocab: int = 8192,
                      seed: int = 0, n_classes: int = 64,
                      p_struct: float = 0.65, p_copy: float = 0.15,
                      copy_dist: int = 16, table_seed: int = 0) -> np.ndarray:
    """(n_seqs, seq_len) int32 corpus. Vectorized over sequences; one
    numpy pass per position. `table_seed` fixes the LANGUAGE (candidate
    table + Zipf permutation); `seed` varies only the sampling — train/
    rollout/eval splits share a table_seed with different seeds."""
    assert seq_len > copy_dist >= 2
    cand, zipf_p = struct_tables(vocab, n_classes, table_seed)
    rng = np.random.default_rng(seed)
    x = np.zeros((n_seqs, seq_len), np.int64)
    # warmup positions: pure noise
    x[:, :copy_dist] = rng.choice(vocab, size=(n_seqs, copy_dist),
                                  p=zipf_p)
    for t in range(copy_dist, seq_len):
        branch = rng.random(n_seqs)
        s1 = x[:, t - 1] % n_classes
        s2 = (x[:, t - 2] + x[:, t - copy_dist]) % n_classes
        j = rng.choice(4, size=n_seqs, p=CAND_P)
        struct_tok = cand[s1, s2, j]
        copy_tok = x[:, t - copy_dist]
        noise_tok = rng.choice(vocab, size=n_seqs, p=zipf_p)
        x[:, t] = np.where(
            branch < p_struct, struct_tok,
            np.where(branch < p_struct + p_copy, copy_tok, noise_tok))
    return x.astype(np.int32)


def oracle_next_token_dist(x: np.ndarray, t: int, vocab: int,
                           n_classes: int = 64, p_struct: float = 0.65,
                           p_copy: float = 0.15, copy_dist: int = 16,
                           table_seed: int = 0) -> np.ndarray:
    """True conditional distribution of token t given the prefix — the
    Bayes-optimal predictor a perfectly-trained base converges to. Used by
    tests to bound how well the trained base SHOULD do."""
    cand, zipf_p = struct_tables(vocab, n_classes, table_seed)
    p = (1.0 - p_struct - p_copy) * zipf_p.copy()
    s1 = int(x[t - 1]) % n_classes
    s2 = (int(x[t - 2]) + int(x[t - copy_dist])) % n_classes
    for j in range(4):
        p[cand[s1, s2, j]] += p_struct * CAND_P[j]
    p[int(x[t - copy_dist])] += p_copy
    return p
