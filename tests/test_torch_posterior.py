"""The PyTorch port's acceptance against the recorded reference decisions.

tests/fixtures/posterior_ref.npz holds the reference's `evaluate_posterior`
run on identical logits (tools/make_posterior_fixture.py), the fixture
tests/test_posterior_fixture.py holds the JAX package to.

- greedy: (best leaf, accept length, next-token argmax) exactly;
- stochastic: draws from a lane stream (`Draws`) cannot match the
  reference's,
  so the LAW must: the total variation distance between the two empirical
  accept-length distributions over the fixture's trial count stays under
  0.08 (two samples of 2000 from one law over a handful of bins stay well
  under 0.06) and the means agree as in the JAX test;
- speculative sampling is lossless, so the first token a round commits
  (the accepted depth-1 token, or the token drawn from `sample_p` when
  nothing is accepted) follows softmax(root logits) exactly: the empirical
  marginal over 2000 rounds stays within 0.1 total variation of it (40
  tokens: the expected distance of a correct sampler is ~0.05);
- temperature -> 0 (1e-4, still the stochastic path) reduces to the greedy
  result on the greedy fixtures.
"""

import os

import numpy as np
import pytest
import torch

from flowspec_tpu_torch.config import SamplingConfig
from flowspec_tpu_torch.tree.build import finalize_tree
from flowspec_tpu_torch.tree.posterior import (
    evaluate_posterior_greedy, evaluate_posterior_stochastic,
)
from flowspec_tpu_torch.tree.sampling import Draws, lane_rng

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "posterior_ref.npz")
N_STOCH = 4          # trees s0..s3 of the fixture, checked in `fx`


@pytest.fixture(scope="module")
def fx():
    z = np.load(FIXTURE)
    assert int(z["n_stoch"]) == N_STOCH
    return z


def _tree_of(tokens, parents, node_cap=32, leaf_cap=32, depth_cap=16):
    n = len(tokens)
    pad = -np.ones(node_cap - n)
    tk = torch.from_numpy(np.concatenate([tokens, pad])).to(torch.int32)
    pr = torch.from_numpy(np.concatenate([parents, pad])).to(torch.int32)
    return finalize_tree(tk, pr, torch.zeros((node_cap,)), n, leaf_cap,
                         depth_cap)


def _pad_logits(node_logits, node_cap=32):
    out = np.zeros((node_cap, node_logits.shape[1]), np.float32)
    out[:len(node_logits)] = node_logits
    return torch.from_numpy(out)


def test_greedy_matches_reference_exactly(fx):
    for t in range(int(fx["n_greedy"])):
        tree = _tree_of(fx[f"g{t}_tokens"], fx[f"g{t}_parents"])
        res = evaluate_posterior_greedy(_pad_logits(fx[f"g{t}_logits"]), tree)
        assert int(res.accept_len) == int(fx[f"g{t}_accept"]), t
        assert int(res.best_leaf) == int(fx[f"g{t}_best"]), t
        assert int(res.sample_p.argmax()) == int(fx[f"g{t}_next_argmax"]), t


@pytest.mark.parametrize("t", range(N_STOCH))
def test_stochastic_law_matches_reference(fx, t):
    n_trials = int(fx["n_trials"])
    cfg = SamplingConfig(temperature=1.0)
    tree = _tree_of(fx[f"s{t}_tokens"], fx[f"s{t}_parents"])
    logits = _pad_logits(fx[f"s{t}_logits"])
    ref_accs = fx[f"s{t}_accepts"]
    gen = torch.Generator().manual_seed(42 + t)
    draws = Draws(lane_rng(torch.tensor([42 + t])))
    p_root = torch.softmax(logits[0], dim=-1).numpy()
    cand = tree.candidates()

    ours = np.zeros(n_trials, np.int64)
    first = np.zeros(n_trials, np.int64)
    for i in range(n_trials):
        res = evaluate_posterior_stochastic(logits, tree, cfg, draws)
        ours[i] = int(res.accept_len)
        assert abs(float(res.sample_p.sum()) - 1.0) < 1e-4
        if ours[i] > 0:
            first[i] = int(cand[int(res.best_leaf), 1])
        else:
            first[i] = int(torch.multinomial(res.sample_p, 1, generator=gen))

    max_len = int(max(ref_accs.max(), ours.max())) + 1
    h_ref = np.bincount(ref_accs, minlength=max_len) / len(ref_accs)
    h_our = np.bincount(ours, minlength=max_len) / n_trials
    tv = 0.5 * np.abs(h_ref - h_our).sum()
    assert tv < 0.08, (t, tv, h_ref, h_our)
    assert abs(ours.mean() - ref_accs.mean()) <= \
        0.02 * max(1.0, ref_accs.mean()) + 0.12, (ours.mean(),
                                                  ref_accs.mean())
    h_first = np.bincount(first, minlength=len(p_root)) / n_trials
    tv_first = 0.5 * np.abs(h_first - p_root).sum()
    assert tv_first < 0.1, (t, tv_first)


def test_stochastic_at_temperature_to_zero_is_greedy(fx):
    cfg = SamplingConfig(temperature=1e-4)
    assert not cfg.is_greedy
    draws = Draws(lane_rng(torch.tensor([0])))
    for t in range(int(fx["n_greedy"])):
        tree = _tree_of(fx[f"g{t}_tokens"], fx[f"g{t}_parents"])
        logits = _pad_logits(fx[f"g{t}_logits"])
        want = evaluate_posterior_greedy(logits, tree)
        got = evaluate_posterior_stochastic(logits, tree, cfg, draws)
        assert int(got.accept_len) == int(want.accept_len), t
        if int(want.accept_len) > 0:
            n = int(want.accept_len) + 1
            path_w = tree.retrieve[int(want.best_leaf), :n]
            path_g = tree.retrieve[int(got.best_leaf), :n]
            assert torch.equal(path_w, path_g), t
        assert int(got.sample_p.argmax()) == int(want.sample_p.argmax()), t


def test_max_trials_caps_the_sibling_tokens_tried(fx):
    """With one trial per depth only the first sibling can be accepted."""
    tree = _tree_of(fx["s0_tokens"], fx["s0_parents"])
    logits = _pad_logits(fx["s0_logits"])
    draws = Draws(lane_rng(torch.tensor([3])))
    cand = tree.candidates()
    first_sibling = int(cand[0, 1])
    for _ in range(50):
        res = evaluate_posterior_stochastic(
            logits, tree, SamplingConfig(temperature=1.0), draws,
            max_trials=1)
        if int(res.accept_len) > 0:
            assert int(cand[int(res.best_leaf), 1]) == first_sibling
