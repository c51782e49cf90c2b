"""The port's dynamic tree and batch width (`BatchedSpecEngine(dynamic_tree=,
dynamic_batch=)`) against the JAX package's, on the CPU in f32.

`dynamic_tree`: each serve dispatch drafts the `adapt_tree_for_batch`
variant of its busy-lane count over a state allocated for the full tree;
`dynamic_batch`: `serve_stream` re-widths its lanes to 1, 2 or 4 at each
bucket crossing, the busy lanes moved to the front. The tiny f32 setups of
tests/test_batched.py's scenarios (a 3-lane serve draining from 3 busy
lanes to 1; a 4-lane stream of a trickle, a burst and a straggler) through
both engines under the same fake clock: outputs token for token, the
statistics key for key (width_switches and min_width among them), every
stream equal to its solo AR stream. Also a width switch with a shared
prefix and a preemption (lanes that hold the prefix rows move with their
KV, a parked request reserves a lane), and the graph keys `warmup`
prepares: one per (width, tree variant) the engine can pick.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_batched import _ints, setup_pair
from tests.test_torch_stream import fake_clock


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are tiny: the port's ops run on one thread, leaving
    the other cores to the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dyn4():
    """4 lanes, dynamic tree and width, the configured tree kept."""
    return setup_pair(4, adapt_tree=False, dynamic_tree=True,
                      dynamic_batch=True)


def _trees_drafted(port):
    """Records the node count of each tree the port's rounds draft."""
    seen = []
    run = port._lane_round

    def record(state, serve=None, live=None, tree_cfg=None):
        seen.append((tree_cfg or port.cfg.tree).node_cap)
        return run(state, serve, live, tree_cfg)
    port._lane_round = record
    return seen


def test_serve_dynamic_tree_matches_jax():
    """Three lanes, budgets 24 / 6 / 4: the dispatches draft 48 nodes
    while two or three lanes are busy, 61 once one is (tree of 60 nodes
    and the root); tokens and statistics equal JAX's, the streams their
    solo AR streams."""
    tree = dict(top_k=6, depth=3, total_tokens=60, expand_tokens=12,
                expand_depth=2, node_cap=64, leaf_cap=64, depth_cap=10,
                chunk_len=8)
    jeng, port = setup_pair(3, tree=tree, dynamic_tree=True)
    assert port.cfg.tree.total_tokens == 60
    assert {n: tc.total_tokens for n, tc in port._tree_variants.items()} \
        == {n: tc.total_tokens for n, tc in jeng._tree_variants.items()} \
        == {1: 60, 2: 47, 3: 47}
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 14, 5).tolist() for _ in range(3)]
    budgets = [24, 6, 4]
    kw = dict(max_new_tokens=budgets, eos_token_id=-1,
              rounds_per_dispatch=2)
    want, wstats = jeng.serve(prompts, **kw)
    seen = _trees_drafted(port)
    got, gstats = port.serve(prompts, **kw)
    del port._lane_round
    assert got == _ints(want) and gstats == wstats
    assert seen[0] == 48 and seen[-1] == 61, seen
    for p, m, o in zip(prompts, budgets, got):
        assert o == port.generate_ar(p, max_new_tokens=m,
                                     eos_token_id=-1)[0]


def test_stream_dynamic_batch_width_matches_jax(dyn4):
    """One early request (width 1), a burst of four (back to 4), a late
    straggler (the drain tail): the width shrinks and grows, tokens and
    statistics equal JAX's, streams their solo AR streams."""
    jeng, port = dyn4
    rng = np.random.default_rng(29)
    prompts = [rng.integers(3, 14, 6).tolist() for _ in range(6)]
    budgets = [10, 4, 4, 4, 4, 8]
    arrivals = [0.0, 1.0, 1.05, 1.1, 1.15, 2.5]
    kw = dict(max_new_tokens=budgets, eos_token_id=-1,
              rounds_per_dispatch=2)
    want, wstats = jeng.serve_stream(prompts, arrivals, clock=fake_clock(),
                                     **kw)
    seen = _trees_drafted(port)
    got, gstats = port.serve_stream(prompts, arrivals, clock=fake_clock(),
                                    **kw)
    del port._lane_round
    assert got == _ints(want) and gstats == wstats
    assert gstats["min_width"] == 1 and gstats["width_switches"] >= 2
    assert set(seen) == {17}         # every variant: 16 nodes and the root
    for p, m, o in zip(prompts, budgets, got):
        assert o == port.generate_ar(p, max_new_tokens=m,
                                     eos_token_id=-1)[0]


def test_stream_width_switch_with_prefix_and_preemption_matches_jax(dyn4):
    """Four requests with a shared prefix fill the four lanes, a short one
    preempts a long one (the parked request counts toward the width), then
    the lanes drain 4 -> 2 (lanes 0 and 2 move with their KV) -> 1 and a
    straggler comes last; tokens and statistics equal JAX's."""
    jeng, port = dyn4
    rng = np.random.default_rng(71)
    prefix = rng.integers(3, 14, 9).tolist()
    prompts = [prefix + rng.integers(3, 14, 3).tolist() for _ in range(6)]
    budgets = [30, 12, 30, 12, 2, 6]
    arrivals = [0.0, 0.0, 0.0, 0.0, 0.4, 3.0]
    kw = dict(max_new_tokens=budgets, eos_token_id=-1,
              rounds_per_dispatch=2, shared_prefix=prefix,
              prefix_overlap=False, preempt_factor=2.0)
    want, wstats = jeng.serve_stream(prompts, arrivals, clock=fake_clock(),
                                     **kw)
    got, gstats = port.serve_stream(prompts, arrivals, clock=fake_clock(),
                                    **kw)
    assert got == _ints(want) and gstats == wstats
    assert gstats["preemptions"] == 1
    assert gstats["width_switches"] >= 2 and gstats["min_width"] == 1


def test_warmup_prepares_every_width_and_tree_variant(dyn4):
    """warmup names one serve graph per (width, tree variant) a call can
    pick: widths 1, 2, 4; at width w the variants of 1..w busy lanes (the
    tree of 16 nodes and the root at every count, with adapt_tree_for_batch
    cutting none below 32 nodes: one variant a width)."""
    port = dyn4[1]
    keys = port.warmup(n_requests=6)
    assert [(k[3], k[5].node_cap) for k in keys] == [(1, 17), (2, 17),
                                                    (4, 17)]
    assert all(k[4] == 8 for k in keys)      # queue capacity of 6
    assert port._serve_key(6, width=4) in keys


def test_warmup_keys_of_a_tree_adapt_cuts():
    """With a tree adapt_tree_for_batch cuts (60 nodes: 47 from two lanes,
    31 from four), warmup names the variants of each width."""
    tree = dict(top_k=6, depth=3, total_tokens=60, expand_tokens=12,
                expand_depth=2, node_cap=64, leaf_cap=64, depth_cap=10,
                chunk_len=8)
    _, port = setup_pair(4, tree=tree, dynamic_tree=True,
                         dynamic_batch=True)
    keys = port.warmup(n_requests=3)
    assert [(k[3], k[5].node_cap) for k in keys] == [
        (1, 61), (2, 61), (2, 48), (4, 61), (4, 48), (4, 32)]
    static = setup_pair(4, tree=tree, dynamic_tree=True)[1]
    assert [(k[3], k[5].node_cap) for k in static.warmup(n_requests=3)] \
        == [(4, 61), (4, 48), (4, 32)]
