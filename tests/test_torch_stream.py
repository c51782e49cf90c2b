"""The port's streaming-arrival serving (`BatchedSpecEngine.serve_stream`)
against the JAX package's, on the CPU in f32.

Each scenario of tests/test_batched.py's serve_stream tests runs through
both engines under the same fake clock (one that advances a fixed step a
call): the outputs must be equal token for token and the statistics equal
key for key, the latencies in seconds and their percentiles included, so
the port calls the clock where the JAX package does, as often. Arrivals
with the all-idle wait, fifo / sjf admission and the sjf starvation cap, a
shared prefix, a cold prefix built in a thread beside serving (its landing
gated to one clock tick on both sides, so both switch at the same
boundary), preemption with and without a shared prefix, its cost gate and
round robin over two lanes. Stochastic serving with preemption is held to
its law: the first token's distribution against the base model's softmax.
"""

import threading

import numpy as np
import pytest
import torch

from tests.test_torch_batched import _ints, setup_pair


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are tiny: the port's ops run on one thread, leaving
    the other cores to the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solo():
    return setup_pair(1)


@pytest.fixture(scope="module")
def duo():
    return setup_pair(2)


def fake_clock(step=0.05, at=None):
    """A clock advancing `step` a call; `at` (n, fn) calls fn at the n-th
    call, before it returns."""
    state = {"t": 0.0, "n": 0}

    def clock():
        state["t"] += step
        state["n"] += 1
        if at is not None and state["n"] == at[0]:
            at[1]()
        return state["t"]
    return clock


def _both(pair, prompts, arrivals, step=0.05, **kw):
    """serve_stream through the JAX engine and the port under equal fake
    clocks: equal outputs and equal statistics, key for key."""
    jeng, port = pair
    want, wstats = jeng.serve_stream(prompts, arrivals,
                                     clock=fake_clock(step), **kw)
    got, gstats = port.serve_stream(prompts, arrivals,
                                    clock=fake_clock(step), **kw)
    assert got == _ints(want)
    assert gstats == wstats
    return got, gstats


def _prompts(seed, n, lo=6, step=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 14, lo + step * i).tolist() for i in range(n)]


def test_stream_arrivals_match_jax(duo):
    """Two requests at once, two while the lanes are busy (refilled on the
    device), one long after (the all-idle wait, a host fill); every stream
    equals its solo AR stream."""
    prompts = _prompts(21, 5, step=1)
    got, stats = _both(duo, prompts, [0.0, 0.0, 0.3, 0.5, 30.0],
                       max_new_tokens=6, eos_token_id=-1,
                       rounds_per_dispatch=3)
    assert stats["per_request"] == [6] * 5
    assert stats["completion_p95_s"] >= stats["completion_p50_s"] > 0
    port = duo[1]
    for p, o in zip(prompts, got):
        assert o == port.generate_ar(p, max_new_tokens=6,
                                     eos_token_id=-1)[0]
    with pytest.raises(ValueError):
        port.serve_stream(prompts, [0.0] * 5, max_new_tokens=6,
                          shared_prefix="auto")


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
def test_stream_sjf_admits_the_short_pending_request_first(solo, policy):
    """One lane: under sjf the short request that arrived after the long
    one is admitted first; under fifo it waits its turn."""
    prompts = _prompts(31, 3)
    _, stats = _both(solo, prompts, [0.0, 0.1, 0.2],
                     max_new_tokens=[6, 7, 2], eos_token_id=-1,
                     rounds_per_dispatch=2, queue_order=policy)
    a = stats["admit_rounds"]
    assert (a[2] < a[1]) == (policy == "sjf"), a


@pytest.mark.parametrize("cap", [None, 1])
def test_stream_sjf_starvation_cap_matches_jax(solo, cap):
    """A long request behind a wave of later short ones: admitted last
    under pure sjf, promoted ahead of the later wave with cap 1."""
    prompts = _prompts(37, 5)
    _, stats = _both(solo, prompts, [0.0, 0.3, 0.35, 0.4, 0.45],
                     max_new_tokens=[6, 9, 2, 2, 2], eos_token_id=-1,
                     rounds_per_dispatch=1, queue_order="sjf",
                     starvation_cap=cap)
    a = stats["admit_rounds"]
    if cap is None:
        assert a[1] == max(a), a
    else:
        assert a[1] < a[3] and a[1] < a[4], a


def test_stream_shared_prefix_matches_jax(duo):
    """Host fills and device refills both start from the prefix template
    (built before serving: prefix_overlap off); the streams equal the
    prefix-less serve_stream's; on_token delivers every token in order."""
    rng = np.random.default_rng(43)
    prefix = rng.integers(3, 14, 9).tolist()
    prompts = [prefix + rng.integers(3, 14, 2 + i).tolist()
               for i in range(4)]
    kw = dict(max_new_tokens=5, eos_token_id=-1, rounds_per_dispatch=3)
    arrivals = [0.0, 0.0, 0.3, 0.5]
    plain, st0 = _both(duo, prompts, arrivals, **kw)
    streamed = {i: [] for i in range(4)}
    got, st1 = _both(duo, prompts, arrivals, shared_prefix=prefix,
                     prefix_overlap=False,
                     on_token=lambda r, t: streamed[r].append(t), **kw)
    assert got == plain and st1["rounds"] < st0["rounds"]
    # both engines fed the same callback: each token arrives twice
    for i in range(4):
        gen = got[i][len(prompts[i]):]
        assert streamed[i] == gen + gen


class GatedBuild:
    """Holds an engine's cold prefix-template build (the thread of
    prefix_overlap) until `release` runs, which then waits for the thread
    to end; so the template lands at one chosen clock call on both sides."""

    def __init__(self, eng):
        self.eng, self.build = eng, eng._prefix_template
        self.go, self.entered = threading.Event(), threading.Event()
        self.thread = None
        eng._prefix_template = self

    def __call__(self, *args):
        self.thread = threading.current_thread()
        self.entered.set()
        assert self.go.wait(60)
        return self.build(*args)

    def release(self):
        assert self.entered.wait(60)
        self.go.set()
        self.thread.join(60)
        assert not self.thread.is_alive()

    def close(self):
        del self.eng._prefix_template


@pytest.mark.parametrize("land_at", [1, 7])
def test_stream_prefix_overlap_cold_matches_jax(duo, land_at):
    """A cold prefix with prefix_overlap: the template builds in a thread
    (landing at the `land_at`-th clock call on both sides) while the first
    arrivals are served without it; host admissions switch when it lands,
    device refills once every lane holds it. The streams equal JAX's and
    the prefix-less serve's, and the template is cached afterwards."""
    rng = np.random.default_rng(13 + land_at)
    prefix = rng.integers(3, 14, 12).tolist()
    prompts = [prefix + rng.integers(3, 14, 3).tolist() for _ in range(4)]
    arrivals = [0.0, 0.05, 0.3, 0.5]
    kw = dict(max_new_tokens=4, eos_token_id=-1, rounds_per_dispatch=1)
    plain, _ = _both(duo, prompts, arrivals, step=0.02, **kw)
    runs = []
    for eng in duo:
        assert np.asarray(prefix, np.int32).tobytes() \
            not in eng._prefix_templates
        gate = GatedBuild(eng)
        try:
            runs.append(eng.serve_stream(
                prompts, arrivals, clock=fake_clock(0.02, (land_at,
                                                           gate.release)),
                shared_prefix=prefix, prefix_overlap=True, **kw))
        finally:
            gate.close()
        assert np.asarray(prefix, np.int32).tobytes() \
            in eng._prefix_templates
    (want, wstats), (got, gstats) = runs
    assert got == _ints(want) == plain
    assert gstats == wstats


@pytest.mark.parametrize("factor", [None, 2.0])
def test_stream_preemption_matches_jax(solo, factor):
    """One lane: a short arrival pauses the long request (its lane state
    lifted off whole), finishes first, and the long one resumes; without
    preemption the short one finishes last."""
    prompts = _prompts(47, 2)
    _, stats = _both(solo, prompts, [0.0, 0.3], max_new_tokens=[20, 2],
                     eos_token_id=-1, rounds_per_dispatch=1,
                     preempt_factor=factor)
    assert stats["preemptions"] == (0 if factor is None else 1)
    cs = stats["completion_s"]
    assert (cs[1] < cs[0]) == (factor is not None), cs


def test_stream_preemption_with_shared_prefix_matches_jax(solo):
    rng = np.random.default_rng(59)
    prefix = rng.integers(3, 14, 9).tolist()
    prompts = [prefix + rng.integers(3, 14, 3).tolist() for _ in range(2)]
    got, stats = _both(solo, prompts, [0.0, 0.3], max_new_tokens=[18, 2],
                       eos_token_id=-1, rounds_per_dispatch=1,
                       shared_prefix=prefix, prefix_overlap=False,
                       preempt_factor=2.0)
    assert stats["preemptions"] == 1
    assert stats["completion_s"][1] < stats["completion_s"][0]
    port = solo[1]
    for p, o, m in zip(prompts, got, [18, 2]):
        assert o == port.generate_ar(p, max_new_tokens=m,
                                     eos_token_id=-1)[0]


def test_stream_preemption_cost_gate_matches_jax(solo):
    """The long request is nearly done when the short one arrives: the
    trigger fires, the cost model refuses, a skip is counted."""
    _, stats = _both(solo, _prompts(47, 2), [0.0, 0.1],
                     max_new_tokens=[4, 2], eos_token_id=-1,
                     rounds_per_dispatch=1, preempt_factor=2.0)
    assert stats["preemptions"] == 0 and stats["preempt_cost_skips"] >= 1


def test_stream_preemption_round_robin_matches_jax(duo):
    """Two shorts preempt two longs in turn over two lanes; the freed lane
    is kept for the parked request (the device queue is capped while one
    is parked); the shorts finish before the longs."""
    _, stats = _both(duo, _prompts(23, 4), [0.0, 0.0, 0.3, 0.35],
                     max_new_tokens=[40, 40, 2, 2], eos_token_id=-1,
                     rounds_per_dispatch=1, preempt_factor=2.0)
    assert stats["preemptions"] >= 2
    cs = stats["completion_s"]
    assert max(cs[2:]) < min(cs[:2]), cs


def test_stream_stochastic_preemption_first_token_distribution():
    """At temperature 1, with preemption pausing and resuming lanes, the
    first token each request emits is a draw from the base model's
    next-token distribution (TV < 0.15 over 240 requests on four lanes:
    waves of four long requests, each followed by four short ones, one of
    which preempts a long one), and distinct queue positions draw distinct
    streams."""
    tree = dict(top_k=4, depth=3, total_tokens=12, expand_tokens=8,
                expand_depth=2, node_cap=16, leaf_cap=16, depth_cap=8,
                chunk_len=8)
    _, port = setup_pair(4, tree=tree, sampling={"temperature": 1.0},
                         adapt_tree=False)
    prompt = [5, 9, 3, 7, 4, 11]
    waves = 30
    budgets = ([6] * 4 + [1] * 4) * waves
    arrivals = [0.2 * w + 0.05 * (i >= 4) for w in range(waves)
                for i in range(8)]
    n = len(budgets)
    outs, stats = port.serve_stream(
        [prompt] * n, arrivals, max_new_tokens=budgets, eos_token_id=-1,
        rounds_per_dispatch=2, seed=123, clock=fake_clock(0.01),
        preempt_factor=2.0)
    assert stats["preemptions"] >= waves // 2, stats
    assert stats["per_request"] == budgets
    firsts = np.array([o[len(prompt)] for o in outs])
    _, last_logits = port._prefill_chunks(port.init_state(0), prompt)
    p_ref = torch.softmax(last_logits.float(), dim=-1).numpy()
    emp = np.bincount(firsts, minlength=16) / n
    tv = 0.5 * np.abs(emp - p_ref).sum()
    assert tv < 0.15, (tv, emp.round(3).tolist(), p_ref.round(3).tolist())
    assert len(set(firsts.tolist())) > 1
