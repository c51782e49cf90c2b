"""The port's continuous batching (`BatchedSpecEngine.serve`) against the
JAX package's, on the CPU in f32.

Token for token with equal statistics (rounds, per_request, latency_rounds,
admit_rounds, slot_utilization, resumed_turns) on the tiny f32 setup of
tests/test_batched.py: fifo / sjf / lpt admission, EOS and refill, a long
prompt consumed by several chain rounds beside decoding lanes, per-request
budgets over several dispatches, force_accept, a shared prefix (explicit
and "auto"), on_token order, multi-turn conversations with the
ConversationStore and `warmup`. Stochastic serving is held to its law: the
first token's distribution against the base model's softmax.
"""

import numpy as np
import pytest
import torch

from flowspec_tpu_torch.runtime import BatchedSpecEngine, ConversationStore
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
def duo():
    return setup_pair(2)


def _both(pair, prompts, **kw):
    jeng, port = pair
    want, wstats = jeng.serve(prompts, **kw)
    got, gstats = port.serve(prompts, **kw)
    assert got == _ints(want)
    assert gstats == wstats
    return got, gstats


def _prompts(seed, n, lo=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 14, lo + i).tolist() for i in range(n)]


@pytest.mark.parametrize("policy", ["fifo", "sjf", "lpt"])
def test_serve_queue_orders_match_jax(duo, policy):
    """Five requests over two lanes with different budgets: refills on the
    device, the admission order of the policy, the JAX package's tokens
    and statistics; every stream equals its solo AR stream."""
    prompts = _prompts(23, 5)
    budgets = [5, 2, 8, 3, 6]
    got, stats = _both(duo, prompts, max_new_tokens=budgets,
                       eos_token_id=-1, queue_order=policy)
    assert stats["per_request"] == budgets
    if policy == "fifo":
        port = duo[1]
        for p, m, o in zip(prompts, budgets, got):
            assert o == port.generate_ar(p, max_new_tokens=m,
                                         eos_token_id=-1)[0]


def test_serve_eos_and_refill_match_jax(duo):
    """The first request meets its EOS early, its lane is refilled from
    the queue on the device and the third request runs there."""
    port = duo[1]
    prompts = _prompts(2, 3, lo=7)
    ar0 = port.generate_ar(prompts[0], max_new_tokens=20, eos_token_id=-1)[0]
    eos = ar0[len(prompts[0]) + 3]
    got, stats = _both(duo, prompts, max_new_tokens=20, eos_token_id=eos)
    gen0 = got[0][len(prompts[0]):]
    assert gen0.index(eos) == len(gen0) - 1 and len(got[2]) > len(prompts[2])
    assert stats["admit_rounds"][2] > 0


def test_serve_long_prompt_token_level_refill_matches_jax(duo):
    """A refilled request with a 45-token prompt (several chain rounds at
    depth_cap 4) prefills while the other lane keeps decoding."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 14, n).tolist() for n in (8, 9, 45, 7)]
    _, stats = _both(duo, prompts, max_new_tokens=10, eos_token_id=-1)
    assert stats["per_request"] == [10] * 4


def test_serve_budgets_over_several_dispatches_match_jax(duo):
    """rounds_per_dispatch 2: lane requests, emitted counts, budgets and
    the queue head carry across many dispatches."""
    prompts = _prompts(17, 5)
    _, stats = _both(duo, prompts, max_new_tokens=[4, 9, 6, 3, 7],
                     eos_token_id=-1, rounds_per_dispatch=2)
    assert stats["per_request"] == [4, 9, 6, 3, 7]
    assert all(lr >= 1 for lr in stats["latency_rounds"])


def test_serve_force_accept_matches_jax(duo):
    jeng, port = duo
    import dataclasses
    pair = (type(jeng)(jeng.params, jeng.draft,
                       dataclasses.replace(jeng.cfg, force_accept=2),
                       batch_size=2),
            BatchedSpecEngine(port.params, port.draft,
                              dataclasses.replace(port.cfg, force_accept=2),
                              batch_size=2, device="cpu"))
    _, stats = _both(pair, _prompts(13, 4), max_new_tokens=7,
                     eos_token_id=-1)
    assert stats["per_request"] == [7] * 4 and stats["rounds"] <= 12


def test_serve_shared_prefix_matches_jax(duo):
    """A 17-token shared prefix prefilled once: the streams equal the
    prefix-less serve's (and JAX's, explicit and "auto") in fewer rounds,
    refills on the device included (5 requests, 2 lanes)."""
    rng = np.random.default_rng(41)
    prefix = rng.integers(3, 14, 17).tolist()
    prompts = [prefix + rng.integers(3, 14, 3 + i).tolist()
               for i in range(5)]
    plain, st0 = _both(duo, prompts, max_new_tokens=6, eos_token_id=-1)
    got, st1 = _both(duo, prompts, max_new_tokens=6, eos_token_id=-1,
                     shared_prefix=prefix)
    assert got == plain and st1["rounds"] < st0["rounds"]
    port = duo[1]
    assert port._detect_shared_prefix(prompts) == prefix
    auto, st2 = _both(duo, prompts, max_new_tokens=6, eos_token_id=-1,
                      shared_prefix="auto")
    assert auto == plain and st2["rounds"] == st1["rounds"]
    with pytest.raises(ValueError):
        port.serve([prefix], max_new_tokens=4, eos_token_id=-1,
                   shared_prefix=prefix)
    with pytest.raises(ValueError):
        port.serve([[1] + prompts[0][1:]], max_new_tokens=4,
                   eos_token_id=-1, shared_prefix=prefix)


def test_serve_on_token_streams_in_order(duo):
    port = duo[1]
    prompts = _prompts(61, 4)
    streamed = {i: [] for i in range(4)}
    got, _ = _both(duo, prompts, max_new_tokens=5, eos_token_id=-1)
    again, _ = port.serve(prompts, max_new_tokens=5, eos_token_id=-1,
                          on_token=lambda r, t: streamed[r].append(t))
    assert again == got
    for i in range(4):
        assert streamed[i] == got[i][len(prompts[i]):]


def test_serve_multiturn_conversations_match_jax(duo):
    """Turn 2 of three conversations resumes from each one's stored lane
    state (KV rolled back to the common prefix) and equals the JAX
    package's serve and the solo generate over the whole turn-2 prompt."""
    from flowspec_tpu.runtime.batched import ConversationStore as JStore
    jeng, port = duo
    rng = np.random.default_rng(11)
    t1 = [rng.integers(3, 14, 6).tolist() for _ in range(3)]
    ids = ["a", "b", "c"]
    jstore, store = JStore(), ConversationStore()
    kw = dict(max_new_tokens=5, eos_token_id=-1, rounds_per_dispatch=2,
              conversation_ids=ids)
    w1, ws1 = jeng.serve(t1, conversations=jstore, **kw)
    g1, gs1 = port.serve(t1, conversations=store, **kw)
    assert g1 == _ints(w1) and gs1 == ws1 and len(store) == 3
    extras = [rng.integers(3, 14, 4).tolist() for _ in range(3)]
    t2 = [g1[i] + extras[i] for i in range(3)]
    w2, ws2 = jeng.serve(t2, conversations=jstore, **kw)
    g2, gs2 = port.serve(t2, conversations=store, **kw)
    assert g2 == _ints(w2) and gs2 == ws2
    assert gs2["resumed_turns"] == 3
    for i in range(3):
        assert g2[i] == port.generate(t2[i], max_new_tokens=5,
                                      eos_token_id=-1)[0]


def test_conversation_store_lru_eviction():
    st = ConversationStore(max_items=2)
    st.put("a", "SA", [1, 2])
    st.put("b", "SB", [3])
    assert st.get("a")["history"] == [1, 2]
    st.put("c", "SC", [4])
    assert "b" not in st and "a" in st and "c" in st
    assert len(st) == 2 and st.get("b") is None
    assert len(st.clone()) == 2


def test_warmup_prepares_the_serve_graph_and_prefix(duo):
    """warmup(n_requests, shared_prefix) builds that prefix's template and
    names the serve graph key a call of that many requests replays (on
    the card that graph is captured then; tests/test_torch_cuda.py checks
    that a warmed serve captures nothing); serving afterwards still
    equals JAX's."""
    port = duo[1]
    rng = np.random.default_rng(53)
    prefix = rng.integers(3, 14, 9).tolist()
    prompts = [prefix + rng.integers(3, 14, 3).tolist() for _ in range(3)]
    keys = port.warmup(n_requests=len(prompts), shared_prefix=prefix)
    assert port._serve_key(len(prompts)) in keys
    assert np.asarray(prefix, np.int32).tobytes() in port._prefix_templates
    _both(duo, prompts, max_new_tokens=5, eos_token_id=-1,
          shared_prefix=prefix)


def test_serve_stochastic_first_token_distribution():
    """At temperature 1 the first token each request emits is a draw from
    the base model's next-token distribution: 600 identical prompts over
    eight lanes (host fills and device refills) match softmax(base logits)
    in total variation, and distinct queue positions draw distinct
    streams."""
    tree = dict(top_k=4, depth=3, total_tokens=12, expand_tokens=8,
                expand_depth=2, node_cap=16, leaf_cap=16, depth_cap=8,
                chunk_len=8)
    _, port = setup_pair(8, tree=tree, sampling={"temperature": 1.0},
                         adapt_tree=False)
    prompt = [5, 9, 3, 7, 4, 11]
    n = 600
    outs, _ = port.serve([prompt] * n, max_new_tokens=1, eos_token_id=-1,
                         rounds_per_dispatch=64, seed=123)
    firsts = np.array([o[len(prompt)] for o in outs])
    _, last_logits = port._prefill_chunks(port.init_state(0), prompt)
    p_ref = torch.softmax(last_logits.float(), dim=-1).numpy()
    emp = np.bincount(firsts, minlength=16) / n
    tv = 0.5 * np.abs(emp - p_ref).sum()
    assert tv < 0.15, (tv, emp.round(3).tolist(), p_ref.round(3).tolist())
    assert len(set(firsts.tolist())) > 1
