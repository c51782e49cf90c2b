"""The port's lane axis and its batched engine against the JAX package's.

The JAX package batches by `jax.vmap` of its one-request round; the port
runs one round over a leading lane axis. On the CPU in f32 the lane units
(the plain attention with lanes, lane `compact`, lane `tree_bias`) must
equal per-lane calls and the JAX functions, a B-lane round must equal B
one-lane rounds token for token, and the port's `BatchedSpecEngine`
(`generate_batch`, `generate_batch_fused` with KV buckets) must equal the
JAX engine's token for token with equal statistics, on the tiny f32 setup
of tests/test_batched.py. Serving (`serve`) is in tests/test_torch_serve.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowspec_tpu.config import (
    EngineConfig as JEngineConfig, ModelConfig as JModelConfig,
    SamplingConfig as JSamplingConfig, TreeConfig as JTreeConfig,
)
from flowspec_tpu.draft.eagle import init_eagle_params
from flowspec_tpu.models import bias as jbias
from flowspec_tpu.models.kv_cache import KVCache as JKVCache
from flowspec_tpu.models.llama import attention as j_attention
from flowspec_tpu.models.llama import init_llama_params
from flowspec_tpu.runtime.batched import BatchedSpecEngine as JBatched
from flowspec_tpu_torch import config as tcfg
from flowspec_tpu_torch.models import bias as tbias
from flowspec_tpu_torch.models.kv_cache import KVCache, stack_lanes
from flowspec_tpu_torch.ops.tree_attention import (
    attention_plan, tree_attention, tree_attention_plain,
)
from flowspec_tpu_torch.runtime import BatchedSpecEngine
from flowspec_tpu_torch.tree import sampling as tsampling
from tests.torch_bridge_util import port_eagle, port_llama

TREE = dict(top_k=6, depth=3, total_tokens=16, expand_tokens=12,
            expand_depth=2, node_cap=32, leaf_cap=32, depth_cap=10,
            chunk_len=8)


def _ints(outs):
    return [[int(t) for t in o] for o in outs]


def setup_pair(batch_size, tree=TREE, sampling=None, adapt_tree=True,
               dynamic_tree=False, dynamic_batch=False, max_seq_len=128,
               **engine_kw):
    """(JAX engine, port engine) of tests/test_batched.py's tiny f32 setup
    (vocab 16, two layers), the port's weights bridged from the JAX ones."""
    mc = dataclasses.replace(JModelConfig.tiny(vocab_size=16, n_layers=2),
                             dtype="float32")
    sampling = sampling or {}
    jcfg = JEngineConfig(model=mc, tree=JTreeConfig(**tree),
                         sampling=JSamplingConfig(**sampling),
                         max_seq_len=max_seq_len, prefill_chunk=16,
                         **engine_kw)
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(**dataclasses.asdict(mc)),
        tree=tcfg.TreeConfig(**tree),
        sampling=tcfg.SamplingConfig(**sampling), max_seq_len=max_seq_len,
        prefill_chunk=16, **engine_kw)
    p = init_llama_params(jax.random.key(0), mc, dtype=jnp.float32)
    d = init_eagle_params(jax.random.key(9), mc, embed=p.embed,
                          dtype=jnp.float32)
    flags = dict(batch_size=batch_size, adapt_tree=adapt_tree,
                 dynamic_tree=dynamic_tree, dynamic_batch=dynamic_batch)
    return (JBatched(p, d, jcfg, **flags),
            BatchedSpecEngine(port_llama(p), port_eagle(d), cfg,
                              device="cpu", **flags))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tensors are tiny: the port's ops run on one thread, leaving
    the other cores to the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trio():
    return setup_pair(3)


@pytest.fixture(scope="module")
def bucketed(trio):
    """The trio's weights with KV buckets (16, 32): (JAX engine, port
    engine), shared by the bucket tests so JAX compiles their programs
    once."""
    jeng, port = trio
    return (JBatched(jeng.params, jeng.draft,
                     dataclasses.replace(jeng.cfg, kv_buckets=(16, 32)),
                     batch_size=3),
            BatchedSpecEngine(port.params, port.draft,
                              dataclasses.replace(port.cfg,
                                                  kv_buckets=(16, 32)),
                              batch_size=3, device="cpu"))


# ---- lane units ------------------------------------------------------------

def _lane_case(seed, b, nq, nkv, t, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, t, d)).astype(np.float32)
    k = rng.standard_normal((b, nkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s, d)).astype(np.float32)
    n_valid = np.array([40 + 97 * i for i in range(b)], np.int32)
    tree = rng.random((b, t, t)) < 0.5
    bias = np.full((b, t, s), -1e9, np.float32)
    for i in range(b):
        ctx = n_valid[i] - t
        bias[i, :, :ctx] = 0.0
        bias[i, :, ctx:ctx + t] = np.where(tree[i] | np.eye(t, dtype=bool),
                                           0.0, -1e9)
    return q, k, v, bias, n_valid


@pytest.mark.parametrize("nq,nkv", [(4, 4), (8, 2)])
def test_tree_attention_lanes_equal_per_lane_calls_and_jax(nq, nkv):
    """One lane call (per-lane biases and live rows) equals B one-lane
    calls bit for bit, and the JAX package's dense `attention` lane by
    lane within f32 rounding."""
    b, t, s, d = 3, 9, 512, 64
    q, k, v, bias, n_valid = _lane_case(nq + nkv, b, nq, nkv, t, s, d)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    nv = torch.from_numpy(n_valid)
    got = tree_attention(tq, tk, tv, tb, nv)
    assert got.shape == (b, nq, t, d)
    for i in range(b):
        one = tree_attention_plain(tq[i:i + 1], tk[i:i + 1], tv[i:i + 1],
                                   tb[i], int(n_valid[i]))
        assert torch.equal(got[i:i + 1], one), i
        want = np.asarray(j_attention(
            jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1]),
            jnp.asarray(v[i:i + 1]), jnp.asarray(bias[i]), nq // nkv))
        np.testing.assert_allclose(got[i:i + 1].numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_attention_plan_counts_lanes_against_the_wave():
    """One lane plans as before; B lanes multiply the blocks, and a grid
    past the wave takes wider tiles."""
    one = attention_plan(32, 1, 32, 512)
    assert attention_plan(32, 1, 32, 512, lanes=1) == one
    four = attention_plan(32, 1, 32, 512, lanes=4)
    assert four.blocks == 4 * 32 * four.row_tiles * four.splits
    assert (four.warps, four.splits) == (2, 8)
    wide = attention_plan(32, 1, 81, 512, lanes=4)
    assert wide.warps == 6 and wide.blocks == 4 * 32 * 1 * 8
    with pytest.raises(ValueError):
        attention_plan(32, 1, 32, 512, lanes=0)


def test_lane_compact_equals_per_lane_and_jax():
    """Lane compaction (per-lane sources, counts and starts) equals each
    lane compacted alone and the JAX cache's compact, and a dead lane's
    rows below its length stay as they were."""
    rng = np.random.default_rng(3)
    layers, b, h, s, d, p = 2, 3, 2, 64, 8, 5
    k = rng.standard_normal((layers, b, h, s, d)).astype(np.float32)
    v = rng.standard_normal((layers, b, h, s, d)).astype(np.float32)
    dst = np.array([7, 20, 61], np.int32)       # lane 2 clamps at S - p
    n_src = np.array([3, 5, 1], np.int32)
    src = np.stack([dst[i] + rng.permutation(p) for i in range(b)])
    lane = KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                   length=torch.from_numpy(dst))
    got = lane.compact(torch.from_numpy(src), torch.from_numpy(n_src),
                       torch.from_numpy(dst))
    assert got.length.tolist() == (dst + n_src).tolist()
    for i in range(b):
        one = KVCache(k=torch.from_numpy(k[:, i:i + 1].copy()),
                      v=torch.from_numpy(v[:, i:i + 1].copy()),
                      length=torch.tensor(int(dst[i]), dtype=torch.int32))
        one = one.compact(torch.from_numpy(src[i]), int(n_src[i]),
                          int(dst[i]))
        assert torch.equal(got.k[:, i:i + 1], one.k)
        jc = JKVCache(k=jnp.asarray(k[:, i:i + 1]),
                      v=jnp.asarray(v[:, i:i + 1]),
                      length=jnp.asarray(dst[i])).compact(
            jnp.asarray(src[i]), jnp.asarray(n_src[i]), jnp.asarray(dst[i]))
        np.testing.assert_array_equal(got.v[:, i:i + 1].numpy(),
                                      np.asarray(jc.v))
    # lane 1 dead: its rows stay, its write lands on row S - 1 only
    lane = KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                   length=torch.from_numpy(dst))
    live = torch.tensor([True, False, True])
    got = lane.compact(torch.from_numpy(src), torch.from_numpy(n_src),
                       torch.from_numpy(dst), live)
    assert got.length.tolist() == [10, 20, 62]
    assert torch.equal(got.k[:, 1, :, :s - 1],
                       torch.from_numpy(k[:, 1, :, :s - 1]))


def test_lane_tree_bias_and_prefill_bias_equal_per_lane_and_jax():
    rng = np.random.default_rng(5)
    b, t, n, s = 3, 6, 8, 64
    rows = np.where(rng.random((b, t, n)) < 0.5, 0.0, -1e9).astype(np.float32)
    base = np.array([0, 17, 60], np.int32)
    got = tbias.tree_bias(torch.from_numpy(rows), torch.from_numpy(base), s)
    pre = tbias.prefill_bias(torch.from_numpy(base), t, s)
    for i in range(b):
        assert torch.equal(got[i], tbias.tree_bias(
            torch.from_numpy(rows[i]), int(base[i]), s))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(
            jbias.tree_bias(jnp.asarray(rows[i]), jnp.asarray(base[i]),
                            jnp.asarray(0), s)))
        np.testing.assert_array_equal(pre[i].numpy(), np.asarray(
            jbias.prefill_bias(jnp.asarray(base[i]), t, s)))


def _prefilled(port, prompts, seed=0):
    return [port._prefill_one(p, seed + i) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("hash_value", [0, 0xFFFFFFFF])
def test_lane_uniforms_stay_strictly_inside_0_1(monkeypatch, hash_value):
    """At either extreme of the lane hash a uniform stays inside (0, 1) in
    float32, so an Exp(1) draw, -log(u), is never 0 (nor infinite)."""
    monkeypatch.setattr(tsampling, "_mix32",
                        lambda x: torch.full_like(x, hash_value))
    draws = tsampling.Draws(tsampling.lane_rng(torch.tensor([7, 8])))
    u = draws.uniform((2, 5), "cpu")
    assert u.dtype == torch.float32
    assert bool((u > 0).all()) and bool((u < 1).all()), u
    e = draws.exponential((2, 5), "cpu")
    assert bool((e > 0).all()) and bool(torch.isfinite(e).all()), e


@pytest.mark.parametrize("forced", [False, True])
def test_sample_token_stays_in_the_top_k_set(monkeypatch, forced):
    """A token that top-k filtered out (p 0) is never drawn: with the lane
    hash forced to its largest value (every draw at its least Exp(1)
    value), and over free draws of many lanes."""
    if forced:
        monkeypatch.setattr(tsampling, "_mix32",
                            lambda x: torch.full_like(x, 0xFFFFFFFF))
    rng = np.random.default_rng(11)
    b, v, k = 64, 40, 3
    logits = torch.from_numpy(rng.standard_normal((b, v)).astype(np.float32))
    cfg = tcfg.SamplingConfig(temperature=1.0, top_k=k)
    top = torch.topk(logits, k, dim=-1).indices
    draws = tsampling.Draws(tsampling.lane_rng(torch.arange(b)))
    for _ in range(8):
        tok = tsampling.sample_token(draws, logits, cfg, is_probs=False)
        assert bool((top == tok[:, None].long()).any(dim=-1).all()), tok


def test_lane_round_equals_one_lane_rounds(trio):
    """A B-lane round on stacked prefilled states gives, lane by lane, the
    tokens, lengths and pending pairs of one-lane rounds of the same
    states (hiddens within f32 summation-order rounding), three rounds in a
    row; and a dead lane keeps its state and valid KV rows exactly."""
    _, port = trio
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 14, 8 + 5 * i).tolist() for i in range(3)]
    lanes = port._stack_states(_prefilled(port, prompts), [0, 1, 2])
    solos = _prefilled(port, prompts)
    for _ in range(3):
        lanes, acc, n_acc = port._lane_round(lanes)
        for i in range(3):
            solos[i], a1, n1 = port._lane_round(solos[i])
            assert acc[i].tolist() == a1[0].tolist()
            assert int(n_acc[i]) == int(n1[0])
            assert int(lanes.commit_len[i]) == int(solos[i].commit_len[0])
            assert lanes.pending_tokens[i].tolist() == \
                solos[i].pending_tokens[0].tolist()
            torch.testing.assert_close(lanes.pending_hidden[i],
                                       solos[i].pending_hidden[0],
                                       rtol=1e-5, atol=1e-5)
            n = int(lanes.commit_len[i])
            torch.testing.assert_close(
                lanes.base_cache.k[:, i, :, :n],
                solos[i].base_cache.k[:, 0, :, :n], rtol=1e-5, atol=1e-5)
    # lane 1 dead for a round: its state and valid rows do not move
    before = port._read_slot(lanes, 1)
    live = torch.tensor([True, False, True])
    after, _, n_acc = port._lane_round(lanes, live=live)
    n = int(before.commit_len[0])
    for f in ("commit_len", "root_token", "pending_tokens", "pending_hidden",
              "n_pending", "root_hidden", "rng"):
        assert torch.equal(getattr(after, f)[1:2], getattr(before, f)), f
    assert torch.equal(after.base_cache.k[:, 1, :, :n],
                       before.base_cache.k[:, 0, :, :n])
    assert torch.equal(after.draft_cache.v[:, 1, :, :n],
                       before.draft_cache.v[:, 0, :, :n])
    assert int(after.base_cache.length[1]) == n


def test_one_request_state_is_one_lane_and_slots_round_trip(trio):
    """A one-request state is one lane ((1,) lengths, (1, 2) draw stream);
    `stack_lanes` / `_read_slot` copy, and `_write_slot` puts a read lane
    back bit for bit."""
    _, port = trio
    st = port._prefill_one([3, 4, 5, 6], 0)
    assert st.commit_len.shape == (1,) and st.pending_tokens.dim() == 2
    assert st.base_cache.length.shape == (1,) and st.rng.shape == (1, 2)
    two = stack_lanes([st.base_cache, st.base_cache])
    assert two.k.shape[1] == 2 and two.length.tolist() == [4, 4]
    assert two.k.data_ptr() != st.base_cache.k.data_ptr()
    lanes = port._stack_states([st, port._prefill_one([5, 6, 7], 1)],
                               [0, 1])
    one = port._read_slot(lanes, 1)
    assert one.base_cache.k.data_ptr() != lanes.base_cache.k.data_ptr()
    port._write_slot(lanes, one, 0)
    for f in ("commit_len", "root_token", "pending_tokens", "pending_hidden",
              "n_pending", "root_hidden", "rng"):
        assert torch.equal(getattr(lanes, f)[0], getattr(lanes, f)[1]), f
    assert torch.equal(lanes.base_cache.k[:, 0], lanes.base_cache.k[:, 1])
    assert lanes.draft_cache.length[0] == lanes.draft_cache.length[1]


# ---- the engines against the JAX package's ----------------------------------

def test_generate_batch_matches_jax(trio):
    jeng, port = trio
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 14, 8 + 2 * i).tolist() for i in range(3)]
    want, wstats = jeng.generate_batch(prompts, max_new_tokens=15,
                                       eos_token_id=-1)
    got, gstats = port.generate_batch(prompts, max_new_tokens=15,
                                      eos_token_id=-1)
    assert got == _ints(want)
    assert gstats == wstats
    # lossless: every lane equals its solo AR stream
    for p, o in zip(prompts, got):
        assert o == port.generate_ar(p, max_new_tokens=15,
                                     eos_token_id=-1)[0]


def test_generate_batch_with_eos_matches_jax(trio):
    """A lane that meets its EOS early stops counting while the others go
    on; tokens and statistics equal the JAX engine's."""
    jeng, port = trio
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 14, 7 + i).tolist() for i in range(3)]
    ref = port.generate_ar(prompts[1], max_new_tokens=12, eos_token_id=-1)[0]
    eos = ref[len(prompts[1]) + 2]
    want, wstats = jeng.generate_batch(prompts, max_new_tokens=12,
                                       eos_token_id=eos)
    got, gstats = port.generate_batch(prompts, max_new_tokens=12,
                                      eos_token_id=eos)
    assert got == _ints(want) and gstats == wstats


@pytest.mark.parametrize("eos_lane", [None, 1])
def test_generate_batch_fused_with_kv_buckets_matches_jax(trio, bucketed,
                                                         eos_lane):
    """Bucketed fused batch decoding: all lanes' caches grow together
    through two buckets or more, tokens and statistics equal JAX's; with
    an EOS in one lane that lane finishes early and its stream stays exact
    while the others go on."""
    port = trio[1]
    jb, pb = bucketed
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 14, 6 + 2 * i).tolist() for i in range(3)]
    eos = -1
    if eos_lane is not None:
        ref = port.generate_ar(prompts[eos_lane], max_new_tokens=20,
                               eos_token_id=-1)[0]
        eos = ref[len(prompts[eos_lane]) + 3]
    want, wstats = jb.generate_batch_fused(prompts, max_new_tokens=20,
                                           eos_token_id=eos)
    got, gstats = pb.generate_batch_fused(prompts, max_new_tokens=20,
                                          eos_token_id=eos)
    assert got == _ints(want)
    assert gstats == wstats
    assert gstats["kv_buckets_used"] >= 2
    eager, _ = pb.generate_batch(prompts, max_new_tokens=20,
                                 eos_token_id=eos)
    assert eager == got


def test_generate_batch_fused_force_accept_matches_jax(trio):
    """The force_accept bench mode through the gated lane loop."""
    jeng, port = trio
    jf = JBatched(jeng.params, jeng.draft,
                  dataclasses.replace(jeng.cfg, force_accept=2),
                  batch_size=3)
    pf = BatchedSpecEngine(port.params, port.draft,
                           dataclasses.replace(port.cfg, force_accept=2),
                           batch_size=3, device="cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(3, 14, 6 + i).tolist() for i in range(3)]
    want, wstats = jf.generate_batch_fused(prompts, max_new_tokens=9,
                                           eos_token_id=-1)
    got, gstats = pf.generate_batch_fused(prompts, max_new_tokens=9,
                                          eos_token_id=-1)
    assert got == _ints(want) and gstats == wstats
    assert gstats["rounds"] <= 4


def test_batched_engine_defaults_to_cuda_and_refuses_dynamic(trio):
    """The engine resolves to the card unless told otherwise; with
    dynamic_tree it allocates the full tree and keys a variant on each
    busy-lane count, as JAX's does: from chip_smoke.py's tree (80 nodes
    and the root, node_cap 96) 81, 48, 48 and 32 nodes for 1-4 lanes."""
    _, port = trio
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            BatchedSpecEngine(port.params, port.draft, port.cfg)
    cfg = dataclasses.replace(port.cfg, max_seq_len=216, tree=tcfg.TreeConfig(
        top_k=10, depth=8, total_tokens=80, node_cap=96, leaf_cap=96,
        depth_cap=16, score_temperature=0.2))
    eng = BatchedSpecEngine(port.params, port.draft, cfg, batch_size=4,
                            dynamic_tree=True, dynamic_batch=True,
                            device="cpu")
    assert eng.cfg.tree.node_cap == 81 and eng.cfg.tree.total_tokens == 80
    assert {n: tc.node_cap for n, tc in eng._tree_variants.items()} == \
        {1: 81, 2: 48, 3: 48, 4: 32}
    for n, tc in eng._tree_variants.items():
        assert tc.total_tokens + 1 == tc.node_cap == tc.leaf_cap
        assert tc.depth_cap == eng.cfg.tree.depth_cap == 9
        assert eng._serve_tree(n) is tc
    assert eng.base_kv_len == 512      # rows for the full tree's chunk
    assert [eng._serve_width(n) for n in range(1, 5)] == [1, 2, 4, 4]
    static = BatchedSpecEngine(port.params, port.draft, cfg, batch_size=4,
                               device="cpu")
    assert static.cfg.tree.node_cap == 32 and static._tree_variants == {}


def test_generate_batch_stochastic_lanes_draw_their_own_streams():
    """At temperature 1 each lane's draws come from its own stream: lanes
    of one prompt seeded apart do not all emit the same tokens, and a lane
    emits the same stream whatever its neighbours are."""
    _, port = setup_pair(3, sampling={"temperature": 1.0})
    prompt = [5, 9, 3, 7, 4, 11]
    outs, stats = port.generate_batch([prompt] * 3, max_new_tokens=12,
                                      eos_token_id=-1, seed=7)
    assert stats["per_request"] == [12] * 3
    assert all(0 <= t < 16 for o in outs for t in o)
    assert len({tuple(o) for o in outs}) > 1
    again, _ = port.generate_batch([prompt, [3, 3, 4, 5, 6, 7, 8], prompt],
                                   max_new_tokens=12, eos_token_id=-1, seed=7)
    assert again[0] == outs[0] and again[2] == outs[2]


def test_bridged_jax_lane_state_round_matches_jax_vmapped_round(trio):
    """A JAX lane-stacked state (three prefilled requests), bridged into the
    port's layout, runs one port lane round with the tokens, lengths and
    pending pairs of the JAX package's vmapped round; and the bridge gives
    the JAX layout back unchanged."""
    from flowspec_tpu_torch import bridge
    from tests.torch_bridge_util import to_numpy_dict
    jeng, port = trio
    rng = np.random.default_rng(21)
    prompts = [rng.integers(3, 14, 7 + 3 * i).tolist() for i in range(3)]
    jst = jeng._stack_states([jeng._prefill_one(p, i)
                              for i, p in enumerate(prompts)])
    d = to_numpy_dict(dataclasses.replace(jst, key=None))
    lanes = bridge.lane_state(d, device="cpu")
    back = bridge.lane_state_numpy(lanes)
    np.testing.assert_array_equal(back["base_cache"]["k"],
                                  d["base_cache"]["k"])
    np.testing.assert_array_equal(back["pending_hidden"], d["pending_hidden"])
    jst2, jres = jeng._vround(jst, jeng.params, jeng.draft, jeng.beam_head)
    lanes2, acc, n_acc = port._lane_round(lanes)
    assert acc.tolist() == np.asarray(jres.accepted).tolist()
    assert n_acc.tolist() == np.asarray(jres.n_accepted).tolist()
    assert lanes2.commit_len.tolist() == np.asarray(jst2.commit_len).tolist()
    assert lanes2.pending_tokens.tolist() == \
        np.asarray(jst2.pending_tokens).tolist()
    np.testing.assert_allclose(
        bridge.lane_state_numpy(lanes2)["pending_hidden"],
        np.asarray(jst2.pending_hidden), rtol=1e-5, atol=1e-5)
